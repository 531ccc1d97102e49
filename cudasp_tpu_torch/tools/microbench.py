"""Micro-benchmark of the field and curve primitives on the GPU: the port
of the JAX package's tools/microbench.py, through bench_kernel
(csrc/probe.cu), whose field and curve bodies are the scan kernel's own
functions (csrc/secp256k1.cuh).

Prints ns per op over all lanes of a launch, and the rate in elements a
second (int32 values for the raw cases, 8 a lane; field or curve ops for
the others): the field mul line is the card's field-product rate. Each
case is timed by the slope between `n` and 3n repeats, (t3 - t1) / 2n,
with CUDA events around each launch (best of 5); the line prints both
raw times.

The default width is the scan's launch width, 262,144 lanes
(api.TILE_CUDA): the JAX tool's 256 lanes make 2 blocks of 128 threads,
2 of the H100's 132 SMs. --iters defaults to 2,000 (the JAX tool's 200
gives slopes well under a ms here), with the JAX tool's per-case
multiples, except field add, which takes 20 x iters like the raw cases,
for the same reason.

    python -m cudasp_tpu_torch.tools.microbench [--bt 262144]
        [--iters 2000] [--device cuda|cpu] [--seed 0]

--device cpu runs the plain version (ops/probes.py bench_plain) and
times it with the host clock; the default, cuda, raises without a GPU.
"""

import argparse
import sys

import numpy as np

from ..api import TILE_CUDA
from ..ops import probes as P

REPS = 5


def run_case(case, x, y, iters):
    name, raw, ops_per_iter = P.BENCH_CASES[case]
    bt = x.shape[1]
    t1 = P.best_ms(lambda: P.bench(x, y, case, iters), x.device, REPS)
    t3 = P.best_ms(lambda: P.bench(x, y, case, 3 * iters), x.device, REPS)
    ns_per_op = (t3 - t1) * 1e6 / (2 * iters * ops_per_iter)
    elems = 8 * bt if raw else bt
    rate = elems / ns_per_op * 1e9 if ns_per_op > 0 else float("nan")
    print(f"{name:24s} {t1:8.3f}/{t3:8.3f} ms  {ns_per_op:9.1f} ns/op  "
          f"{rate / 1e9:9.2f} G/s  ({bt} lanes, {iters} iters)", flush=True)
    return {"t1_ms": t1, "t3_ms": t3, "iters": iters, "ns_per_op": ns_per_op,
            "per_s": rate}


def case_iters(iters):
    """Repeats of each case, in BENCH_CASES order (the JAX tool's)."""
    return ([iters * 5] * 4 + [iters * 20] * 2 + [iters * 20, iters, iters,
            max(iters // 4, 8), max(iters // 8, 8), max(iters // 100, 2)])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bt", type=int, default=TILE_CUDA)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = P.resolve_device(args.device)
    print(f"# device: {P.device_name(dev)}", flush=True)
    rng = np.random.default_rng(args.seed)
    raw = [P.to_device(P.raw_planes(rng, (8, args.bt)), dev)
           for _ in range(2)]
    fld = [P.to_device(P.field_planes(rng, args.bt), dev) for _ in range(2)]
    out = {}
    for case, n in enumerate(case_iters(args.iters)):
        x, y = raw if P.BENCH_CASES[case][1] else fld
        out[P.BENCH_NAMES[case]] = run_case(case, x, y, n)
    return out


if __name__ == "__main__":
    main()
