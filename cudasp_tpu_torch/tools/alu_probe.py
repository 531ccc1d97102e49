"""Measure int32 multiply vs add throughput (and the f32 fma) on the GPU:
the port of the JAX package's tools/alu_probe.py, through alu_kernel
(csrc/probe.cu).

8 independent streams a lane expose throughput, not latency; the mask
keeps values bounded and defeats constant folding. Each op is timed by the
slope between `iters` and 3 x `iters` repeats, (t3 - t1) / 2 iters, with
CUDA events around each launch (best of 5), which cancels the
launch's fixed cost. The line prints both raw times.

The default width is the scan's launch width, 262,144 lanes
(api.TILE_CUDA, as 8 rows of 32,768): the JAX tool's 8 x 512 lanes make
32 blocks of 128 threads, 32 of the H100's 132 SMs. --iters defaults to
32,768, so each slope is several ms at that width.

    python -m cudasp_tpu_torch.tools.alu_probe [--rows 8] [--bt 32768]
        [--iters 32768] [--device cuda|cpu] [--seed 0]

--device cpu runs the plain version (ops/probes.py alu_plain) and times
it with the host clock; the default, cuda, raises without a GPU.
"""

import argparse
import sys

import numpy as np

from ..api import TILE_CUDA
from ..ops import probes as P

REPS = 5

ROWS = 8


def run(name, op, x, iters):
    """One op's slope over the (rows, bt) lanes of x; returns its
    numbers."""
    rows, bt = x.shape
    t1 = P.best_ms(lambda: P.alu(x, op, iters), x.device, REPS)
    t3 = P.best_ms(lambda: P.alu(x, op, 3 * iters), x.device, REPS)
    per_iter = (t3 - t1) * 1e-3 / (2 * iters)
    nops = P.NSTREAMS * rows * bt
    rate = nops / per_iter if per_iter > 0 else float("nan")
    print(f"{name:20s} {t1:8.3f}/{t3:8.3f} ms  {t3 - t1:8.3f} ms slope  "
          f"{rate / 1e9:8.1f} Gop/s ({rows}x{bt}, {P.NSTREAMS} streams, "
          f"{iters} iters)", flush=True)
    return {"t1_ms": t1, "t3_ms": t3, "iters": iters, "ops_per_s": rate}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--bt", type=int, default=TILE_CUDA // ROWS)
    ap.add_argument("--iters", type=int, default=32768)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = P.resolve_device(args.device)
    print(f"# device: {P.device_name(dev)}", file=sys.stderr)
    rng = np.random.default_rng(args.seed)
    x = P.to_device(P.raw_planes(rng, (args.rows, args.bt), low=1), dev)
    return {name: run(name, op, x, args.iters)
            for op, name in enumerate(P.ALU_OPS)}


if __name__ == "__main__":
    main()
