"""Per-stage timing of the scan kernel on the GPU: the port of the JAX
package's tools/stage_profile.py, through stage_kernel (csrc/probe.cu),
whose stages are the scan kernel's own code (csrc/secp256k1.cuh):

  decompress     x -> y = sqrt(x^3 + 7), parity select
  ladder window  4 doublings + 2 mixed adds (32 of them make the ladder)
  table+inv      build_table: co-Z chain of the odd multiples, one
                 inversion, beta images
  serial+hash    inversion, canonical affine x, tagged SHA-256
  comb32         32 comb reads + mixed adds, bytes in registers
  comb32 smem    the same with the bytes staged through shared memory
  match2         2 candidate adds, an inversion each, upper-64 compare

Each stage chains through a, n1 and n2 times, and is timed by the slope
(t2 - t1) / (n2 - n1), with CUDA events around each launch (best of
3). The FULL line times one launch of the scan kernel itself
(ops/kernels.py scan_flags, ladder "fixed", x wire, packed flags) over
--bt copies of golden case 0's row 0 with 3 seeded outputs a row, and the
budget line sets decompress + table + 32 x window + serial + comb32 +
match2 against it, per row.

The default width is the scan's launch width, 262,144 lanes
(api.TILE_CUDA), which is also the FULL line's row count: the JAX tool's
512 lanes make 4 blocks of 128 threads, 4 of the H100's 132 SMs. The
repeat counts are the JAX tool's; --iters N replaces them all with N and
3N.

    python -m cudasp_tpu_torch.tools.stage_profile [--bt 262144]
        [--iters N] [--device cuda|cpu] [--seed 0]

--device cpu runs the plain versions (ops/probes.py stage_plain and
kernels.scan_plain) and times them with the host clock; the default,
cuda, raises without a GPU.
"""

import argparse
import sys

import numpy as np

from ..api import TILE_CUDA
from ..io import ingest
from ..ops import kernels as K
from ..ops import probes as P

REPS = 3
from ..oracle import vectors as V

# the JAX tool's repeat counts (n1, n2) a stage
REPEATS = {"decompress": (40, 120), "ladder window": (200, 600),
           "table+inv": (40, 120), "serial+hash": (100, 300),
           "comb32": (30, 90), "comb32 smem": (30, 90),
           "match2": (100, 300)}
FULL_OUTPUTS = 3
BLOCK_ROWS = 256
BUDGET = (("decompress", 1), ("table+inv", 1), ("ladder window", 32),
          ("serial+hash", 1), ("comb32", 1), ("match2", 1))


def run_stage(index, x, y, comb, n1, n2):
    name = P.STAGES[index]
    bt = x.shape[1]
    t1 = P.best_ms(lambda: P.stage(x, y, index, n1, comb), x.device, REPS)
    t2 = P.best_ms(lambda: P.stage(x, y, index, n2, comb), x.device, REPS)
    per_us = (t2 - t1) * 1e3 / (n2 - n1)
    print(f"{name:14s} {per_us:9.1f} us/iter   ({bt} lanes; "
          f"{per_us * 1e3 / bt:7.2f} ns/row; {t1:.3f}/{t2:.3f} ms at "
          f"{n1}/{n2} iters)", flush=True)
    return {"t1_ms": t1, "t2_ms": t2, "n1": n1, "n2": n2,
            "us_per_iter": per_us, "ns_per_row": per_us * 1e3 / bt}


def full_batch(rows, seed, device):
    """The FULL line's operands: `rows` copies of golden case 0's row 0,
    FULL_OUTPUTS seeded outputs a row, as scan_flags takes them."""
    case = V.CASES[0]
    blobs = np.tile(np.frombuffer(case.rows[0].tweak_blob, np.uint8),
                    (rows, 1))
    rng = np.random.default_rng(seed)
    oh = rng.integers(0, 2**31, (rows, FULL_OUTPUTS)).astype(np.int32)
    ol = rng.integers(0, 2**31, (rows, FULL_OUTPUTS)).astype(np.int32)
    br = min(BLOCK_ROWS, rows)
    planes = K.pack_batch_arrays(blobs, np.ones(rows, bool), oh, ol,
                                 np.ones((rows, FULL_OUTPUTS), bool), br)
    sched, sp, lab, _ = ingest.pack_query_keys(case.scan_key_blob,
                                               case.spend_blob, [])
    return ([P.to_device(p, device) for p in planes], sched.odd,
            P.to_device(sp, device), P.to_device(lab, device), br)


def run_full(rows, seed, comb, device):
    planes, digits, sp, lab, br = full_batch(rows, seed, device)
    width = planes[0].shape[1]
    ms = P.best_ms(lambda: K.scan_flags(*planes, digits, sp, lab, comb,
                                        block_rows=br,
                                        pack_flags=width % 32 == 0),
                   device, REPS)
    ns_row = ms * 1e6 / width
    print(f"{'FULL kernel':14s} {ms * 1e3:9.1f} us/launch ({width} rows; "
          f"{width / ms / 1e3:.3f} M rows/s; {ns_row:.2f} ns/row)",
          flush=True)
    return {"ms": ms, "rows": width, "ns_per_row": ns_row}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bt", type=int, default=TILE_CUDA)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = P.resolve_device(args.device)
    print(f"# device: {P.device_name(dev)}", file=sys.stderr)
    rng = np.random.default_rng(args.seed)
    x, y = (P.to_device(P.field_planes(rng, args.bt), dev) for _ in range(2))
    comb = K.comb_table(dev)
    out = {}
    for index, name in enumerate(P.STAGES):
        n1, n2 = REPEATS[name] if args.iters is None else (args.iters,
                                                            3 * args.iters)
        out[name] = run_stage(index, x, y, comb, n1, n2)
        if name == "ladder window":
            print(f"  -> full 32-window ladder: "
                  f"{out[name]['us_per_iter'] * 32:.0f} us", flush=True)
    full = out["FULL"] = run_full(args.bt, args.seed, comb, dev)
    parts = sum(out[name]["ns_per_row"] * k for name, k in BUDGET)
    share = parts / full["ns_per_row"]
    out["budget"] = {"ns_per_row": parts, "share": share}
    print(f"budget: decompress + table + 32 x window + serial + comb32 + "
          f"match2 = {parts:.2f} ns/row against FULL "
          f"{full['ns_per_row']:.2f} ns/row: the stages explain "
          f"{share:.1%}", flush=True)
    return out


if __name__ == "__main__":
    main()
