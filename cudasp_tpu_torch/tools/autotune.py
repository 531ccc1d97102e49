"""Sweep the scan kernel's launch shape on the attached card and write the
winner as the card's tuning row: the port of the JAX package's
tools/autotune.py.

Each setting (block_rows, tile) times one ops.kernels.scan_flags launch
of `tile` rows (ladder "fixed", wire "x") on device-resident random
planes, with CUDA events (best of --reps after a warm-up): the kernel
alone, as the reference's one_run, since the stage costs do not depend on
the data. One line a setting; the fastest rows a second wins, and is
written with runtime.tuning.save_autotuned to
build/cudasp_tpu_torch/tuning_<kind>.json, which runtime.tuning reads
ahead of its built-in table.

    python -m cudasp_tpu_torch.tools.autotune [--dry-run] [--quick]
        [--reps 3] [--device cuda|cpu] [--rows N]

--dry-run writes nothing. --quick sweeps a reduced grid. --device cpu
times the plain version with the host clock at --rows rows (a few hundred
keep it to seconds); --rows replaces the tile grid on either device. The
default device, cuda, raises without a GPU: nothing falls back to the
CPU.
"""

import argparse
import itertools
import json
import sys

import numpy as np

from ..io import ingest
from ..ops import kernels as K
from ..ops import probes as P
from ..oracle import vectors as V
from ..runtime import tuning

BLOCK_ROWS = (128, 256, 512, 1024)
TILES = (131_072, 262_144, 524_288)
QUICK = ((256, 512), (262_144,))
OUTPUTS = 3


def one_setting(block_rows, tile, device, reps, query):
    """ms of one launch of `tile` rows (a block_rows multiple) and its rows
    a second."""
    n = tile // block_rows * block_rows
    rng = np.random.default_rng(0)
    tw, oh, ol = (P.to_device(P.raw_planes(rng, (k, n)), device)
                  for k in (8, OUTPUTS, OUTPUTS))
    ovm = np.full((1, n), (1 << 31) | ((1 << OUTPUTS) - 1), np.uint32)
    ovm = P.to_device(ovm.view(np.int32), device)
    digits, spend, labels, comb = query

    def launch():
        K.scan_flags(tw, oh, ol, ovm, digits, spend, labels, comb,
                     block_rows=block_rows, pack_flags=n % 32 == 0)

    ms = P.best_ms(launch, device, reps)
    return {"block_rows": block_rows, "tile": n, "ms": ms,
            "rows_per_s": n / ms * 1e3}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=None,
                    help="rows a launch: one tile in place of the grid's")
    args = ap.parse_args(argv)
    dev = P.resolve_device(args.device)
    kind = tuning.device_kind(dev)
    print(f"# device kind: {kind}; {P.device_name(dev)}", file=sys.stderr)
    brs, tiles = QUICK if args.quick else (BLOCK_ROWS, TILES)
    if args.rows is not None:
        tiles = (args.rows,)
    sched, spend, labels, _ = ingest.pack_query_keys(
        V.SCAN_KEY_BIP352, V.SPEND_BIP352, [])
    query = (sched.odd, *(P.to_device(np.ascontiguousarray(a).view(np.int32),
                                      dev) for a in (spend, labels)),
             K.comb_table(dev))
    results = []
    for br, tile in itertools.product(brs, tiles):
        if br > tile:
            continue
        r = one_setting(br, tile, dev, args.reps, query)
        results.append(r)
        print(json.dumps(r), flush=True)
    if not results:
        raise SystemExit(f"no block_rows of {brs} fits in {tiles} rows")
    best = max(results, key=lambda r: r["rows_per_s"])
    print(f"best: block_rows={best['block_rows']} tile={best['tile']} "
          f"({best['rows_per_s']:,.0f} rows/s, {best['ms']:.3f} ms)")
    if not args.dry_run:
        path = tuning.save_autotuned(kind, best["block_rows"], best["tile"])
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
