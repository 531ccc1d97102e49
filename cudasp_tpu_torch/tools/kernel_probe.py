"""Correctness and throughput of the scan kernel alone: the port of the JAX
package's tools/kernel_probe.py. One batch of tools/dataset.py's table
(the BIP-352 query, every 100th row a match) is packed once
(ops/kernels.py pack_batch_arrays) and put on the device, so the host
path is bypassed; then, for each ladder and wire, one scan_flags launch
is checked against the table's is_match, and the best of --reps launches
is timed (CUDA events on the card, the host clock on the CPU). One JSON
line a (ladder, wire).

    python -m cudasp_tpu_torch.tools.kernel_probe [--rows 262144]
        [--block-rows 256] [--labels 0] [--reps 3] [--pool 64]
        [--ladders fixed,wnaf,static] [--wires x,xy] [--device cuda|cpu]

--device cpu runs the plain version (a few hundred rows keep it to
seconds); the default, cuda, raises without a GPU. Exits 1 when any
ladder's flags differ from is_match.
"""

import argparse
import json
import sys

import numpy as np

from ..io import ingest
from ..ops import kernels as K
from ..ops import probes as P
from ..oracle import vectors as V
from . import dataset


def probe(rows, block_rows, labels, reps, pool, ladders, wires, device):
    """[{ladder, wire, rows, ms, rows_per_s, ok, matches}] for each ladder
    and wire."""
    key, spend, k, sp = dataset.bip352_query()
    tweaks, flat, offsets, is_match = dataset.make_dataset(
        rows, pool=pool, scan_key=k, spend=sp)
    sched, spw, lab, _ = ingest.pack_query_keys(key, spend,
                                                [V.LABEL2] * labels)
    b = next(ingest.iter_packed(tweaks, flat, offsets, rows, 3))
    q = [P.to_device(a, device) for a in (spw, lab)]
    comb = K.comb_table(device)
    expect = np.flatnonzero(is_match)
    out = []
    for wire in wires:
        planes = [P.to_device(p, device) for p in K.pack_batch_arrays(
            b.tweak_blobs, b.row_valid, b.outputs_hi, b.outputs_lo,
            b.outputs_valid, block_rows, wire=wire)]
        width = planes[0].shape[1]
        for ladder in ladders:
            digits, static = sched.operands(ladder)

            def launch():
                return K.scan_flags(*planes, digits, *q, comb,
                                    block_rows=block_rows, wire=wire,
                                    pack_flags=width % 32 == 0,
                                    ladder=ladder, static_sched=static)

            got = np.flatnonzero(K.flags_to_bool(
                launch().cpu().numpy(), rows))
            ok = bool(np.array_equal(got, expect))
            ms = P.best_ms(launch, device, reps)
            r = {"ladder": ladder, "wire": wire, "block_rows": block_rows,
                 "rows": width, "ms": ms, "rows_per_s": width / ms * 1e3,
                 "ok": ok, "matches": len(got), "expected": len(expect)}
            print(json.dumps(r), flush=True)
            print(f"# correctness {ladder}/{wire}: "
                  f"{'OK' if ok else 'MISMATCH'} ({len(got)} vs "
                  f"{len(expect)})", file=sys.stderr, flush=True)
            out.append(r)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=262_144)
    ap.add_argument("--block-rows", type=int, default=256)
    ap.add_argument("--labels", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--pool", type=int, default=64)
    ap.add_argument("--ladders", default=",".join(K.LADDERS))
    ap.add_argument("--wires", default="x,xy")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = P.resolve_device(args.device)
    print(f"# device: {P.device_name(dev)}", file=sys.stderr)
    return probe(args.rows, args.block_rows, args.labels, args.reps,
                 args.pool, args.ladders.split(","), args.wires.split(","),
                 dev)


if __name__ == "__main__":
    sys.exit(0 if all(r["ok"] for r in main()) else 1)
