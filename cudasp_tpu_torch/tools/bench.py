"""The port's benchmark: the counterpart of the JAX package's root bench.py.
Scan throughput of cudasp_tpu_torch.scan on tools/dataset.py's table (the
BIP-352 query, every 100th row a planted match), by default the
reference's headline size of 32,700,000 rows, against the upstream
extension's published 2,622,216 tx/s on that table (2x RTX 5090,
BASELINE.md).

    python -m cudasp_tpu_torch.tools.bench [--rows 32700000]
        [--batch-size 300000] [--labels 0] [--pool 256] [--repeats 3]
        [--max-repeats 8] [--no-kernel-only] [--no-static-kernel]
        [--device cuda|cpu]

Protocol (bench.py's): the table is built outside the timed window; a
warm-up scan() on min(rows, batch + 1) rows loads (or builds, under
build/) the kernel library and the C packer; one discarded scan on
2 x batch rows; then timed scan() calls, each ending with host results,
so the clock stops after the card has finished. Every timed run's rows
must equal the planted ones, else the line is bench.py's error line
(value 0) and the exit code 1. Repeats extend past --repeats until the
best two runs agree within 10%, up to --max-repeats.

link_MBps is the best run's upload_bytes over its h2d_seconds: the H2D
copies timed by CUDA events on the copy stream, so it is the link's rate
while it carries the batches (0 on the CPU, which copies nothing).
Runs whose rate fell under half the best run's are left out of `spread`
and counted in `collapsed_runs`, as bench.py does.

Kernel-only (on a GPU, unless --no-kernel-only): one batch of
min(524,288, rows) rows is packed once (ops/kernels.py pack_batch_arrays)
and put on the card, and one scan_flags launch is timed (a warm launch,
then the best of 3 by CUDA events) on the x wire, on the xy (full64)
wire and, unless --no-static-kernel, with the key's static ladder on xy
(its library is built under build/ if tools/seed_cache has not). The
launch shape is the executor's: block_rows from runtime.tuning
(CUDASP_BLOCK_ROWS over it), the ladder from CUDASP_LADDER (else fixed).
Each variant's flags are held to the table's planted rows before its
time is kept. rows/s counts real rows, not padded lanes.

The default batch size is scan()'s own (api.DEFAULT_BATCH_SIZE), cut to
the device's launch width (runtime.tuning). Each timed run's stages go to
stderr as `# run {json}` lines; the result is one JSON line on stdout,
last: bench.py's keys plus "device" (nvidia-smi's name and power limit).
--device cpu runs the kernel's plain version (a few hundred rows keep it
to seconds) and skips the kernel-only measurement; the default, cuda,
raises without a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

from .. import api
from ..io import ingest
from ..ops import kernels as K
from ..ops import probes as P
from ..oracle import vectors as V
from ..runtime import tuning
from . import dataset

BASELINE_TXS = 2_622_216.0
KERNEL_ROWS = 524_288
KERNEL_REPS = 3


def device_info(dev) -> dict:
    """{"name", "power_limit"} of the card as nvidia-smi reads them; the
    CPU has no power limit."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    name, limit = out.stdout.strip().splitlines()[dev.index or 0].rsplit(
        ", ", 1)
    return {"name": name, "power_limit": limit}


def _head(table, n):
    tweaks, (flat, offsets) = table["tweak_key"], table["outputs"]
    return {"tweak_key": tweaks[:n],
            "outputs": (flat[: offsets[n]], offsets[: n + 1])}


def kernel_only(tweaks, flat, offsets, is_match, label_blobs, dev,
                static=True, n=KERNEL_ROWS):
    """{variant: rows/s} of one device-resident scan_flags launch over the
    first n rows (module docstring), or None when a variant's flags are
    not the planted rows."""
    n = min(n, len(is_match))
    block_rows = tuning.block_rows_default(dev)
    ladder = api.resolve_ladder(api.ScanConfig())
    key, spend, _, _ = dataset.bip352_query()
    sched, spw, lab, _ = ingest.pack_query_keys(key, spend, label_blobs)
    q = [P.to_device(a, dev) for a in (spw, lab)]
    comb = K.comb_table(dev)
    b = next(ingest.iter_packed(tweaks[:n], flat[: offsets[n]],
                                offsets[: n + 1], n, 3))
    expect = np.flatnonzero(is_match[:n])
    variants = [("kernel_rows_per_s", "x", ladder),
                ("kernel_rows_per_s_full64", "xy", ladder)]
    if static:
        variants.append(("kernel_rows_per_s_static_full64", "xy", "static"))
    out = {}
    planes = {}
    for name, wire, lad in variants:
        if wire not in planes:
            planes[wire] = [P.to_device(p, dev) for p in K.pack_batch_arrays(
                b.tweak_blobs, b.row_valid, b.outputs_hi, b.outputs_lo,
                b.outputs_valid, block_rows, wire=wire)]
        pl = planes[wire]
        width = pl[0].shape[1]
        digits, static_sched = sched.operands(lad)

        def launch():
            return K.scan_flags(*pl, digits, *q, comb,
                                block_rows=block_rows, wire=wire,
                                pack_flags=width % 32 == 0, ladder=lad,
                                static_sched=static_sched)

        got = np.flatnonzero(K.flags_to_bool(launch().cpu().numpy(), n))
        if not np.array_equal(got, expect):
            print(f"# kernel-only {lad}/{wire}: MISMATCH, {len(got)} rows "
                  f"flagged, {len(expect)} planted", file=sys.stderr)
            return None
        ms = P.best_ms(launch, dev, KERNEL_REPS)
        out[name] = n / ms * 1e3
        print(f"# kernel-only {lad}/{wire}: {ms:.3f} ms / {n} rows "
              f"(one launch of {width} lanes, block_rows {block_rows}) -> "
              f"{out[name]:,.0f} rows/s", file=sys.stderr)
    return out


def _error_line():
    return json.dumps({"metric": "scan_throughput", "value": 0,
                       "unit": "tx/s", "vs_baseline": 0.0,
                       "error": "match verification failed"})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=32_700_000)
    ap.add_argument("--batch-size", type=int, default=api.DEFAULT_BATCH_SIZE)
    ap.add_argument("--labels", type=int, default=0)
    ap.add_argument("--pool", type=int, default=256)
    ap.add_argument("--repeats", type=int, default=3,
                    help="minimum timed runs; extended (to --max-repeats) "
                         "until the best two agree within 10%%")
    ap.add_argument("--max-repeats", type=int, default=8)
    ap.add_argument("--no-kernel-only", action="store_true",
                    help="skip the device-resident kernel-only measurement")
    ap.add_argument("--no-static-kernel", action="store_true",
                    help="skip the static-ladder kernel-only variant (its "
                         "library is one nvcc build per key)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = P.resolve_device(args.device)
    card = device_info(dev)
    print(f"# device: {P.device_name(dev)} | {card}", file=sys.stderr)

    key, spend, k, sp = dataset.bip352_query()
    label_blobs = [V.LABEL2] * args.labels
    t0 = time.perf_counter()
    tweaks, flat, offsets, is_match = dataset.make_dataset(
        args.rows, pool=args.pool, scan_key=k, spend=sp)
    expected = np.flatnonzero(is_match)
    table = {"tweak_key": tweaks, "outputs": (flat, offsets)}
    print(f"# dataset: {args.rows} rows, {len(expected)} planted, "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)

    def scan(tab):
        return api.scan(tab, key, spend, label_blobs,
                        batch_size=args.batch_size, device=dev)

    t0 = time.perf_counter()
    scan(_head(table, min(args.rows, args.batch_size + 1)))
    print(f"# warm-up (library load or build): "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    scan(_head(table, min(args.rows, 2 * args.batch_size)))
    print(f"# settle run (discarded): {time.perf_counter() - t0:.2f} s",
          file=sys.stderr)

    times, links = [], []
    upload_mode = None
    while True:
        t0 = time.perf_counter()
        res = scan(table)
        dt = time.perf_counter() - t0
        m = res.metrics
        link = m.upload_bytes / m.h2d_seconds / 1e6 if m.h2d_seconds else 0.0
        times.append(dt)
        links.append(link)
        upload_mode = m.upload_mode or "full"
        print("# run " + json.dumps({
            "seconds": dt, "pack_seconds": m.pack_seconds,
            "h2d_seconds": m.h2d_seconds,
            "device_wait_seconds": m.device_wait_seconds,
            "launch_rows": m.launch_rows, "batches": m.batches,
            "matches": m.matches, "upload_mode": upload_mode,
            "link_MBps": link}), file=sys.stderr, flush=True)
        if not np.array_equal(res.indices, expected):
            print(f"# MISMATCH: expected {len(expected)} matches, got "
                  f"{len(res.indices)}", file=sys.stderr)
            print(_error_line())
            return 1
        if len(times) >= args.max_repeats:
            break
        if len(times) >= args.repeats:
            two = sorted(times)[:2]
            if two[1] <= 1.10 * two[0]:
                break
            print(f"# best two {two[0]:.3f} s / {two[1]:.3f} s disagree "
                  f">10%: extending repeats", file=sys.stderr)
    best = min(times)
    best_link = links[int(np.argmin(times))]
    core = [t for t, lk in zip(times, links)
            if not best_link or lk >= 0.5 * best_link]
    spread = max(core) / min(core)
    if spread > 1.3:
        print(f"# WARNING: run-to-run spread {spread:.2f}x > 1.3x (times "
              f"{times})", file=sys.stderr)

    kern = {}
    if not args.no_kernel_only and dev.type == "cuda":
        kern = kernel_only(tweaks, flat, offsets, is_match, label_blobs, dev,
                           static=not args.no_static_kernel)
        if kern is None:
            print(_error_line())
            return 1

    txs = args.rows / best
    out = {
        "metric": "scan_throughput",
        "value": txs,
        "unit": "tx/s",
        "vs_baseline": txs / BASELINE_TXS,
        "rows": args.rows,
        "seconds": best,
        "batch_size": args.batch_size,
        "labels": args.labels,
        "repeats": len(times),
        "spread": spread,
        "spread_best2": sorted(times)[1] / best if len(times) > 1 else 1.0,
        "collapsed_runs": len(times) - len(core),
        "upload_mode": upload_mode,
        "link_MBps": best_link,
        "link_MBps_range": [min(links), max(links)],
        **kern,
        "device": card,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
