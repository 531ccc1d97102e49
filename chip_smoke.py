#!/usr/bin/env python3
# Smoke run of the PyTorch/CUDA port on one NVIDIA GPU:
#
#     python3 chip_smoke.py
#
# Builds the scan kernel from cudasp_tpu_torch/csrc with nvcc, holds it
# against its plain-torch version and the golden vectors on the card, then
# drives cudasp_tpu_torch.scan over a 2,300,000-row table (the reference's
# "2 weeks" table, 3 outputs a row, ~1% planted matches) and checks the
# matches exactly. Every phase prints one line with its result and the
# elapsed seconds; any failure raises, so the exit code is non-zero. The
# last lines are the kernels' JSON line, the card's name and power limit,
# and {"ok": true, "device": ...}. A watchdog ends a hung run with a stack
# trace. Imports torch, numpy and cudasp_tpu_torch only.
import faulthandler

faulthandler.dump_traceback_later(1080, exit=True)

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

T0 = time.perf_counter()
SEED = 7
MAIN_ROWS = 2_300_000
OUTPUTS_PER_ROW = 3
MATCH_RATE = 0.01
POOL = 64
RANDOM_ROWS = 8192
BLOCK_ROWS = 256
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM 3.35 TB/s; float32
# outside the tensor cores 67 TFLOP/s = 33.5 T fused multiply-adds/s. The
# int32 multiply-add pipe issues half the float32 lanes (64 of 128 a
# clock per SM), so its peak is taken as 16.75 T multiply-adds/s.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 33.5e12 / 2
# a 256-bit field product on the card: 64 32x32->64-bit multiply-adds for
# the schoolbook, 8 more for the fold by 977
IMAD_PER_PRODUCT = 72


def phase(name, result):
    print(f"[{name}] {result} ({time.perf_counter() - T0:.1f} s)",
          flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_dataset(n_rows, seed):
    """Query keys and a (n_rows, 64) tweak table drawn from a pool of POOL
    oracle-computed points, 3 random outputs a row, and ~1% of rows with
    the row's true upper-64 value planted in a random slot."""
    import numpy as np

    from cudasp_tpu_torch.oracle import ec as O
    from cudasp_tpu_torch.oracle.encoding import (point_to_blob64,
                                                  scalar_to_blob32)
    from cudasp_tpu_torch.oracle.pipeline import candidate_values

    rng = np.random.default_rng(seed)
    g = (O.GX, O.GY)
    scan_key = int.from_bytes(rng.bytes(32), "big") % (O.N - 1) + 1
    spend = O.ec_mul(g, int.from_bytes(rng.bytes(32), "big") % (O.N - 1) + 1)
    points = [O.ec_mul(g, int(k)) for k in rng.integers(1, 2**62, size=POOL)]
    blobs = np.stack([np.frombuffer(point_to_blob64(p), np.uint8)
                      for p in points])
    values = np.array([candidate_values(p, scan_key, spend)[0]
                       for p in points], np.int64)
    row_pool = rng.integers(0, POOL, size=n_rows)
    flat = rng.integers(-2**62, 2**62, size=n_rows * OUTPUTS_PER_ROW,
                        dtype=np.int64)
    planted = np.flatnonzero(rng.random(n_rows) < MATCH_RATE)
    slot = rng.integers(0, OUTPUTS_PER_ROW, size=len(planted))
    flat[planted * OUTPUTS_PER_ROW + slot] = values[row_pool[planted]]
    table = {
        "txid": np.arange(n_rows, dtype=np.int64),
        "height": np.arange(n_rows, dtype=np.int64) + 800_000,
        "tweak_key": blobs[row_pool],
        "outputs": (flat, np.arange(n_rows + 1, dtype=np.int64)
                    * OUTPUTS_PER_ROW),
    }
    return (scalar_to_blob32(scan_key), point_to_blob64(spend), table,
            planted)


def batch_planes(table, rows, key, spend, labels, wire, dev,
                 live_rows=None):
    """The first `rows` rows of a table as device planes, the way the
    executor packs them, plus the query operands. live_rows: rows past
    this index fall in blockmask-dead tiles."""
    import numpy as np
    import torch

    from cudasp_tpu_torch.io import ingest
    from cudasp_tpu_torch.ops import kernels as K

    flat, offs = table["outputs"]
    b = next(ingest.iter_packed(table["tweak_key"][:rows], flat[:offs[rows]],
                                offs[:rows + 1], rows,
                                int(np.diff(offs[:rows + 1]).max())))
    planes = K.pack_batch_arrays(b.tweak_blobs, b.row_valid, b.outputs_hi,
                                 b.outputs_lo, b.outputs_valid,
                                 block_rows=BLOCK_ROWS, wire=wire)
    sched, sp, lab, _ = ingest.pack_query_keys(key, spend, labels)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)

    bmask = None
    if live_rows is not None:
        width = planes[0].shape[1]
        bmask = t(K.live_blockmask(live_rows, width // BLOCK_ROWS,
                                   BLOCK_ROWS))
    return ([t(p) for p in planes], sched, t(sp), t(lab), K.comb_table(dev),
            bmask)


def check(name, kf, pf, width, expect):
    """Kernel flags vs plain flags (same layout) and both vs `expect`, a
    set of row indices. Returns (mismatches, max |kernel - plain|)."""
    import numpy as np

    from cudasp_tpu_torch.ops import kernels as K

    kb = K.flags_to_bool(kf.cpu().numpy(), width)
    pb = K.flags_to_bool(pf.cpu().numpy(), width)
    diff = np.abs(kb.astype(np.int64) - pb.astype(np.int64))
    mism, err = int(diff.sum()), int(diff.max(initial=0))
    got = set(np.flatnonzero(kb).tolist())
    if mism or got != set(expect) or set(np.flatnonzero(pb)) != set(expect):
        raise AssertionError(
            f"{name}: kernel {sorted(got)[:10]} plain "
            f"{np.flatnonzero(pb)[:10].tolist()} expected "
            f"{sorted(expect)[:10]} ({mism} mismatches)")
    return mism, err


def compare(name, args, wire, expect, pack_flags=False):
    """Kernel vs plain on the same device tensors. The comparison's own
    launch is taken back out of the kernel's launch count."""
    import torch

    from cudasp_tpu_torch.ops import kernels as K

    planes, sched, sp, lab, comb, bmask = args
    launches = K.scan_kernel.launches
    kf = K.scan_flags(*planes, sched, sp, lab, comb, bmask,
                      block_rows=BLOCK_ROWS, wire=wire,
                      pack_flags=pack_flags)
    torch.cuda.synchronize()
    pf = K.scan_plain(*planes, sched, sp, lab, comb, bmask, wire=wire,
                      block_rows=BLOCK_ROWS)
    if pack_flags:
        pf = K.pack_flag_words(pf)
    K.scan_kernel.launches = launches
    return check(name, kf, pf, planes[0].shape[1], expect)


def golden_table(case):
    import numpy as np

    return {
        "tweak_key": np.stack([np.frombuffer(r.tweak_blob, np.uint8)
                               for r in case.rows]),
        "outputs": (np.concatenate([np.asarray(r.outputs, np.int64)
                                    for r in case.rows]),
                    np.cumsum([0] + [len(r.outputs) for r in case.rows])),
    }


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import cudasp_tpu_torch as ct
    from cudasp_tpu_torch.ops import field as F
    from cudasp_tpu_torch.ops import kernels as K
    from cudasp_tpu_torch.oracle import vectors as V

    dev = torch.device("cuda")
    smi = nvidia_smi()
    phase("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()} | nvidia-smi: {smi}")

    K.scan_kernel.library()
    bs = K.scan_kernel.build_seconds
    ptxas = [ln.strip() for ln in K.scan_kernel.build_log.splitlines()
             if "registers" in ln or "stack frame" in ln][:2]
    phase("build", ("cached" if bs is None else f"nvcc {bs:.1f} s")
          + (f" | {' | '.join(ptxas)}" if ptxas else ""))

    # --- kernel vs plain on the card -------------------------------------
    mismatches = max_err = 0

    def tally(r):
        nonlocal mismatches, max_err
        mismatches += r[0]
        max_err = max(max_err, r[1])

    for case in V.CASES:
        tab = golden_table(case)
        expect = {i for i, r in enumerate(case.rows)
                  if r.height in case.expected_heights}
        for wire in ("x", "xy"):
            args = batch_planes(tab, len(case.rows), case.scan_key_blob,
                                case.spend_blob, case.label_blobs, wire, dev)
            tally(compare(f"{case.name}/{wire}", args, wire, expect))
    phase("golden", f"{len(V.CASES)} cases x 2 wires, kernel == plain == "
          f"expected")

    key, spend, table, planted = make_dataset(MAIN_ROWS, SEED)
    phase("dataset", f"{MAIN_ROWS} rows from {POOL} oracle points, "
          f"{len(planted)} planted")

    exp_r = set(planted[planted < RANDOM_ROWS].tolist())
    for wire in ("x", "xy"):
        for pack in (False, True):
            args = batch_planes(table, RANDOM_ROWS, key, spend, (), wire, dev)
            tally(compare(f"random/{wire}/packed={pack}", args, wire,
                          exp_r, pack_flags=pack))
    # blockmask: rows past `live` are in dead tiles and must flag 0
    live = 3 * BLOCK_ROWS + 17
    args = batch_planes(table, RANDOM_ROWS, key, spend, (), "x", dev,
                        live_rows=live)
    exp_live = {i for i in exp_r if i < 4 * BLOCK_ROWS}
    tally(compare("blockmask", args, "x", exp_live, pack_flags=True))
    phase("kernel-vs-plain", f"{RANDOM_ROWS} random rows (wires x/xy, "
          f"int8/packed flags, {len(exp_r)} planted) and a dead-tile batch: "
          f"{mismatches} mismatches")

    # the main path's launch shape: one full batch, timed
    width = ct.api.TILE_CUDA
    args = batch_planes(table, width, key, spend, (), "x", dev)
    planes, sched, sp, lab, comb, _ = args
    exp_w = set(planted[planted < width].tolist())
    t0 = time.perf_counter()
    launches = K.scan_kernel.launches
    kf = K.scan_flags(*planes, sched, sp, lab, comb, pack_flags=True)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    F.PRODUCTS[0] = 0
    ev[0].record()
    pf = K.scan_plain(*planes, sched, sp, lab, comb, wire="x")
    ev[1].record()
    torch.cuda.synchronize()
    plain_ms = ev[0].elapsed_time(ev[1])
    products_per_row = F.PRODUCTS[0] / width
    tally(check("main-batch", kf, K.pack_flag_words(pf), width, exp_w))
    del pf
    reps = 10
    K.scan_flags(*planes, sched, sp, lab, comb, pack_flags=True)
    ev[0].record()
    for _ in range(reps):
        K.scan_flags(*planes, sched, sp, lab, comb, pack_flags=True)
    ev[1].record()
    torch.cuda.synchronize()
    kernel_ms = ev[0].elapsed_time(ev[1]) / reps
    K.scan_kernel.launches = launches
    bytes_moved = (sum(p.numel() * 4 for p in planes) + width // 8
                   + comb.numel() * 4 + sp.numel() * 4)
    ops = products_per_row * IMAD_PER_PRODUCT * width
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / IMAD_PER_S) * 1e3
    bound_by = ("operations" if ops / IMAD_PER_S
                > bytes_moved / HBM_BYTES_PER_S else "bytes")
    phase("kernel-time", f"{width} rows: kernel {kernel_ms:.3f} ms "
          f"({width / kernel_ms * 1e3:,.0f} rows/s kernel-only), plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.3f} ms by {bound_by} "
          f"({products_per_row:.0f} field products/row) | {smi} "
          f"[{time.perf_counter() - t0:.1f} s]")

    # --- the main path ----------------------------------------------------
    ct.scan({k: (v[:4096] if k != "outputs" else
                 (v[0][:4096 * OUTPUTS_PER_ROW], v[1][:4097]))
             for k, v in table.items()}, key, spend)      # warm-up
    K.scan_kernel.launches = 0
    t0 = time.perf_counter()
    res = ct.scan(table, key, spend)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    main_launches = K.scan_kernel.launches
    if not np.array_equal(res.indices, planted):
        raise AssertionError(
            f"main path: {len(res.indices)} matches, expected "
            f"{len(planted)}; first differences "
            f"{np.setxor1d(res.indices, planted)[:10].tolist()}")
    if main_launches <= 0:
        raise AssertionError("main path launched the scan kernel 0 times")
    if not np.array_equal(res.height, planted + 800_000):
        raise AssertionError("main path: passthrough heights differ")
    m = res.metrics
    phase("main-path", f"{MAIN_ROWS} rows in {secs:.3f} s = "
          f"{MAIN_ROWS / secs:,.0f} tx/s end to end; {len(res.indices)} "
          f"matches == planted; {main_launches} kernel launches of "
          f"{m.batch_size} rows; pack {m.pack_seconds:.3f} s, staging "
          f"{m.upload_seconds:.3f} s, device wait "
          f"{m.device_wait_seconds:.3f} s, {m.upload_bytes / 1e6:.1f} MB "
          f"up; kernel-only {width / kernel_ms * 1e3:,.0f} rows/s | {smi}")

    print(json.dumps({"kernels": [{
        "name": "scan_kernel",
        "route": "cuda",
        "source": "cudasp_tpu_torch/csrc/scan.cu",
        "replaces": "cudasp_tpu/ops/kernels.py:737",
        "launches": main_launches,
        "mismatches": mismatches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
