#!/usr/bin/env python3
# Smoke run of the PyTorch/CUDA port on one NVIDIA GPU:
#
#     python3 chip_smoke.py
#
# Builds the scan kernel's three ladders from cudasp_tpu_torch/csrc with
# nvcc, all builds started together: csrc/scan.cu ("fixed" and "wnaf") and
# one generated translation unit per scan key ("static"). Holds each
# against its plain-torch version and the golden vectors on the card, times
# each at the main path's launch width, then drives cudasp_tpu_torch.scan
# over a 2,300,000-row table (the reference's "2 weeks" table, 3 outputs a
# row, ~1% planted matches) three times: ScanConfig() (fixed ladder, x
# wire), ScanConfig(ladder="wnaf") and ScanConfig(static_key=True,
# upload="full64"), each checked exactly and shown to launch its own
# kernel; then a second static scan with the same key, which must run no
# nvcc. Every phase prints one line with its result and the elapsed
# seconds; any failure raises, so the exit code is non-zero. The last
# lines are the kernels' JSON line, the card's name and power limit, and
# {"ok": true, "device": ...}. A watchdog ends a hung run with a stack
# trace. Imports torch, numpy and cudasp_tpu_torch only.
import faulthandler

faulthandler.dump_traceback_later(1080, exit=True)

import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

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
LADDERS = ("fixed", "wnaf", "static")
# each ladder's main path: the ScanConfig fields and the wire they select
MAIN_PATHS = {"fixed": ({}, "x"), "wnaf": ({"ladder": "wnaf"}, "x"),
              "static": ({"static_key": True, "upload": "full64"}, "xy")}
KERNEL_NAMES = {"fixed": "scan_kernel", "wnaf": "scan_kernel_wnaf",
                "static": "scan_kernel_static"}
SOURCES = {"fixed": "cudasp_tpu_torch/csrc/scan.cu",
           "wnaf": "cudasp_tpu_torch/csrc/scan.cu",
           "static": "cudasp_tpu_torch/csrc/scan.cuh"}
REPLACES = {"fixed": "cudasp_tpu/ops/kernels.py:737",
            "wnaf": "cudasp_tpu/ops/kernels.py:514",
            "static": "cudasp_tpu/ops/kernels.py:543"}


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


def ptxas_summary(log):
    """Registers and stack of each scan_kernel instantiation in a ptxas -v
    log, by ladder functor name."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '(\S*scan_kernel\S*)'", ln)
        if m:
            cur = re.search(r"(Fixed|Wnaf|Key)Ladder", m.group(1)).group(0)
            continue
        if cur and "stack frame" in ln:
            out[cur] = ln.split(",")[0].strip()
        elif cur and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out[cur] = f"{regs} registers, {out.get(cur, '')}"
            cur = None
    return out


def pack_rows(table, rows, wire, live_rows=None):
    """The first `rows` rows of a table as device planes, the way the
    executor packs them. live_rows: rows past this index fall in
    blockmask-dead tiles."""
    import numpy as np

    from cudasp_tpu_torch.io import ingest
    from cudasp_tpu_torch.ops import kernels as K

    flat, offs = table["outputs"]
    b = next(ingest.iter_packed(table["tweak_key"][:rows], flat[:offs[rows]],
                                offs[:rows + 1], rows,
                                int(np.diff(offs[:rows + 1]).max())))
    planes = K.pack_batch_arrays(b.tweak_blobs, b.row_valid, b.outputs_hi,
                                 b.outputs_lo, b.outputs_valid,
                                 block_rows=BLOCK_ROWS, wire=wire)
    bmask = None
    if live_rows is not None:
        width = planes[0].shape[1]
        bmask = dev_tensor(K.live_blockmask(live_rows, width // BLOCK_ROWS,
                                            BLOCK_ROWS))
    return [dev_tensor(p) for p in planes], bmask


def dev_tensor(a):
    import numpy as np
    import torch

    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).cuda()


def query(key, spend, labels):
    """(ScanSchedule, spend, labels, comb) on the card."""
    from cudasp_tpu_torch.io import ingest
    from cudasp_tpu_torch.ops import kernels as K

    sched, sp, lab, _ = ingest.pack_query_keys(key, spend, labels)
    return sched, dev_tensor(sp), dev_tensor(lab), K.comb_table("cuda")


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


def compare(name, ladder, planes, bmask, q, wire, expect, pack_flags=False):
    """Kernel vs plain on the same device tensors. The comparison's own
    launch is taken back out of the kernel's launch count."""
    import torch

    from cudasp_tpu_torch.ops import kernels as K

    sched, sp, lab, comb = q
    digits, static = sched.operands(ladder)
    kern = K.KERNELS[ladder]
    launches = kern.launches
    kf = K.scan_flags(*planes, digits, sp, lab, comb, bmask,
                      block_rows=BLOCK_ROWS, wire=wire,
                      pack_flags=pack_flags, ladder=ladder,
                      static_sched=static)
    torch.cuda.synchronize()
    pf = K.scan_plain(*planes, digits, sp, lab, comb, bmask, wire=wire,
                      block_rows=BLOCK_ROWS, ladder=ladder,
                      static_sched=static)
    if pack_flags:
        pf = K.pack_flag_words(pf)
    kern.launches = launches
    return check(f"{name}/{ladder}/{wire}", kf, pf, planes[0].shape[1],
                 expect)


def golden_table(case):
    import numpy as np

    return {
        "tweak_key": np.stack([np.frombuffer(r.tweak_blob, np.uint8)
                               for r in case.rows]),
        "outputs": (np.concatenate([np.asarray(r.outputs, np.int64)
                                    for r in case.rows]),
                    np.cumsum([0] + [len(r.outputs) for r in case.rows])),
    }


def build_all(static_keys):
    """Every kernel library of the run, all nvcc builds started together:
    csrc/scan.cu (fixed + wnaf) and one static library per scan key.
    Returns {digest: seconds until its library was loaded}."""
    from cudasp_tpu_torch.ops import kernels as K
    from cudasp_tpu_torch.ops import scalar as S
    from cudasp_tpu_torch.oracle.encoding import blob32_to_scalar

    st = K.KERNELS["static"]
    scheds = {}
    for blob in static_keys:
        steps = S.glv_wnaf_static(blob32_to_scalar(blob))
        scheds[K.static_digest(steps)] = steps

    def one_static(steps):
        t0 = time.perf_counter()
        st.library(steps)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(scheds) + 1) as pool:
        fixed = pool.submit(K.KERNELS["fixed"].library)
        futs = {d: pool.submit(one_static, s) for d, s in scheds.items()}
        fixed.result()
        secs = {d: f.result() for d, f in futs.items()}
    K.KERNELS["wnaf"].library()          # the same library as fixed
    return secs


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

    smi = nvidia_smi()
    phase("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()} | nvidia-smi: {smi}")

    key, spend, table, planted = make_dataset(MAIN_ROWS, SEED)
    phase("dataset", f"{MAIN_ROWS} rows from {POOL} oracle points, "
          f"{len(planted)} planted")

    # --- builds: scan.cu and a static library per distinct key, at once --
    static_keys = sorted({c.scan_key_blob for c in V.CASES} | {key})
    t0 = time.perf_counter()
    static_secs = build_all(static_keys)
    fx = K.KERNELS["fixed"]
    bs = fx.build_seconds
    phase("build", "csrc/scan.cu (fixed + wnaf): "
          + ("cached" if bs is None else f"nvcc {bs:.1f} s") + " | "
          + " | ".join(f"{n}: {v}" for n, v in
                       ptxas_summary(fx.build_log).items()))
    st = K.KERNELS["static"]
    phase("build-static", f"{len(static_secs)} keys, {st.nvcc_runs} nvcc "
          f"builds: " + ", ".join(f"{d} {v:.1f} s" for d, v in
                                  static_secs.items())
          + f"; all builds {time.perf_counter() - t0:.1f} s | "
          + " | ".join(f"{n}: {v}" for n, v in
                       ptxas_summary(st.build_log).items()))
    static_runs = st.nvcc_runs

    # --- kernel vs plain on the card -------------------------------------
    mism = {ladder: 0 for ladder in LADDERS}
    max_err = {ladder: 0 for ladder in LADDERS}

    def tally(ladder, r):
        mism[ladder] += r[0]
        max_err[ladder] = max(max_err[ladder], r[1])

    for case in V.CASES:
        tab = golden_table(case)
        expect = {i for i, r in enumerate(case.rows)
                  if r.height in case.expected_heights}
        q = query(case.scan_key_blob, case.spend_blob, case.label_blobs)
        for wire in ("x", "xy"):
            planes, _ = pack_rows(tab, len(case.rows), wire)
            for ladder in LADDERS:
                tally(ladder, compare(case.name, ladder, planes, None, q,
                                      wire, expect))
    phase("golden", f"{len(V.CASES)} cases x 2 wires x {len(LADDERS)} "
          f"ladders, kernel == plain == expected")

    q = query(key, spend, ())
    exp_r = set(planted[planted < RANDOM_ROWS].tolist())
    live = 3 * BLOCK_ROWS + 17
    exp_live = {i for i in exp_r if i < 4 * BLOCK_ROWS}
    for wire in ("x", "xy"):
        planes, _ = pack_rows(table, RANDOM_ROWS, wire)
        for ladder in LADDERS:
            for pack in (False, True):
                tally(ladder, compare(f"random/packed={pack}", ladder,
                                      planes, None, q, wire, exp_r,
                                      pack_flags=pack))
    # blockmask: rows past `live` are in dead tiles and must flag 0
    planes, bmask = pack_rows(table, RANDOM_ROWS, "x", live_rows=live)
    for ladder in LADDERS:
        tally(ladder, compare("blockmask", ladder, planes, bmask, q, "x",
                              exp_live, pack_flags=True))
    phase("kernel-vs-plain", f"{RANDOM_ROWS} random rows (wires x/xy, "
          f"int8/packed flags, {len(exp_r)} planted) and a dead-tile batch, "
          f"each ladder: mismatches {mism}")

    # --- each ladder at the main path's launch shape, timed ---------------
    width = ct.api.TILE_CUDA
    exp_w = set(planted[planted < width].tolist())
    sched, sp, lab, comb = q
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    reps = 10
    timing = {}
    for wire in ("x", "xy"):
        planes, _ = pack_rows(table, width, wire)
        for ladder in LADDERS:
            t0 = time.perf_counter()
            digits, static = sched.operands(ladder)
            kern = K.KERNELS[ladder]
            launches = kern.launches

            def run():
                return K.scan_flags(*planes, digits, sp, lab, comb,
                                    pack_flags=True, wire=wire,
                                    ladder=ladder, static_sched=static)

            kf = run()
            ev[0].record()
            for _ in range(reps):
                run()
            ev[1].record()
            torch.cuda.synchronize()
            t = {"ms": ev[0].elapsed_time(ev[1]) / reps}
            if wire == MAIN_PATHS[ladder][1]:
                # the plain version once, on the main path's wire: its
                # time, its field products (the bound) and its flags
                F.PRODUCTS[0] = 0
                ev[0].record()
                pf = K.scan_plain(*planes, digits, sp, lab, comb, wire=wire,
                                  ladder=ladder, static_sched=static)
                ev[1].record()
                torch.cuda.synchronize()
                t["plain_ms"] = ev[0].elapsed_time(ev[1])
                products = F.PRODUCTS[0] / width
                tally(ladder, check(f"main-batch/{ladder}", kf,
                                    K.pack_flag_words(pf), width, exp_w))
                del pf
                nbytes = (sum(p.numel() * 4 for p in planes) + width // 8
                          + comb.numel() * 4 + sp.numel() * 4)
                ops = products * IMAD_PER_PRODUCT * width
                by_ops = ops / IMAD_PER_S > nbytes / HBM_BYTES_PER_S
                t.update(products=products, bound_by="operations" if by_ops
                         else "bytes", bound_ms=max(
                             nbytes / HBM_BYTES_PER_S, ops / IMAD_PER_S) * 1e3)
            kern.launches = launches
            timing[ladder, wire] = t
            phase("kernel-time", f"{ladder}/{wire}, {width} rows: kernel "
                  f"{t['ms']:.3f} ms ({width / t['ms'] * 1e3:,.0f} rows/s)"
                  + (f", plain {t['plain_ms']:.1f} ms, bound "
                     f"{t['bound_ms']:.3f} ms by {t['bound_by']} "
                     f"({t['products']:.0f} field products/row)"
                     if "plain_ms" in t else "")
                  + f" | {smi} [{time.perf_counter() - t0:.1f} s]")

    # --- the main paths ---------------------------------------------------
    head = {k: (v[:4096] if k != "outputs" else
                (v[0][:4096 * OUTPUTS_PER_ROW], v[1][:4097]))
            for k, v in table.items()}
    main_launches = {}
    for ladder in LADDERS:
        fields, wire = MAIN_PATHS[ladder]
        ct.scan(head, key, spend, config=ct.ScanConfig(**fields))  # warm-up
        for kern in K.KERNELS.values():
            kern.launches = 0
        t0 = time.perf_counter()
        res = ct.scan(table, key, spend, config=ct.ScanConfig(**fields))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {name: kern.launches for name, kern in K.KERNELS.items()}
        if not np.array_equal(res.indices, planted):
            raise AssertionError(
                f"main path {ladder}: {len(res.indices)} matches, expected "
                f"{len(planted)}; first differences "
                f"{np.setxor1d(res.indices, planted)[:10].tolist()}")
        if not np.array_equal(res.height, planted + 800_000):
            raise AssertionError(f"main path {ladder}: heights differ")
        if counts[ladder] <= 0 or any(
                n for other, n in counts.items() if other != ladder):
            raise AssertionError(f"main path {ladder}: launches {counts}")
        main_launches[ladder] = counts[ladder]
        m = res.metrics
        kms = timing[ladder, wire]["ms"]
        phase("main-path", f"ScanConfig({fields}): {MAIN_ROWS} rows in "
              f"{secs:.3f} s = {MAIN_ROWS / secs:,.0f} tx/s end to end; "
              f"{len(res.indices)} matches == planted; launches {counts}; "
              f"ladder {m.ladder}, upload {m.upload_mode}, {m.batch_size} "
              f"rows a launch; pack {m.pack_seconds:.3f} s, staging "
              f"{m.upload_seconds:.3f} s, device wait "
              f"{m.device_wait_seconds:.3f} s, {m.upload_bytes / 1e6:.1f} MB "
              f"up; kernel-only {width / kms * 1e3:,.0f} rows/s | {smi}")

    # --- the per-key cache: a second static scan with the key -------------
    res = ct.scan(head, key, spend,
                  config=ct.ScanConfig(**MAIN_PATHS["static"][0]))
    if st.nvcc_runs != static_runs:
        raise AssertionError(f"static scans after the build ran nvcc "
                             f"{st.nvcc_runs - static_runs} times")
    if not np.array_equal(res.indices, planted[planted < 4096]):
        raise AssertionError("second static scan: wrong matches")
    phase("static-cache", "warm-up, main path and a second static scan "
          "with the same key: 0 nvcc runs after the build")

    print(json.dumps({"kernels": [{
        "name": KERNEL_NAMES[ladder],
        "route": "cuda",
        "source": SOURCES[ladder],
        "replaces": REPLACES[ladder],
        "wire": MAIN_PATHS[ladder][1],
        "launches": main_launches[ladder],
        "mismatches": mism[ladder],
        "max_abs_err": max_err[ladder],
        "ms": timing[ladder, MAIN_PATHS[ladder][1]]["ms"],
        "ms_x": timing[ladder, "x"]["ms"],
        "ms_xy": timing[ladder, "xy"]["ms"],
        "plain_ms": timing[ladder, MAIN_PATHS[ladder][1]]["plain_ms"],
        "bound_ms": timing[ladder, MAIN_PATHS[ladder][1]]["bound_ms"],
        "bound_by": timing[ladder, MAIN_PATHS[ladder][1]]["bound_by"],
        "products_per_row": timing[ladder, MAIN_PATHS[ladder][1]][
            "products"],
        "library_ms": None,
    } for ladder in LADDERS]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
