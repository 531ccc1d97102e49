#!/usr/bin/env python3
# Smoke run of the PyTorch/CUDA port on one NVIDIA GPU:
#
#     python3 chip_smoke.py
#
# Builds the scan kernel's three ladders from cudasp_tpu_torch/csrc with
# nvcc, all builds started together: csrc/scan.cu ("fixed" and "wnaf"),
# one generated translation unit per scan key ("static"), csrc/probe.cu,
# scan.cu's seven SP_ABLATE variants, and csrc/pack.cpp with g++. Holds
# each ladder against its plain-torch version and the golden vectors on
# the card, on the exact wires and on the hi32 / hi16 / hi8 prefilter
# wires (K12, with outputs exact and corrupted below the cut: a superset
# of the exact flags), times each at the main path's launch width, then
# drives cudasp_tpu_torch.scan over a 2,300,000-row table (the
# reference's "2 weeks" table, 3 outputs a row, ~1% planted matches) four
# times:
# ScanConfig() (fixed ladder, upload "auto"), ScanConfig(ladder="wnaf"),
# ScanConfig(static_key=True, upload="full64") and ScanConfig(upload="hi8")
# (the cut, then the exact pass over the rows it flags), each checked
# exactly and shown to launch its own kernels; then a second static scan
# with the same key, which must run no nvcc. Then the reference's whole
# ScanConfig: tuning (the card's resolved runtime.tuning row,
# block_rows=None against ScanConfig() and the row's value on a golden
# case, and `python -m cudasp_tpu_torch.tools.autotune --dry-run --quick`
# in a subprocess, which must exit 0 and write nothing), xla-golden
# (every golden case through ScanConfig(backend="xla"), the XLA backend's
# torch pipeline, on the card with fused False and True: == expected ==
# the same scan on the CPU; an off-curve row that the pipeline does not
# match and the kernel does) and xla-main-path (the 2,300,000-row table
# through backend="xla": == planted == the kernel path's rows, no scan
# kernel launched; tx/s, metrics, peak memory, and one 262,144-row
# pipeline batch timed against one of 8,192 rows). After the builds it prints
# ptxas's registers, stack frame and spill bytes and cuobjdump's SASS
# counts (IMAD-family, IADD3, local loads and stores, calls) of every
# scan-kernel instantiation and of bench_kernel's field cases, and runs
# field-edges: fe_mul, fe_sqr, fe_add and fe_sub on the card over the
# crafted edge pairs and 2^20 random edge-biased pairs, each output's
# words held to the carry chains' algorithm on Python integers. It then
# holds the three probe kernels (csrc/probe.cu: alu_kernel, bench_kernel,
# stage_kernel) against their plain versions on the card, and drives the
# probe tools (cudasp_tpu_torch.tools.alu_probe, microbench,
# stage_profile) at the scan's launch width: the measured int32 multiply-add and field-product
# rates, and the scan kernel's per-stage budget. The sharded scan
# (ops.kernels.scan_flags_sharded: one launch of the same kernel per mesh
# entry) is held bit for bit against the single launch on every ladder
# and on the x, xy and hi8 wires, over a 4-entry mesh on cuda:0 (and over
# every card, where there are several), against its plain version at
# 4,096 lanes, and timed against the single launch; then the 2,300,000-row
# table is scanned over make_mesh() (every card), over the 4-entry mesh,
# over that mesh with the row exchange (rebalance=True) and on hi8, and a
# 20,000-row table by two processes on gloo (parallel.distributed.
# multihost_scan), each merge exact. The user surface follows: scan_stream
# over the 2,300,000 rows in 300,000-row chunks with a ScanCursor saved
# after each, killed after chunk 4 and resumed from the saved file in
# 250,000-row chunks (the cursor lands mid-chunk: exactly the planted
# rows with scan()'s columns, only the uncovered rows scanned), timed
# against scan(), and once over make_mesh(); SQLEngine() over the golden
# cases written as SQL and a 200,000-row CREATE TABLE AS ... FROM range
# table (== scan()); python -m cudasp_tpu_torch scan --metrics in a
# subprocess (Parquet with --stream where pyarrow imports, else JSONL),
# which must build nothing; a scan under CUDASP_PROFILE_DIR and
# CUDASP_METRICS=1 (the trace holds the executor's spans and the scan
# kernel's device event); and the main path with one batch's launch, then
# one batch's result, failing once (batch_retries == 1, exact), and a
# launch failing twice (ExecutionError names the batch). The host path:
# every scan packs its batches on the executor's feeder thread with the
# C packer (csrc/pack.cpp, built with g++ beside the nvcc builds), which
# native-pack holds word for word against the numpy packer on every
# upload mode at the launch width (1 thread and several, timed); every
# main path's line counts the packer's calls by thread; feeder injects a
# packing fault at batch 3 and a launch failing twice at batch 2 (each
# ExecutionError names its batch, no feeder thread stays alive), and ramp
# scans with CUDASP_RAMP=65536. The tools phase runs kernel_probe,
# h2d_probe, concurrency_probe, ablate_probe (its seven SP_ABLATE
# builds start with the others), scaling_probe, multihost_bench,
# seed_cache and first_contact, each with its own check. oracle-cli runs
# the port's oracle CLI in subprocesses (gen-vectors, its table scanned on
# the card by the CLI; compute-expected on a golden row), and bench-curve
# runs python -m cudasp_tpu_torch.tools.bench_curve at the reference's
# sizes (1M, 9.4M and 32.7M rows, and 1M with one label), each point a
# fresh bench process that checks every timed run's rows. Every phase
# prints one line with its result and the elapsed seconds; any failure
# raises, so the exit code is non-zero. The last lines are the kernels'
# JSON line, the card's name and power limit, and {"ok": true, "device":
# ...}. A watchdog ends a hung run with a stack trace. Imports torch,
# numpy, cudasp_tpu_torch and, for the CLI's Parquet input where it is
# installed, pyarrow.
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
# clock per SM: 132 SMs x 64 x 1.98 GHz), so its peak is taken as
# 16.75 T multiply-adds/s. The probe-time phase prints the rate that
# tools/alu_probe's int32 mul+add reaches beside it, with the SM clock
# under that load: a finding, not the bound.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 33.5e12 / 2
# a 256-bit field product on the card: 64 32x32->64-bit multiply-adds for
# the schoolbook, 8 more for the fold by 977; a square: its 28 cross
# products once and its 8 squares (36), and the same fold (44). Until
# squares were counted apart, every square was priced as a product: the
# "bound_ms_products_only" numbers keep that bound beside the new one.
IMAD_PER_PRODUCT = 72
IMAD_PER_SQUARE = 44
LADDERS = ("fixed", "wnaf", "static")
# the probe kernels: the case each one's JSON entry times at the scan's
# launch width, and its repeat count there (the plain version runs the
# same launch on the card)
PROBE_ENTRIES = {"alu_kernel": ("alu", "int32 mul+add", 1024),
                 "bench_kernel": ("bench", "field mul", 256),
                 "stage_kernel": ("stage", "ladder window", 4)}
PROBE_REPLACES = {"alu_kernel": "tools/alu_probe.py:26",
                  "bench_kernel": "tools/microbench.py:27",
                  "stage_kernel": "tools/stage_profile.py:53"}
PROBE_LANES = 4096
CUTS = ("hi32", "hi16", "hi8")
# the bits below each cut, flipped in the corrupted-outputs variant: a cut
# still flags such a row, the exact wire does not
BELOW_CUT = {"hi32": 0x5A5A5A5A, "hi16": 0x5A5A5A5A5A5A,
             "hi8": 0x5A5A5A5A5A5A5A}
# each main path: the ScanConfig fields, the ladder and the wire of its
# kernel (K12, the cut wires, runs on the fixed ladder's kernel)
MAIN_PATHS = {"fixed": ({}, "fixed", "x"),
              "wnaf": ({"ladder": "wnaf"}, "wnaf", "x"),
              "static": ({"static_key": True, "upload": "full64"}, "static",
                         "xy"),
              "hi": ({"upload": "hi8"}, "fixed", "hi8")}
KERNEL_NAMES = {"fixed": "scan_kernel", "wnaf": "scan_kernel_wnaf",
                "static": "scan_kernel_static", "hi": "scan_kernel_hi"}
SOURCES = {"fixed": "cudasp_tpu_torch/csrc/scan.cu",
           "wnaf": "cudasp_tpu_torch/csrc/scan.cu",
           "static": "cudasp_tpu_torch/csrc/scan.cuh",
           "hi": "cudasp_tpu_torch/csrc/scan.cu"}
REPLACES = {"fixed": "cudasp_tpu/ops/kernels.py:737",
            "wnaf": "cudasp_tpu/ops/kernels.py:514",
            "static": "cudasp_tpu/ops/kernels.py:543",
            "hi": "cudasp_tpu/ops/kernels.py:428"}


def reset_field_counts():
    from cudasp_tpu_torch.ops import field as F

    F.PRODUCTS[0] = F.SQUARES[0] = 0


def field_counts():
    """(products, squares) the plain version made since
    reset_field_counts()."""
    from cudasp_tpu_torch.ops import field as F

    return F.PRODUCTS[0], F.SQUARES[0]


def imad_bounds(products, squares):
    """(multiply-adds of the work, the same priced at a product each)."""
    return (products * IMAD_PER_PRODUCT + squares * IMAD_PER_SQUARE,
            (products + squares) * IMAD_PER_PRODUCT)


def phase(name, result):
    print(f"[{name}] {result} ({time.perf_counter() - T0:.1f} s)",
          flush=True)


def nvidia_smi(query="name,power.limit"):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sm_clock_under_load(x_alu):
    """nvidia-smi's SM clock and maximum SM clock, read while the card
    runs a queue of int32 mul+add probe launches (about a second of
    work). The launches are taken back out of the count."""
    import torch

    from cudasp_tpu_torch.ops import probes as P

    n = P.PROBES.launches["alu_kernel"]
    op = P.ALU_OPS.index("int32 mul+add")
    for _ in range(40):
        P.alu(x_alu, op, 1 << 16)
    clocks = nvidia_smi("clocks.sm,clocks.max.sm")
    torch.cuda.synchronize()
    P.PROBES.launches["alu_kernel"] = n
    return clocks


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


def ptxas_text(info):
    """ptxas -v's registers, stack frame and spill bytes of each scan
    kernel instantiation and device function (kernels.ptxas_info)."""
    return " | ".join(
        f"{n}: " + (f"{v['registers']} registers, " if "registers" in v
                    else "")
        + f"{v.get('stack')} B stack frame, {v.get('spill_stores')} / "
        f"{v.get('spill_loads')} B spill stores / loads"
        for n, v in info.items())


def sass_text(counts):
    return " | ".join(
        f"{n}: IMAD {c['IMAD']} (WIDE {c['IMAD.WIDE']}, HI {c['IMAD.HI']}, "
        f"X {c['IMAD.X']}, MOV {c['IMAD.MOV']}), IADD3 {c['IADD3']}, LDL "
        f"{c['LDL']}, STL {c['STL']}, CALL {c['CALL']}, {c['all']} "
        f"instructions" for n, c in counts.items())


# field-edges: crafted values (the edges of p and 2^256, all-ones and
# all-zero halves, multiples of 2^32 + 977, values in [p, 2^256)) and the
# words random edge-biased values are drawn from
P_INT = 2**256 - 2**32 - 977
FOLD = 2**32 + 977
W256 = 2**256
CRAFTED = [0, 1, 2, 3, 977, FOLD, P_INT - 1, P_INT, P_INT + 1, P_INT + 2,
           P_INT + 976, W256 - 1, W256 - 2, W256 - 2**32, P_INT + 0x12345,
           2**255, 2**255 - 1, 2**128 - 1, W256 - 2**128, 2**128,
           (2**128 - 1) << 64, 2**224 - 1, 0xFFFFFFFF << 224, FOLD * 7,
           FOLD * (2**200 + 12345), FOLD * ((W256 - 1) // FOLD),
           (P_INT + W256) // 2,
           0x5555555555555555 * (2**192 + 2**128 + 2**64 + 1),
           0xAAAAAAAAAAAAAAAA * (2**192 + 2**128 + 2**64 + 1),
           int("7" * 64, 16)]
WORD_PICKS = (0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF)
FIELD_EDGE_PAIRS = 1 << 20


def field_model(op, a, b):
    """The words the card's fe_mul / fe_sqr / fe_add / fe_sub leave, on
    Python integers: the carry chains' algorithm (a product or sum folded
    by 2^256 == 2^32 + 977 until it is below 2^256; a difference's borrow
    taken back out as 2^256 - 2^32 - 977, twice at most)."""
    if op == "sub":
        r = a - b
        for _ in range(2):
            if r < 0:
                r += W256 - FOLD
        return r
    r = {"mul": a * b, "sqr": a * a, "add": a + b}[op]
    for _ in range(3):
        r = r % W256 + (r >> 256) * FOLD
    return r


def field_edges(device):
    """fe_mul, fe_sqr, fe_add and fe_sub on the card (probe.cu's
    field_kernel, one op a lane): every pair of the 30 crafted values and
    FIELD_EDGE_PAIRS random pairs whose words are WORD_PICKS or uniform;
    each output's words must equal field_model's, whose value is checked
    against the op mod p. Returns (pairs, mismatches); raises on one."""
    import numpy as np
    import torch

    from cudasp_tpu_torch.ops import probes as P

    def words(vals):
        return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                         for v in vals], np.uint32)

    rng = np.random.default_rng(SEED + 2)
    n = len(CRAFTED)
    a = [words(CRAFTED).repeat(n, axis=0)]
    b = [np.tile(words(CRAFTED), (n, 1))]
    for dst in (a, b):
        pick = rng.integers(0, len(WORD_PICKS) + 1, size=(FIELD_EDGE_PAIRS,
                                                          8))
        uni = rng.integers(0, 2**32, size=pick.shape, dtype=np.uint64)
        dst.append(np.where(pick < len(WORD_PICKS), np.asarray(
            WORD_PICKS + (0,), np.uint64)[pick], uni).astype(np.uint32))
    a, b = np.concatenate(a), np.concatenate(b)

    def ints(w):
        return [int.from_bytes(row.tobytes(), "little") for row in w]

    ia, ib = ints(a), ints(b)
    xa, xb = (torch.from_numpy(np.ascontiguousarray(w.T).view(np.int32))
              .to(device) for w in (a, b))
    bad = 0
    for k, op in enumerate(P.FIELD_OPS):
        out = P.field_op(xa, xb, k)
        got = ints(np.ascontiguousarray(out.cpu().numpy().view(np.uint32).T))
        for g, u, v in zip(got, ia, ib):
            if g != field_model(op, u, v):
                bad += 1
        # the model itself: the op's value mod p, below 2^256
        for u, v in zip(ia[:n * n], ib[:n * n]):
            r = field_model(op, u, v)
            want = {"mul": u * v, "sqr": u * u, "add": u + v,
                    "sub": u - v}[op]
            assert 0 <= r < W256 and r % P_INT == want % P_INT, (op, u, v)
    if bad:
        raise AssertionError(f"field-edges: {bad} outputs differ from the "
                             f"carry chains' algorithm on Python integers")
    return len(ia), bad


def probe_ptxas(log):
    """The most registers and stack of any instantiation of each probe
    kernel in a ptxas -v log."""
    out, cur, stack = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"entry function '\S*?(alu|bench|stage)_kernel", ln)
        if m:
            cur, stack = m.group(1) + "_kernel", 0
            continue
        if cur and "stack frame" in ln:
            stack = int(ln.split()[0])
        elif cur and "Used" in ln and "registers" in ln:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            r0, s0 = out.get(cur, (0, 0))
            out[cur] = (max(r0, regs), max(s0, stack))
            cur = None
    return {k: f"<= {r} registers, <= {st} B stack"
            for k, (r, st) in out.items()}


def pack_rows(table, rows, wire, live_rows=None, hi_only=None,
              below=0, block_rows=BLOCK_ROWS):
    """The first `rows` rows of a table as device planes, the way the
    executor packs them, on the x / xy wire or a cut (hi_only). live_rows:
    rows past this index fall in blockmask-dead tiles. below: a mask
    XORed into every output value first."""
    import numpy as np

    from cudasp_tpu_torch.io import ingest
    from cudasp_tpu_torch.ops import kernels as K

    flat, offs = table["outputs"]
    b = next(ingest.iter_packed(table["tweak_key"][:rows],
                                flat[:offs[rows]] ^ np.int64(below),
                                offs[:rows + 1], rows,
                                int(np.diff(offs[:rows + 1]).max())))
    planes = K.pack_batch_arrays(b.tweak_blobs, b.row_valid, b.outputs_hi,
                                 b.outputs_lo, b.outputs_valid,
                                 block_rows=block_rows, wire=wire,
                                 hi_only=hi_only)
    bmask = None
    if live_rows is not None:
        width = planes[0].shape[1]
        bmask = dev_tensor(K.live_blockmask(live_rows, width // block_rows,
                                            block_rows))
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


def check(name, kf, pf, width, expect, superset=False):
    """Kernel flags vs plain flags (same layout) bit for bit, and both vs
    `expect`, a set of row indices: equal, or (a cut wire, superset=True)
    containing it. Returns (mismatches, max |kernel - plain|, rows
    flagged)."""
    import numpy as np

    from cudasp_tpu_torch.ops import kernels as K

    kb = K.flags_to_bool(kf.cpu().numpy(), width)
    pb = K.flags_to_bool(pf.cpu().numpy(), width)
    diff = np.abs(kb.astype(np.int64) - pb.astype(np.int64))
    mism, err = int(diff.sum()), int(diff.max(initial=0))
    got = set(np.flatnonzero(kb).tolist())
    ok = got >= set(expect) if superset else got == set(expect)
    if mism or not ok:
        raise AssertionError(
            f"{name}: kernel {sorted(got)[:10]} plain "
            f"{np.flatnonzero(pb)[:10].tolist()} expected "
            f"{sorted(expect)[:10]} ({mism} mismatches)")
    return mism, err, len(got)


def compare(name, ladder, planes, bmask, q, wire, expect, pack_flags=False,
            hi_only=None, nout=None, plain=None):
    """Kernel vs plain on the same device tensors, on the x / xy wire or a
    cut (hi_only, whose flags need only contain `expect`). The
    comparison's own launch is taken back out of the kernel's counts.
    plain: a dict that keeps the first plain flags computed and serves
    them to the next call with it (the golden cases: the fixed ladder's
    plain version once per case and wire; every ladder's plain version
    computes the same flags, and kernel-vs-plain holds each ladder's own
    on random rows)."""
    import torch

    from cudasp_tpu_torch.ops import kernels as K

    sched, sp, lab, comb = q
    digits, static = sched.operands(ladder)
    kern = K.KERNELS[ladder]
    counts = kern.launches, kern.hi_launches
    kf = K.scan_flags(*planes, digits, sp, lab, comb, bmask,
                      block_rows=BLOCK_ROWS, wire=wire,
                      pack_flags=pack_flags, ladder=ladder,
                      static_sched=static, hi_only=hi_only, nout=nout)
    torch.cuda.synchronize()
    if plain is not None and "flags" in plain:
        pf = plain["flags"]
    else:
        pf = K.scan_plain(*planes, digits, sp, lab, comb, bmask, wire=wire,
                          block_rows=BLOCK_ROWS, ladder=ladder,
                          static_sched=static, hi_only=hi_only, nout=nout)
        if pack_flags:
            pf = K.pack_flag_words(pf)
        if plain is not None:
            plain["flags"] = pf
    kern.launches, kern.hi_launches = counts
    return check(f"{name}/{ladder}/{hi_only or wire}", kf, pf,
                 planes[0].shape[1], expect, superset=hi_only is not None)


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
    """Every library of the run, all builds started together: csrc/scan.cu
    (fixed + wnaf), csrc/probe.cu, one static library per scan key, the
    seven SP_ABLATE variants of scan.cu (ablate_probe's), each with nvcc,
    and the host packer csrc/pack.cpp with g++. Returns ({digest: seconds
    until its static library was loaded}, {stage: seconds until its
    ablated library was loaded}, seconds of the packer's build)."""
    from cudasp_tpu_torch.io import native
    from cudasp_tpu_torch.ops import kernels as K
    from cudasp_tpu_torch.ops import probes as P
    from cudasp_tpu_torch.ops import scalar as S
    from cudasp_tpu_torch.oracle.encoding import blob32_to_scalar

    st = K.KERNELS["static"]
    scheds = {}
    for blob in static_keys:
        steps = S.glv_wnaf_static(blob32_to_scalar(blob))
        scheds[K.static_digest(steps)] = steps

    def timed(fn, *a):
        t0 = time.perf_counter()
        fn(*a)
        return time.perf_counter() - t0

    stages = {name: K.ablated_kernel(1 << i)
              for i, name in enumerate(K.ABLATE_STAGES)}
    with ThreadPoolExecutor(len(scheds) + len(stages) + 3) as pool:
        fixed = pool.submit(K.KERNELS["fixed"].library)
        probe = pool.submit(P.PROBES.library)
        packer = pool.submit(timed, native.library)
        futs = {d: pool.submit(timed, st.library, s)
                for d, s in scheds.items()}
        abl = {n: pool.submit(timed, k.library) for n, k in stages.items()}
        fixed.result()
        probe.result()
        secs = {d: f.result() for d, f in futs.items()}
        abl_secs = {n: f.result() for n, f in abl.items()}
        pack_secs = packer.result()
    K.KERNELS["wnaf"].library()          # the same library as fixed
    return secs, abl_secs, pack_secs


def probe_vs_plain(device, comb, lanes, repeats):
    """Every case of each probe kernel against its plain version on the
    card, on `lanes` lanes at each of `repeats` (field inv: 1), with 0
    mismatches required. The comparison's launches are taken back out of
    the kernels' counts. Returns {kernel: (mismatches, max |kernel -
    plain|, cases)}."""
    import numpy as np
    import torch

    from cudasp_tpu_torch.ops import probes as P

    counts = dict(P.PROBES.launches)
    rng = np.random.default_rng(SEED + lanes)
    x_alu = P.to_device(P.raw_planes(rng, (8, lanes // 8), low=1), device)
    raw = [P.to_device(P.raw_planes(rng, (8, lanes)), device)
           for _ in "xy"]
    fld = [P.to_device(P.field_planes(rng, lanes), device) for _ in "xy"]
    res = {k: [0, 0, 0] for k in P.ProbeLibrary.KERNEL_NAMES}

    def tally(kernel, name, iters, kout, pout):
        torch.cuda.synchronize()
        d = (kout.long() - pout.long()).abs()
        mism = int((d != 0).sum())
        if mism:
            raise AssertionError(f"{kernel}/{name}/{iters} iters: {mism} "
                                 f"mismatches of {d.numel()}")
        r = res[kernel]
        r[1] = max(r[1], int(d.max()))
        r[2] += 1

    for op, name in enumerate(P.ALU_OPS):
        for it in repeats:
            tally("alu_kernel", name, it, P.alu(x_alu, op, it),
                  P.alu_plain(x_alu, op, it))
    for case, (name, is_raw, _) in enumerate(P.BENCH_CASES):
        x, y = raw if is_raw else fld
        for it in (1,) if name.startswith("field inv") else repeats:
            tally("bench_kernel", name, it, P.bench(x, y, case, it),
                  P.bench_plain(x, y, case, it))
    for index, name in enumerate(P.STAGES):
        for it in repeats:
            tally("stage_kernel", name, it,
                  P.stage(*fld, index, it, comb),
                  P.stage_plain(*fld, index, it, comb))
    P.PROBES.launches.update(counts)
    return res


def probe_entries(device, comb):
    """Each probe kernel's JSON numbers: its PROBE_ENTRIES case at the
    scan's launch width, timed (CUDA events, best of 5) and held against
    the plain version's run of the same launch on the card, whose field
    products give the bound. The launches made here are taken back out
    of the counts."""
    import numpy as np
    import torch

    import cudasp_tpu_torch as ct
    from cudasp_tpu_torch.ops import probes as P

    counts = dict(P.PROBES.launches)
    width = ct.api.TILE_CUDA
    rng = np.random.default_rng(SEED + 1)
    fld = [P.to_device(P.field_planes(rng, width), device) for _ in "xy"]
    x_alu = P.to_device(P.raw_planes(rng, (8, width // 8), low=1), device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    out = {}
    for kernel, (kind, case, iters) in PROBE_ENTRIES.items():
        plane_bytes = fld[0].numel() * 4
        if kind == "alu":
            kern, plain, nbytes = P.alu, P.alu_plain, 2 * x_alu.numel() * 4
            args = (x_alu, P.ALU_OPS.index(case), iters)
        elif kind == "bench":
            kern, plain, nbytes = P.bench, P.bench_plain, 3 * plane_bytes
            args = (*fld, P.BENCH_NAMES.index(case), iters)
        else:
            kern, plain = P.stage, P.stage_plain
            nbytes = 3 * plane_bytes + comb.numel() * 4
            args = (*fld, P.STAGES.index(case), iters, comb)
        ms = P.best_ms(lambda: kern(*args), device, 5)
        kout = kern(*args)
        reset_field_counts()
        ev[0].record()
        pout = plain(*args)
        ev[1].record()
        torch.cuda.synchronize()
        plain_ms = ev[0].elapsed_time(ev[1])
        d = (kout.long() - pout.long()).abs()
        if int((d != 0).sum()):
            raise AssertionError(f"{kernel}/{case} at {width} lanes: "
                                 f"{int((d != 0).sum())} mismatches")
        # the ALU probe's bound is the multiply-add peak itself
        products, squares = field_counts()
        ops, ops_old = ((P.NSTREAMS * x_alu.numel() * iters,) * 2
                        if kind == "alu" else imad_bounds(products, squares))
        by_ops = ops / IMAD_PER_S > nbytes / HBM_BYTES_PER_S
        out[kernel] = {
            "case": case, "lanes": width, "iters": iters, "ms": ms,
            "plain_ms": plain_ms, "max_abs_err": int(d.max()),
            "bound_ms": max(ops / IMAD_PER_S,
                            nbytes / HBM_BYTES_PER_S) * 1e3,
            "bound_ms_products_only": max(ops_old / IMAD_PER_S,
                                          nbytes / HBM_BYTES_PER_S) * 1e3,
            "bound_by": "operations" if by_ops else "bytes",
            "products": None if kind == "alu" else products,
            "squares": None if kind == "alu" else squares}
        del kout, pout, d
    P.PROBES.launches.update(counts)
    return out


def golden_wide(case, width):
    """`width` rows cycling through a golden case's rows (so that every
    shard of a mesh has live rows), and the set of rows that match."""
    import dataclasses

    rows = [case.rows[j % len(case.rows)] for j in range(width)]
    tab = golden_table(dataclasses.replace(case, rows=tuple(rows)))
    expect = {j for j, r in enumerate(rows)
              if r.height in case.expected_heights}
    return tab, expect


def sharded_plain(mesh, planes, bmask, q, ladder, wire, hi_only=None,
                  nout=None, block_rows=BLOCK_ROWS):
    """The sharded scan's plain version on the card: scan_plain over each
    entry's lane shard (cut dummies replicated), flags in lane order."""
    import torch

    from cudasp_tpu_torch.ops import kernels as K
    from cudasp_tpu_torch.parallel.mesh import BatchShardings

    sched, sp, lab, comb = q
    digits, static = sched.operands(ladder)
    sh = BatchShardings(mesh)
    tw, oh = sh.lanes(planes[0]), sh.lanes(planes[1])
    ol = sh.lanes(planes[2]) if not hi_only else [planes[2]] * mesh.size
    ovm = (sh.lanes(planes[3]) if hi_only not in K.HI_UNITS
           else [planes[3]] * mesh.size)
    bm = [None] * mesh.size if bmask is None else sh.lanes(bmask)
    return torch.cat([K.scan_plain(
        tw[k], oh[k], ol[k], ovm[k], digits, sp, lab, comb, bm[k],
        wire=wire, block_rows=block_rows, ladder=ladder,
        static_sched=static, hi_only=hi_only, nout=nout)
        for k in range(mesh.size)], dim=1)


def sharded_vs_single(name, mesh, ladder, planes, bmask, q, wire, expect,
                      hi_only=None, nout=None, pack_flags=True,
                      block_rows=BLOCK_ROWS):
    """scan_flags_sharded over `mesh` against the single launch on the same
    device tensors: the raw flags (packed words or int8) bit for bit, and
    their rows == `expect` (a cut: containing it). The launches made here
    are taken back out of the counts. Returns (mismatched rows, rows
    flagged)."""
    import numpy as np
    import torch

    from cudasp_tpu_torch.ops import kernels as K

    sched, sp, lab, comb = q
    digits, static = sched.operands(ladder)
    kern = K.KERNELS[ladder]
    counts = kern.launches, kern.hi_launches, K.SHARDED.launches
    kw = dict(block_rows=block_rows, wire=wire, pack_flags=pack_flags,
              ladder=ladder, static_sched=static, hi_only=hi_only, nout=nout)
    single = K.scan_flags(*planes, digits, sp, lab, comb, bmask, **kw)
    shard = K.scan_flags_sharded(mesh, *planes, digits, sp, lab, comb, bmask,
                                 **kw)
    torch.cuda.synchronize()
    kern.launches, kern.hi_launches, K.SHARDED.launches = counts
    width = planes[0].shape[1]
    sb = K.flags_to_bool(shard.cpu().numpy(), width)
    mism = int((sb != K.flags_to_bool(single.cpu().numpy(), width)).sum())
    got = set(np.flatnonzero(sb).tolist())
    if mism or shard.dtype != single.dtype or not torch.equal(shard, single) \
            or not (got >= set(expect) if hi_only else got == set(expect)):
        raise AssertionError(
            f"sharded {name}/{ladder}/{hi_only or wire}: {mism} rows differ "
            f"from the single launch; rows {sorted(got)[:10]}, expected "
            f"{sorted(expect)[:10]}")
    return mism, len(got)


def sync_all():
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def wall_ms(fn, reps=10):
    """ms a call of fn by the host clock around `reps` calls that end in
    synchronising every card (after one untimed call)."""
    fn()
    sync_all()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync_all()
    return (time.perf_counter() - t0) / reps * 1e3


def sharded_phase(table, planted, key, spend, smi):
    """sharded-vs-single: every ladder on the x, xy and hi8 wires, on the
    golden cases (1,024 lanes) and on the main path's 262,144-row random
    batch, a 4-entry mesh on cuda:0 (and the all-cards mesh where there
    are several cards) against the single launch; a shard width that
    reads int8 flags; the kernel against its plain version at 4,096 lanes
    with a dead shard; and the 262,144-row batch timed, sharded against
    single, with the plain version's time and products. Returns the JSON
    numbers of the sharded scan."""
    import numpy as np
    import torch

    import cudasp_tpu_torch as ct
    from cudasp_tpu_torch.ops import kernels as K
    from cudasp_tpu_torch.oracle import vectors as V
    from cudasp_tpu_torch.parallel.mesh import BatchShardings, make_mesh

    t0 = time.perf_counter()
    mesh4 = make_mesh(devices=["cuda:0"] * 4)
    meshes = [mesh4] + ([make_mesh()] if torch.cuda.device_count() > 1
                        else [])
    wires = (("x", None), ("xy", None), ("x", "hi8"))
    checks = 0
    for case in V.CASES:
        tab, expect = golden_wide(case, 1024)
        q = query(case.scan_key_blob, case.spend_blob, case.label_blobs)
        nout = int(np.diff(tab["outputs"][1]).max())
        for wire, hi in wires:
            planes, _ = pack_rows(tab, 1024, wire, hi_only=hi)
            for ladder in LADDERS:
                for mesh in meshes:
                    sharded_vs_single(case.name, mesh, ladder, planes, None,
                                      q, wire, expect, hi_only=hi,
                                      nout=nout)
                    checks += 1
    width = ct.api.TILE_CUDA
    q = query(key, spend, ())
    exp_w = set(planted[planted < width].tolist())
    flagged = {}
    for wire, hi in wires:
        planes, _ = pack_rows(table, width, wire, hi_only=hi)
        for ladder in LADDERS:
            for mesh in meshes:
                _, n = sharded_vs_single("random", mesh, ladder, planes, None,
                                         q, wire, exp_w, hi_only=hi,
                                         nout=OUTPUTS_PER_ROW)
                checks += 1
            flagged[f"{ladder}/{hi or wire}"] = n
        del planes
    # shards of 240 lanes (not a multiple of 32): int8 flags; tiles of 48
    # rows from row 912 on are dead
    planes, bmask = pack_rows(table, 960, "x", live_rows=900, block_rows=48)
    exp_i8 = set(planted[planted < 912].tolist())
    for ladder in LADDERS:
        sharded_vs_single("int8", mesh4, ladder, planes, bmask, q, "x",
                          exp_i8, pack_flags=False, block_rows=48)
        checks += 1
    phase("sharded-vs-single", f"{checks} comparisons over "
          f"{[str(m) for m in meshes]}: golden cases x {len(LADDERS)} "
          f"ladders x wires x/xy/hi8 at 1,024 lanes, the {width}-row batch "
          f"(rows flagged {flagged}), 240-lane int8 shards: 0 rows differ "
          f"from the single launch [{time.perf_counter() - t0:.1f} s]")

    # the kernel against its plain version at 4,096 lanes: tiles from row
    # 2,816 on are dead, so the last of the four shards is all padding and
    # the third has a dead tile
    t0 = time.perf_counter()
    planes, bmask = pack_rows(table, PROBE_LANES, "x", live_rows=2600)
    exp_p = set(planted[planted < 11 * BLOCK_ROWS].tolist())
    mism = err = 0
    for ladder in LADDERS:
        for hi in (None, "hi8") if ladder == "fixed" else (None,):
            p = (pack_rows(table, PROBE_LANES, "x", hi_only=hi)[0] if hi
                 else planes)
            kern = K.KERNELS[ladder]
            counts = kern.launches, kern.hi_launches, K.SHARDED.launches
            sched, sp, lab, comb = q
            digits, static = sched.operands(ladder)
            kf = K.scan_flags_sharded(
                mesh4, *p, digits, sp, lab, comb, bmask, pack_flags=True,
                ladder=ladder, static_sched=static, hi_only=hi,
                nout=OUTPUTS_PER_ROW)
            torch.cuda.synchronize()
            kern.launches, kern.hi_launches, K.SHARDED.launches = counts
            pf = sharded_plain(mesh4, p, bmask, q, ladder, "x", hi_only=hi,
                               nout=OUTPUTS_PER_ROW)
            r = check(f"sharded-plain/{ladder}/{hi or 'x'}", kf,
                      K.pack_flag_words(pf), PROBE_LANES, exp_p,
                      superset=hi is not None)
            mism, err = mism + r[0], max(err, r[1])
    phase("sharded-vs-plain", f"{PROBE_LANES} lanes over {mesh4}, a dead "
          f"shard, every ladder (fixed also on hi8): kernel == plain, "
          f"mismatches {mism} [{time.perf_counter() - t0:.1f} s]")

    # time: the 262,144-row batch, single launch against sharded, in turns
    t0 = time.perf_counter()
    planes, _ = pack_rows(table, width, "x")
    sched, sp, lab, comb = q
    digits, _ = sched.operands("fixed")
    kern = K.KERNELS["fixed"]
    counts = kern.launches, kern.hi_launches, K.SHARDED.launches
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    reps = 10

    def timed(fn):
        fn()
        ev[0].record()
        for _ in range(reps):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / reps

    def single():
        return K.scan_flags(*planes, digits, sp, lab, comb, pack_flags=True)

    def sharded():
        return K.scan_flags_sharded(mesh4, *planes, digits, sp, lab, comb,
                                    pack_flags=True)

    runs = {"single": [], "sharded": []}
    for which in ("single", "sharded", "sharded", "single"):
        runs[which].append(timed(single if which == "single" else sharded))
    all_cards = None
    if len(meshes) > 1:
        # over every card: the shards already on their cards; events do
        # not span cards, so the host clock around work that ends in
        # synchronising every card, in turns with the single launch
        mesh_all = meshes[1]
        sh = BatchShardings(mesh_all)
        shards = [sh.lanes(p) for p in planes]
        rep = [sh.replicated(x) for x in (sp, lab, comb)]
        runs_all = {"single": [], "sharded": []}
        for which in ("single", "sharded", "sharded", "single"):
            runs_all[which].append(wall_ms(
                single if which == "single" else
                lambda: K.scan_flags_sharded(mesh_all, *shards, digits, *rep,
                                             pack_flags=True)))
        all_cards = {"cards": mesh_all.size,
                     "ms": float(np.mean(runs_all["sharded"])),
                     "single_ms": float(np.mean(runs_all["single"])),
                     "runs_ms": runs_all}
        phase("sharded-time", f"fixed/x, {width} rows over {mesh_all}, "
              f"shards on their cards, host clock: sharded "
              f"{all_cards['ms']:.3f} ms against the single launch "
              f"{all_cards['single_ms']:.3f} ms ({runs_all}), speedup "
              f"{all_cards['single_ms'] / all_cards['ms']:.3f} | {smi}")
        del shards, rep
    kf = sharded()
    torch.cuda.synchronize()
    kern.launches, kern.hi_launches, K.SHARDED.launches = counts
    reset_field_counts()
    ev[0].record()
    pf = sharded_plain(mesh4, planes, None, q, "fixed", "x")
    ev[1].record()
    torch.cuda.synchronize()
    plain_ms = ev[0].elapsed_time(ev[1])
    products, squares = field_counts()
    r = check("sharded-main-batch/fixed/x", kf, K.pack_flag_words(pf), width,
              exp_w)
    mism, err = mism + r[0], max(err, r[1])
    del pf
    nbytes = (sum(p.numel() * 4 for p in planes) + width // 8
              + mesh4.size * (comb.numel() * 4 + sp.numel() * 4))
    ops, ops_old = imad_bounds(products, squares)
    by_ops = ops / IMAD_PER_S > nbytes / HBM_BYTES_PER_S
    out = {"ms": float(np.mean(runs["sharded"])),
           "single_ms": float(np.mean(runs["single"])),
           "runs_ms": runs, "plain_ms": plain_ms,
           "products_per_row": products / width,
           "squares_per_row": squares / width,
           "bound_ms": max(ops / IMAD_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
           "bound_ms_products_only": max(ops_old / IMAD_PER_S,
                                         nbytes / HBM_BYTES_PER_S) * 1e3,
           "bound_by": "operations" if by_ops else "bytes",
           "mismatches": mism, "max_abs_err": err, "checks": checks,
           "all_cards": all_cards}
    phase("sharded-time", f"fixed/x, {width} rows over {mesh4}: sharded "
          f"{out['ms']:.3f} ms ({runs['sharded']}) against the single "
          f"launch {out['single_ms']:.3f} ms ({runs['single']}), ratio "
          f"{out['ms'] / out['single_ms']:.4f}; plain fan-out "
          f"{plain_ms:.1f} ms, {out['products_per_row']:.0f} field products "
          f"and {out['squares_per_row']:.0f} squares a row, bound "
          f"{out['bound_ms']:.3f} ms by {out['bound_by']} (products only: "
          f"{out['bound_ms_products_only']:.3f}) | "
          f"{smi} [{time.perf_counter() - t0:.1f} s]")
    return out


def mesh_main_paths(table, planted, key, spend, calls, smi):
    """mesh-main-path: the 2,300,000-row table over make_mesh() (every
    card), over 4 entries on cuda:0, that mesh with rebalance=True, and
    on hi8; each must return exactly the planted rows through the sharded
    scan, with the counts set to 0 just before each scan and read just
    after; with several cards, over every card also with rebalance=True
    and on hi8; and the exchange alone at the main batch shape. Returns
    ({path: sharded launches}, exchange timing)."""
    import numpy as np
    import torch

    import cudasp_tpu_torch as ct
    from cudasp_tpu_torch.ops import kernels as K
    from cudasp_tpu_torch.parallel.mesh import make_mesh

    ncards = torch.cuda.device_count()
    mesh4 = make_mesh(devices=["cuda:0"] * 4)
    paths = {"all-cards": dict(mesh=make_mesh()),
             "mesh4": dict(mesh=mesh4),
             "mesh4-rebalance": dict(mesh=mesh4, rebalance=True),
             "mesh4-hi8": dict(mesh=mesh4, upload="hi8")}
    if ncards > 1:
        paths.update({
            "all-cards-rebalance": dict(mesh=make_mesh(), rebalance=True),
            "all-cards-hi8": dict(mesh=make_mesh(), upload="hi8")})
    head = {k: (v[:4096] if k != "outputs" else
                (v[0][:4096 * OUTPUTS_PER_ROW], v[1][:4097]))
            for k, v in table.items()}
    # the exchange alone on the main path's batch shape, as the executor
    # hands it over (per-entry shards of the 17 int32 rows of the full
    # wire at 3 outputs and the source rows), on a quiet card
    from cudasp_tpu_torch.parallel import exchange as X
    from cudasp_tpu_torch.parallel.mesh import BatchShardings

    width = ct.api.TILE_CUDA
    planes, _ = pack_rows(table, width, "x")
    src = dev_tensor(np.arange(2 * width, dtype=np.int32).reshape(2, width))
    xbytes = sum(p.numel() * 4 for p in planes) + src.numel() * 4
    exchange = {}
    for label, mesh in [("mesh4", mesh4)] + (
            [("all-cards", paths["all-cards"]["mesh"])] if ncards > 1
            else []):
        sh = BatchShardings(mesh)
        ops = [sh.lanes(p) for p in (*planes[:3], src[:1], src[1:],
                                      planes[3])]
        ms = wall_ms(lambda: X.rebalance(mesh, *ops, block_rows=BLOCK_ROWS))
        t0 = time.perf_counter()
        X.rebalance(mesh, *ops, block_rows=BLOCK_ROWS)
        host_ms = (time.perf_counter() - t0) * 1e3
        sync_all()
        exchange[label] = {"ms": ms, "host_ms": host_ms, "bytes": xbytes}
        phase("exchange", f"rebalance of {width} rows over {mesh} (17 int32 "
              f"rows of planes, {xbytes / 1e6:.1f} MB): {ms:.3f} ms a batch "
              f"(host clock around 10 that end in synchronising every "
              f"card, on a quiet card), {host_ms:.3f} ms of host time to "
              f"issue one | {smi}")
        del ops
    del planes, src

    launches = {}
    for name, fields in paths.items():
        ct.scan(head, key, spend, config=ct.ScanConfig(**fields))  # warm-up
        for kern in K.KERNELS.values():
            kern.launches = kern.hi_launches = 0
        K.SHARDED.launches = 0
        calls.reset()
        t0 = time.perf_counter()
        res = ct.scan(table, key, spend, config=ct.ScanConfig(**fields))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        packed = dict(calls.by_thread)
        if packed.get("cudasp-feeder") != res.metrics.batches or feeders():
            raise AssertionError(f"mesh path {name}: pack_wire calls by "
                                 f"thread {packed}")
        counts = {n: kern.launches for n, kern in K.KERNELS.items()}
        cut = K.KERNELS["fixed"].hi_launches
        sharded = K.SHARDED.launches
        if not np.array_equal(res.indices, planted) or not np.array_equal(
                res.height, planted + 800_000):
            raise AssertionError(
                f"mesh path {name}: {len(res.indices)} matches, expected "
                f"{len(planted)}; first differences "
                f"{np.setxor1d(res.indices, planted)[:10].tolist()}")
        # every launch of the path went through the sharded wrapper, on
        # the fixed ladder; hi8 ran K12 and the exact pass
        if sharded <= 0 or sharded != counts["fixed"] or counts["wnaf"] \
                or counts["static"] or (name.endswith("hi8") and (
                    cut <= 0 or cut >= sharded)):
            raise AssertionError(f"mesh path {name}: sharded launches "
                                 f"{sharded}, kernel launches {counts}, "
                                 f"{cut} on a cut wire")
        launches[name] = sharded
        m = res.metrics
        size = fields["mesh"].size
        extra = ""
        if fields.get("rebalance"):
            extra = (f"; exchange {m.exchange_seconds / m.batches * 1e3:.3f}"
                     f" ms a batch by events (last entry ready to last "
                     f"exchanged), "
                     f"{m.exchange_bytes / m.batches / 1e6:.1f} MB of planes "
                     f"a batch")
        elif fields.get("upload"):
            extra = (f"; K12 launches {cut}, reverified_rows "
                     f"{m.reverified_rows}")
        phase("mesh-main-path", f"{name} ({fields['mesh']}"
              + (", rebalance" if fields.get("rebalance") else "")
              + (f", upload {fields['upload']}" if fields.get("upload")
                 else "")
              + f"): {MAIN_ROWS} rows in {secs:.3f} s = "
              f"{MAIN_ROWS / secs:,.0f} tx/s; C packer calls by thread "
              f"{packed}; {len(res.indices)} matches == "
              f"planted; sharded launches {sharded} ({sharded / size:g} a "
              f"shard over {m.batches} batches), kernel launches {counts}; "
              f"upload {m.upload_mode}, {m.launch_rows} rows a batch; pack "
              f"{m.pack_seconds:.3f} s, staging {m.upload_seconds:.3f} s, H2D "
              f"{m.h2d_seconds:.4f} s, device wait "
              f"{m.device_wait_seconds:.3f} s, "
              f"{m.upload_bytes / 1e6:.1f} MB up{extra} | {smi}")
    if ncards > 1:
        phase("all-cards", f"the all-cards mesh ran over {ncards} cards")
    else:
        phase("all-cards", "only one card is present: the all-cards mesh "
              "is a one-entry mesh; no multi-card number was measured")
    return launches, exchange


PACK_MODES = ("full", "full64", "hi32", "hi16", "hi8")


def native_pack_phase(table, smi):
    """native-pack: the C packer's pack_wire against the numpy
    pack_batch_arrays (and its staging copy's order of planes) at the
    launch width, on every mode: the words bit for bit, and each one's ms
    (best of 5, host clock), pack_wire into a pinned buffer with 1 thread
    and with native.PACK_THREADS. Returns {mode: timings}."""
    import numpy as np
    import torch

    import cudasp_tpu_torch as ct
    from cudasp_tpu_torch.io import ingest, native
    from cudasp_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    width = ct.api.TILE_CUDA
    flat, offs = table["outputs"]
    b = next(ingest.iter_packed(table["tweak_key"][:width],
                                flat[:offs[width]], offs[:width + 1], width,
                                OUTPUTS_PER_ROW))
    args = (b.tweak_blobs, b.row_valid, b.outputs_hi, b.outputs_lo,
            b.outputs_valid)
    pinned = torch.empty((native.plane_rows("full64", OUTPUTS_PER_ROW) + 1)
                         * width, dtype=torch.int32, pin_memory=True)
    out_np = pinned.numpy()

    def best(fn, reps=5):
        fn()
        t = float("inf")
        for _ in range(reps):
            t1 = time.perf_counter()
            fn()
            t = min(t, time.perf_counter() - t1)
        return t * 1e3

    res, bad = {}, 0
    for mode in PACK_MODES:
        cut = mode if mode.startswith("hi") else None

        def numpy_pack():
            planes = K.pack_batch_arrays(
                *args, block_rows=BLOCK_ROWS,
                wire="xy" if mode == "full64" else "x", hi_only=cut)
            keep = {None: (0, 1, 2, 3), "hi32": (0, 1, 3)}.get(cut, (0, 1))
            return np.concatenate([planes[k] for k in keep])

        ref = numpy_pack()
        got = native.pack_wire(*args, mode, width, BLOCK_ROWS, width,
                               out=out_np)
        words = int(np.count_nonzero(got[:-1].view(np.uint32) != ref))
        one = native.pack_wire(*args, mode, width, BLOCK_ROWS, width,
                               threads=1)
        words += int(np.count_nonzero(one[:-1] != ref))
        bad += words
        res[mode] = {
            "mismatched_words": words, "numpy_ms": best(numpy_pack),
            "c_1_thread_ms": best(lambda: native.pack_wire(
                *args, mode, width, BLOCK_ROWS, width, out=out_np,
                threads=1)),
            "c_threads_ms": best(lambda: native.pack_wire(
                *args, mode, width, BLOCK_ROWS, width, out=out_np)),
            "bytes": int(ref.nbytes)}
    if bad:
        raise AssertionError(f"native-pack: {bad} words differ from "
                             f"pack_batch_arrays: {res}")
    phase("native-pack", f"pack_wire (csrc/pack.cpp) == numpy "
          f"pack_batch_arrays at {width} rows, {OUTPUTS_PER_ROW} outputs, "
          f"every mode, into pinned memory: mismatched words 0; ms numpy / "
          f"C 1 thread / C {native.PACK_THREADS} threads: " + ", ".join(
              f"{m} {v['numpy_ms']:.2f} / {v['c_1_thread_ms']:.2f} / "
              f"{v['c_threads_ms']:.2f} ({v['bytes'] / 1e6:.1f} MB)"
              for m, v in res.items())
          + f" | {smi} [{time.perf_counter() - t0:.1f} s]")
    return res


class PackCalls:
    """Counts native.pack_wire's calls by the name of the thread that made
    them (wraps it for the run; the executor calls it through the
    module)."""

    def __init__(self):
        from collections import Counter

        from cudasp_tpu_torch.io import native

        self.by_thread = Counter()
        self.real = native.pack_wire
        self.fail_at = None
        native.pack_wire = self

    def __call__(self, *a, **kw):
        import threading

        self.by_thread[threading.current_thread().name] += 1
        if self.fail_at is not None and self.fail_at[0] == 0:
            self.fail_at = None
            raise RuntimeError("injected packing fault")
        if self.fail_at is not None:
            self.fail_at[0] -= 1
        return self.real(*a, **kw)

    def reset(self):
        self.by_thread.clear()


def feeders():
    import threading

    return [t for t in threading.enumerate() if t.name == "cudasp-feeder"]


def feeder_phase(table, planted, key, spend, calls, smi):
    """feeder: on the card, a packing fault injected at batch 3 raises
    ExecutionError(3), a launch failing twice at batch 2 raises
    ExecutionError(2), neither leaves a feeder thread alive, and the next
    scan is exact."""
    import numpy as np
    import torch

    import cudasp_tpu_torch as ct
    from cudasp_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    calls.fail_at = [3]
    try:
        ct.scan(table, key, spend)
        raise AssertionError("feeder: the injected packing fault passed")
    except ct.ExecutionError as e:
        if e.batch_index != 3 or "injected" not in str(e.cause):
            raise
    finally:
        calls.fail_at = None
    alive = len(feeders())
    real = K.scan_flags
    n = [0]

    def flaky(*a, **kw):
        n[0] += 1
        if n[0] in (3, 4):
            raise RuntimeError("injected launch fault")
        return real(*a, **kw)

    K.scan_flags = flaky
    try:
        ct.scan(table, key, spend)
        raise AssertionError("feeder: the injected launch fault passed")
    except ct.ExecutionError as e:
        if e.batch_index != 2:
            raise
    finally:
        K.scan_flags = real
    torch.cuda.synchronize()
    alive += len(feeders())
    res = ct.scan(table, key, spend)
    if alive or feeders() or not np.array_equal(res.indices, planted):
        raise AssertionError(f"feeder: {alive} feeder threads left, "
                             f"{len(res.indices)} rows")
    phase("feeder", "packing fault at batch 3 -> ExecutionError(3); launch "
          "failing twice at batch 2 -> ExecutionError(2); feeder threads "
          f"alive after each: 0; the next scan == planted ({len(planted)} "
          f"rows) | {smi} [{time.perf_counter() - t0:.1f} s]")


RAMP_ROWS = 65_536


def ramp_phase(table, planted, key, spend, smi):
    """ramp: CUDASP_RAMP=65536 (a 65,536-row first batch) gives the same
    rows, in one more batch."""
    import numpy as np
    import torch

    import cudasp_tpu_torch as ct

    t0 = time.perf_counter()
    os.environ["CUDASP_RAMP"] = str(RAMP_ROWS)
    try:
        t1 = time.perf_counter()
        res = ct.scan(table, key, spend)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
    finally:
        del os.environ["CUDASP_RAMP"]
    m = res.metrics
    want = 1 + -(-(MAIN_ROWS - RAMP_ROWS) // ct.api.TILE_CUDA)
    if not np.array_equal(res.indices, planted) or m.batches != want:
        raise AssertionError(f"ramp: {len(res.indices)} rows, "
                             f"{m.batches} batches (want {want})")
    phase("ramp", f"CUDASP_RAMP={RAMP_ROWS}: {MAIN_ROWS} rows == planted in "
          f"{m.batches} batches, {secs:.3f} s = {MAIN_ROWS / secs:,.0f} "
          f"tx/s; pack {m.pack_seconds:.3f} s, staging "
          f"{m.upload_seconds:.4f} s | {smi} "
          f"[{time.perf_counter() - t0:.1f} s]")
    return secs


def tools_phase(stages, smi):
    """tools: each of the slice's tools on the card with its check:
    kernel_probe (every ladder and wire OK), h2d_probe, concurrency_probe
    (2 tenants, both exact), ablate_probe (all seven stages, its budget
    beside stage_profile's from probe-time), scaling_probe (quick),
    multihost_bench (2 gloo processes on cuda:0), seed_cache twice (the
    second makes no nvcc run) and first_contact --skip-autotune (a
    reduced row count). Returns the ablation's result."""
    from cudasp_tpu_torch.tools import (ablate_probe, concurrency_probe,
                                        h2d_probe, kernel_probe,
                                        scaling_probe, seed_cache)

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    kp = kernel_probe.main(["--reps", "3"])
    if not all(r["ok"] for r in kp):
        raise AssertionError(f"kernel_probe: {kp}")
    phase("tools", "kernel_probe (262,144 rows of tools/dataset.py, "
          "device-resident): " + ", ".join(
              f"{r['ladder']}/{r['wire']} OK {r['ms']:.3f} ms "
              f"({r['rows_per_s'] / 1e6:.1f} M rows/s)" for r in kp)
          + f" | {smi} [{time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    h2d = h2d_probe.main([])
    phase("tools", "h2d_probe (262,144 rows, full wire, "
          f"{h2d['bytes'] / 1e6:.1f} MB): " + ", ".join(
              f"{k} {v['ms']:.3f} ms" + (f" ({v['MB_per_s'] / 1e3:.2f} GB/s)"
                                         if "MB_per_s" in v else "")
              for k, v in h2d.items() if isinstance(v, dict))
          + f" | {smi} [{time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    cp = concurrency_probe.main(["--rows", "500000", "--tenants", "2",
                                 "--pool", "64"])
    phase("tools", f"concurrency_probe: 2 tenants x 500,000 rows, both "
          f"exact; single {cp['single_tx_per_s']:,.0f} tx/s, together "
          f"{cp['aggregate_tx_per_s']:,.0f} tx/s aggregate "
          f"({cp['speedup']:.2f}x) | {smi} "
          f"[{time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    ab = ablate_probe.main(["--reps", "4"])
    if set(ab["stages"]) != set(ablate_probe.K.ABLATE_STAGES):
        raise AssertionError(f"ablate_probe: {ab}")
    phase("tools", f"ablate_probe (262,144 random rows, fixed/x): base "
          f"{ab['base_ms']:.3f} ms; stage cost (base - ablated) "
          + ", ".join(f"{n} {v['cost_ms']:.3f} ms ({v['share']:.1%})"
                      for n, v in ab["stages"].items())
          + f"; budget {ab['budget']['ms']:.3f} ms = "
          f"{ab['budget']['share']:.1%} of the kernel, beside stage_profile's"
          f" {stages['budget']['share']:.1%} of FULL (probe-time) | {smi} "
          f"[{time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    sc = scaling_probe.main(["--reps", "2", "--xla-rows-per-device",
                             "256"])
    phase("tools", "scaling_probe (65,536 rows an entry; xla 256): "
          + ", ".join(f"{r['probe']} {r['mesh']} {r['ms']:.2f} ms "
                      f"(eff {r['efficiency']:.2f})" for r in sc)
          + f"; {sc[0]['note']} | {smi} [{time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    mh = subprocess.run(
        [sys.executable, "-m", "cudasp_tpu_torch.tools.multihost_bench",
         "--spawn", "2", "--devices", "cuda:0", "--rows", "200000",
         "--pool", "64", "--repeats", "2", "--batch-size", "262144"],
        cwd=root, capture_output=True, text=True, timeout=400)
    if mh.returncode != 0:
        raise AssertionError(f"multihost_bench failed ({mh.returncode}):\n"
                             f"{mh.stdout}\n{mh.stderr[-3000:]}")
    mline = json.loads(mh.stdout.strip().splitlines()[-1])
    phase("tools", f"multihost_bench --spawn 2 (gloo, both on cuda:0), "
          f"200,000 rows, merges == is_match: {mline} | {smi} "
          f"[{time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    from cudasp_tpu_torch.oracle import vectors as V

    keys = ["--scan-key", V.SCAN_KEY_BIP352.hex()]
    s1 = seed_cache.main(keys)
    s2 = seed_cache.main(keys)
    if s2["nvcc_runs"] or s2["gxx_runs"]:
        raise AssertionError(f"seed_cache: a second run built {s2}")
    fc = subprocess.run(
        [sys.executable, "-m", "cudasp_tpu_torch.tools.first_contact",
         "--skip-autotune", "--rows", "262144", "--pool", "64"],
        cwd=root, capture_output=True, text=True, timeout=600)
    if fc.returncode != 0:
        raise AssertionError(f"first_contact failed ({fc.returncode}):\n"
                             f"{fc.stdout}\n{fc.stderr[-3000:]}")
    fsum = json.loads(fc.stdout.strip().splitlines()[-1])
    fscan = [ln for ln in fc.stdout.splitlines() if ln.startswith('{"rows"')]
    phase("tools", f"seed_cache twice with the BIP-352 key: first "
          f"{s1['nvcc_runs']} nvcc / {s1['gxx_runs']} g++ runs "
          f"({s1['seconds']:.2f} s), second {s2['nvcc_runs']} / "
          f"{s2['gxx_runs']} ({s2['seconds']:.2f} s); first_contact "
          f"--skip-autotune (262,144 rows): steps {fsum['steps']}, scan "
          f"{fscan[-1] if fscan else '?'} | {smi} "
          f"[{time.perf_counter() - t0:.1f} s]")
    return ab



ORACLE_ROWS = 256
ORACLE_MATCH_EVERY = 8
# golden case 0's first row under its keys (tests/test_oracle_cli.py)
ORACLE_BASE = "base: 1714273258699162470"
# the bench curve's subprocess, its four bench processes included
CURVE_TIMEOUT_S = 400


def run_group(cmd, root, timeout):
    """subprocess.run in a session of its own: on a timeout the whole
    process group (a tool and the processes it starts) is ended."""
    import signal

    proc = subprocess.Popen(cmd, cwd=root, env=dict(os.environ,
                                                    PYTHONPATH=root),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"{' '.join(cmd[1:4])}: no end in {timeout} s")
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def oracle_cli_phase(smi):
    """oracle-cli: the port's oracle CLI on the card host. gen-vectors
    (ORACLE_ROWS rows, seed 1, every ORACLE_MATCH_EVERY-th a match) in a
    subprocess; its rows, less expect_match, written as JSONL and scanned
    on the card by python -m cudasp_tpu_torch scan: the matched txids ==
    the rows marked expect_match; compute-expected on golden case 0's
    first row prints ORACLE_BASE."""
    import tempfile

    from cudasp_tpu_torch.oracle import vectors as V

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()

    def run(*args):
        proc = run_group([sys.executable, "-m", *args], root, 300)
        if proc.returncode != 0:
            raise AssertionError(f"{' '.join(args[:2])}: exit "
                                 f"{proc.returncode}\n{proc.stderr[-3000:]}")
        return proc.stdout

    lines = run("cudasp_tpu_torch.oracle", "gen-vectors", "--rows",
                str(ORACLE_ROWS), "--seed", "1", "--match-every",
                str(ORACLE_MATCH_EVERY)).splitlines()
    keys = json.loads(lines[0])["keys"]
    rows = [json.loads(ln) for ln in lines[1:]]
    want = [r["txid"] for r in rows if r.pop("expect_match")]
    gen_secs = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vectors.jsonl")
        with open(path, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
        out = run("cudasp_tpu_torch", "scan", "--input", path, "--scan-key",
                  keys["scan_private_key"], "--spend-key",
                  keys["spend_public_key"])
    got = [json.loads(ln)["txid"] for ln in out.splitlines()]
    if len(rows) != ORACLE_ROWS or got != want:
        raise AssertionError(f"oracle-cli: {len(rows)} rows, scan matched "
                             f"{len(got)} txids, expect_match marks "
                             f"{len(want)}")
    case = V.CASES[0]
    r0 = case.rows[0]
    base = run("cudasp_tpu_torch.oracle", "compute-expected", "--tweak",
               r0.tweak_blob.hex(), "--scan-key", case.scan_key_blob.hex(),
               "--spend-key", case.spend_blob.hex()).strip()
    if base != ORACLE_BASE:
        raise AssertionError(f"oracle-cli: compute-expected printed {base!r}")
    phase("oracle-cli", f"python -m cudasp_tpu_torch.oracle gen-vectors "
          f"--rows {ORACLE_ROWS} --seed 1 --match-every "
          f"{ORACLE_MATCH_EVERY} ({gen_secs:.1f} s), scanned on the card by "
          f"python -m cudasp_tpu_torch scan: {len(got)} txids == the rows "
          f"marked expect_match; compute-expected on golden case 0 row 0: "
          f"{base!r} | {smi} [{time.perf_counter() - t0:.1f} s]")


def bench_curve_phase(smi):
    """bench-curve: python -m cudasp_tpu_torch.tools.bench_curve at its
    default points (1M, 9.4M and 32.7M rows, and 1M with one label), each
    a fresh bench process whose every timed run returned exactly the
    planted rows (the bench exits 1 otherwise), writing under build/. One
    line a point from the records the tool printed (not the merged file):
    tx/s, the best run's stages, spread, and at 1M the kernel-only rows/s
    of each variant. Returns the records."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = run_group([sys.executable, "-m",
                      "cudasp_tpu_torch.tools.bench_curve"], root,
                     CURVE_TIMEOUT_S)
    records = [json.loads(ln) for ln in proc.stdout.splitlines()
               if ln.startswith("{")]
    bad = [r for r in records if "error" in r or not r.get("value")]
    if proc.returncode != 0 or bad or len(records) != 4:
        raise AssertionError(f"bench_curve: exit {proc.returncode}, "
                             f"{len(records)} records, failed {bad}\n"
                             f"{proc.stderr[-3000:]}")
    for r in records:
        best = min(r["runs"], key=lambda run: run["seconds"])
        kern = ", ".join(f"{k.removeprefix('kernel_rows_per_s').strip('_') or 'x'}"
                         f" {v / 1e6:.2f} M rows/s"
                         for k, v in r.items()
                         if k.startswith("kernel_rows_per_s"))
        phase("bench-curve", f"{r['rows']:,} rows, labels {r['labels']}: "
              f"{r['value'] / 1e6:.3f} M tx/s (best {r['seconds']:.4f} s of "
              f"{r['repeats']} runs {[round(x['seconds'], 4) for x in r['runs']]}"
              f"; spread {r['spread']:.3f}, spread_best2 "
              f"{r['spread_best2']:.3f}); batch {r['batch_size']}, "
              f"{best['launch_rows']} rows a launch, {best['batches']} "
              f"batches; link {r['link_MBps'] / 1e3:.2f} GB/s (H2D by "
              f"events); best run pack {best['pack_seconds']:.3f} s, H2D "
              f"{best['h2d_seconds']:.4f} s, device wait "
              f"{best['device_wait_seconds']:.3f} s; upload "
              f"{r['upload_mode']}; {r.get('vs_reference_point', 0):.2f}x "
              f"the upstream GPU's point"
              + (f"; kernel-only at 524,288 rows: {kern}" if kern else "")
              + f" | {r['device']['name']}, {r['device']['power_limit']}")
    phase("bench-curve", f"4 points, {time.perf_counter() - t0:.1f} s in all "
          f"| {smi}")
    return records


MULTIHOST_ROWS = 20_000


def multihost_worker(pid, nproc, port):
    """One process of the multihost phase: its hash part of a seeded
    20,000-row table scanned on cuda:0, merged over gloo; prints one JSON
    line."""
    import numpy as np
    import torch

    import cudasp_tpu_torch as ct
    from cudasp_tpu_torch.ops import kernels as K
    from cudasp_tpu_torch.parallel import distributed as D
    from cudasp_tpu_torch.parallel.mesh import make_mesh

    key, spend, table, planted = make_dataset(MULTIHOST_ROWS, SEED)
    # 32-byte txids: multihost_scan hashes a txid's bytes, as the JAX
    # package's does (an integer column would become bytes(int) there)
    txid = np.zeros((MULTIHOST_ROWS, 32), np.uint8)
    txid[:, :8] = table["txid"].astype("<u8")[:, None].view(np.uint8)
    table["txid"] = txid
    D.init(coordinator_address=f"127.0.0.1:{port}", num_processes=nproc,
           process_id=pid)
    t0 = time.perf_counter()
    got = D.multihost_scan(table, key, spend, config=ct.ScanConfig(
        mesh=make_mesh(devices=["cuda:0"])))
    secs = time.perf_counter() - t0
    torch.distributed.destroy_process_group()
    print(json.dumps({"pid": pid, "ok": bool(np.array_equal(got, planted)),
                      "matches": len(got), "planted": len(planted),
                      "sharded_launches": K.SHARDED.launches,
                      "seconds": secs}), flush=True)
    return 0


def multihost_phase():
    """multihost: two processes with gloo, both on cuda:0, scan a seeded
    20,000-row table by multihost_scan; each merge must equal the planted
    rows. Every process started here is ended here."""
    import socket

    t0 = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multihost-worker",
         str(pid), "2", port], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    lines = []
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"multihost worker failed "
                                 f"({p.returncode}):\n{out}\n{err[-3000:]}")
        line = json.loads(out.strip().splitlines()[-1])
        # each process scanned its part through the sharded kernel
        if not line["ok"] or line["sharded_launches"] <= 0:
            raise AssertionError(f"multihost worker: {line}")
        lines.append(line)
    phase("multihost", f"2 processes (gloo, both on cuda:0), "
          f"{MULTIHOST_ROWS} rows: merges == planted on both "
          f"({lines[0]['matches']} rows); {lines} "
          f"[{time.perf_counter() - t0:.1f} s]")
    return lines


# --- the user surface: stream + cursor, SQL, CLI, trace, retry ----------
STREAM_CHUNK = 300_000      # the reference's default batch size
RESUME_CHUNK = 250_000      # another chunking: the cursor lands mid-chunk
KILL_AFTER = 4              # the first stream dies after this many chunks
SQL_ROWS = 200_000
SQL_BATCH = 50_000
SIDE_ROWS = 262_144         # the CLI's JSONL table and the traced scan
SPANS = ("cudasp.pack", "cudasp.stage_h2d", "cudasp.launch", "cudasp.wait")
# the keys of the JAX package's metrics line (cudasp_tpu/runtime/
# metrics.py ScanMetrics.as_dict and runtime/trace.py emit_metrics)
REFERENCE_METRIC_KEYS = (
    "event", "rows_in", "rows_scanned", "batches", "matches", "pack_seconds",
    "device_seconds", "total_seconds", "batch_size", "n_devices",
    "upload_seconds", "upload_bytes", "device_wait_seconds",
    "reverified_rows", "upload_mode", "prewarm_failures", "warm_variants",
    "batch_retries", "rows_per_second", "bottleneck")


class Killed(Exception):
    """The stream's chunk source dies."""


def reset_launches():
    from cudasp_tpu_torch.ops import kernels as K

    for kern in K.KERNELS.values():
        kern.launches = kern.hi_launches = 0
    K.SHARDED.launches = 0


def launch_counts():
    """(scan-kernel launches of every ladder, of them on a cut wire,
    sharded launches) since reset_launches()."""
    from cudasp_tpu_torch.ops import kernels as K

    return (sum(k.launches for k in K.KERNELS.values()),
            sum(k.hi_launches for k in K.KERNELS.values()),
            K.SHARDED.launches)


def rows_of(table, a, b):
    from cudasp_tpu_torch.api import _slice_col

    return {k: _slice_col(v, a, b) for k, v in table.items()}


def table_chunks(table, rows, cursor=None, path=None, kill_after=None,
                 saves=None):
    """The table in `rows`-row chunks. With a cursor: saved to `path`
    before each chunk after the first is handed out (scan_stream has then
    recorded the one before it) and after the last, each save's (seconds,
    bytes) appended to `saves`; kill_after: raise Killed once that many
    chunks are done."""
    n = len(table["height"])

    def save():
        t0 = time.perf_counter()
        cursor.save(path)
        saves.append((time.perf_counter() - t0, os.path.getsize(path)))

    for k, a in enumerate(range(0, n, rows)):
        if cursor is not None and k:
            save()
        if kill_after is not None and k == kill_after:
            raise Killed
        yield rows_of(table, a, min(a + rows, n))
    if cursor is not None:
        save()


def stream_batches(sizes, batch_size=STREAM_CHUNK):
    """Batches scan() makes of chunks of these row counts on the card (its
    launch width: the batch size and the chunk as powers of two, at most
    TILE_CUDA)."""
    from cudasp_tpu_torch.api import TILE_CUDA

    def pow2(v, lo=128):
        p = lo
        while p < v:
            p *= 2
        return p

    return sum(-(-n // max(BLOCK_ROWS, min(pow2(batch_size), pow2(n),
                                           TILE_CUDA))) for n in sizes)


def check_rows(name, res, ref):
    """res == ref: indices, txid, height and tweak_key."""
    import numpy as np

    if not (np.array_equal(res.indices, ref.indices)
            and np.array_equal(np.asarray(res.txid, np.int64),
                               np.asarray(ref.txid, np.int64))
            and np.array_equal(np.asarray(res.height, np.int64),
                               np.asarray(ref.height, np.int64))
            and np.array_equal(res.tweak_key, ref.tweak_key)):
        raise AssertionError(f"{name}: {len(res.indices)} rows differ from "
                             f"scan()'s {len(ref.indices)}")


def stream_phase(table, planted, key, spend, smi):
    """stream (this slice's main path): scan_stream over the whole table
    in 300,000-row chunks with a ScanCursor saved after each, killed after
    chunk 4, loaded in a fresh cursor and resumed in 250,000-row chunks
    (the cursor lands mid-chunk): exactly the planted rows with scan()'s
    columns, only the uncovered rows scanned, and their launches; then an
    uninterrupted stream against scan() on the same table, the fixed cost
    of a 1-row scan, and one stream over make_mesh(). Returns {path:
    launches}."""
    import tempfile

    import numpy as np
    import torch

    import cudasp_tpu_torch as ct
    from cudasp_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    fresh = ct.scan(table, key, spend)
    torch.cuda.synchronize()
    scan_secs = time.perf_counter() - t0
    if not np.array_equal(fresh.indices, planted):
        raise AssertionError("stream: scan() does not return the planted "
                             "rows")
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cursor.json")
        # the uninterrupted stream, saved after every chunk
        saves = []
        cur = ct.ScanCursor()
        t0 = time.perf_counter()
        whole = ct.scan_stream(table_chunks(table, STREAM_CHUNK, cur, path,
                                            saves=saves), key, spend,
                               checkpoint=cur)
        torch.cuda.synchronize()
        stream_secs = time.perf_counter() - t0
        check_rows("stream", whole, fresh)
        nchunks = -(-MAIN_ROWS // STREAM_CHUNK)
        save_secs = sum(s for s, _ in saves)
        # the same stream without a cursor
        t0 = time.perf_counter()
        bare = ct.scan_stream(table_chunks(table, STREAM_CHUNK), key, spend)
        torch.cuda.synchronize()
        bare_secs = time.perf_counter() - t0
        check_rows("stream without a cursor", bare, fresh)
        # the killed run, then the resumed one: counts to 0 before each
        reset_launches()
        first = ct.ScanCursor()
        try:
            ct.scan_stream(table_chunks(table, STREAM_CHUNK, first, path,
                                        kill_after=KILL_AFTER, saves=[]),
                           key, spend, checkpoint=first)
            raise AssertionError("stream: the chunk source did not die")
        except Killed:
            pass
        torch.cuda.synchronize()
        killed = launch_counts()
        cur = ct.ScanCursor.load(path)
        done = cur.rows_done
        sizes = [min(a + RESUME_CHUNK, MAIN_ROWS) - max(a, done)
                 for a in range(0, MAIN_ROWS, RESUME_CHUNK)
                 if a + RESUME_CHUNK > done]
        reset_launches()
        t0 = time.perf_counter()
        res = ct.scan_stream(table_chunks(table, RESUME_CHUNK), key, spend,
                             checkpoint=cur)
        torch.cuda.synchronize()
        resume_secs = time.perf_counter() - t0
        total, cut, _ = launch_counts()
        cursor_bytes = os.path.getsize(path) if os.path.exists(path) else 0
    check_rows("stream-resume", res, fresh)
    m = res.metrics
    uncovered = MAIN_ROWS - done
    want = stream_batches(sizes)
    if done != KILL_AFTER * STREAM_CHUNK or done % RESUME_CHUNK == 0 \
            or sum(sizes) != uncovered or m.rows_in != uncovered \
            or m.rows_scanned != uncovered or m.batches != want \
            or total < want or (total > want) != bool(m.reverified_rows) \
            or killed[0] < stream_batches([STREAM_CHUNK] * KILL_AFTER):
        raise AssertionError(
            f"stream-resume: cursor at {done}, resumed rows_in {m.rows_in}, "
            f"rows_scanned {m.rows_scanned}, batches {m.batches} (expected "
            f"{want} over chunks {sizes}), launches {total} ({cut} cut), "
            f"killed run's launches {killed}")
    launches["stream-killed"], launches["stream-resume"] = killed[0], total
    phase("stream", f"scan_stream over {MAIN_ROWS} rows in {STREAM_CHUNK}-"
          f"row chunks, a ScanCursor saved after each: {len(whole.indices)} "
          f"matches, columns == scan()'s; killed after chunk {KILL_AFTER} "
          f"({killed[0]} launches), the cursor ({done} rows done) loaded "
          f"afresh and resumed in {RESUME_CHUNK}-row chunks: rows_in "
          f"{m.rows_in} == rows_scanned == the uncovered {uncovered} "
          f"(chunks {sizes}), {total} launches ({cut} on a cut wire) == "
          f"{m.batches} batches (a whole rescan: "
          f"{stream_batches([RESUME_CHUNK] * 9 + [MAIN_ROWS % RESUME_CHUNK])}"
          f"), upload {m.upload_mode}; {len(res.indices)} matches == planted"
          f", txid / height / tweak_key == scan()'s, in {resume_secs:.3f} s")

    # the fixed cost of a scan() call: a 1-row table, median of 5
    one = rows_of(table, 0, 1)
    ct.scan(one, key, spend)
    fixed = []
    for _ in range(5):
        t0 = time.perf_counter()
        ct.scan(one, key, spend)
        torch.cuda.synchronize()
        fixed.append(time.perf_counter() - t0)
    fixed_ms = sorted(fixed)[2] * 1e3
    bm = bare.metrics
    phase("stream-time", f"scan() {MAIN_ROWS / scan_secs:,.0f} tx/s "
          f"({scan_secs:.3f} s, {fresh.metrics.batches} batches) against "
          f"scan_stream in {nchunks} chunks ({bm.batches} batches): "
          f"without a cursor {MAIN_ROWS / bare_secs:,.0f} tx/s "
          f"({bare_secs:.3f} s, of it {bm.total_seconds:.3f} s in the "
          f"chunks' scans: pack {bm.pack_seconds:.3f} s, staging "
          f"{bm.upload_seconds:.3f} s, device wait "
          f"{bm.device_wait_seconds:.3f} s; "
          f"{(bare_secs - scan_secs) / nchunks * 1e3:.2f} ms a chunk over "
          f"scan()); with the cursor saved after each chunk "
          f"{MAIN_ROWS / stream_secs:,.0f} tx/s ({stream_secs:.3f} s: "
          f"{len(saves)} saves {save_secs:.3f} s, the last "
          f"{saves[-1][1] / 1e6:.2f} MB in "
          f"{saves[-1][0] * 1e3:.1f} ms; the cursor's bookkeeping "
          f"{(stream_secs - save_secs - bare_secs) / nchunks * 1e3:.2f} ms "
          f"a chunk); a 1-row scan() {fixed_ms:.2f} ms (median of 5); the "
          f"resumed cursor {cursor_bytes / 1e6:.2f} MB | {smi}")

    reset_launches()
    t0 = time.perf_counter()
    mres = ct.scan_stream(table_chunks(table, STREAM_CHUNK), key, spend,
                          config=ct.ScanConfig(mesh=make_mesh()))
    torch.cuda.synchronize()
    msecs = time.perf_counter() - t0
    total, _, sharded = launch_counts()
    check_rows("stream-mesh", mres, fresh)
    if sharded <= 0 or sharded != total:
        raise AssertionError(f"stream-mesh: sharded launches {sharded}, "
                             f"kernel launches {total}")
    launches["stream-mesh"] = sharded
    phase("stream-mesh", f"scan_stream over make_mesh() "
          f"({mres.metrics.n_devices} entries): {len(mres.indices)} matches "
          f"== scan()'s rows, {sharded} sharded launches, "
          f"{MAIN_ROWS / msecs:,.0f} tx/s | {smi}")
    return launches


def sql_blob(b):
    return "BLOB '" + "".join(f"\\x{v:02x}" for v in bytes(b)) + "'"


def sql_scan(table, key, spend, labels, batch=None):
    return (f"cudasp_scan((SELECT * FROM {table}), {sql_blob(key)}, "
            f"{sql_blob(spend)}, [" + ", ".join(sql_blob(lb) for lb in labels)
            + "]" + (f", batch_size := {batch}" if batch else "") + ")")


def sql_phase(smi):
    """sql: SQLEngine() (the port's scan, on the card) over every golden
    case written as SQL (CREATE TABLE, INSERT ... VALUES with BLOB and
    list literals, SELECT ... FROM cudasp_scan(...) with labels and the
    wrong-key cases), then a bulk table made by CREATE TABLE AS SELECT
    ... FROM range(200000) scanned with batch_size := 50000, whose rows
    must equal scan() on the same columns. Returns the bulk scan's
    launches."""
    import torch

    import cudasp_tpu_torch as ct
    from cudasp_tpu_torch.oracle import vectors as V
    from cudasp_tpu_torch.sql import SQLEngine

    eng = SQLEngine()
    for k, case in enumerate(V.CASES):
        t = f"g{k}"
        eng.execute(f"CREATE TABLE {t} (txid BLOB, height INTEGER, "
                    "tweak_key BLOB, outputs BIGINT[])")
        eng.execute(f"INSERT INTO {t} VALUES " + ", ".join(
            f"({sql_blob(r.txid)}, {r.height}, {sql_blob(r.tweak_blob)}, "
            f"[{', '.join(map(str, r.outputs))}])" for r in case.rows))
        got = eng.execute("SELECT height, txid, tweak_key FROM " + sql_scan(
            t, case.scan_key_blob, case.spend_blob, case.label_blobs))
        want = [(r.height, bytes(r.txid), bytes(r.tweak_blob))
                for h in case.expected_heights for r in case.rows
                if r.height == h]
        if got != want:
            raise AssertionError(f"sql {case.name}: {got} != {want}")
    case = next(c for c in V.CASES if c.expected_heights and not
                c.label_blobs)
    row = next(r for r in case.rows if r.height == case.expected_heights[0])
    eng.execute(f"CREATE TABLE bulk AS SELECT {sql_blob(row.txid)} AS txid, "
                f"range AS height, {sql_blob(row.tweak_blob)} AS tweak_key, "
                f"[{', '.join(map(str, row.outputs))}] AS outputs "
                f"FROM range({SQL_ROWS})")
    scan_sql = sql_scan("bulk", case.scan_key_blob, case.spend_blob, (),
                        SQL_BATCH)
    reset_launches()
    t0 = time.perf_counter()
    got = eng.execute(f"SELECT txid, height, tweak_key FROM {scan_sql}")
    eng_secs = time.perf_counter() - t0
    launches = launch_counts()[0]
    count = eng.execute(f"SELECT COUNT(*) FROM {scan_sql}")
    none = eng.execute("SELECT COUNT(*) FROM " + sql_scan(
        "bulk", bytes(32 - 1) + b"\x07", case.spend_blob, (), SQL_BATCH))
    t0 = time.perf_counter()
    res = ct.scan(eng.tables["bulk"], case.scan_key_blob, case.spend_blob,
                  batch_size=SQL_BATCH)
    torch.cuda.synchronize()
    scan_secs = time.perf_counter() - t0
    want = [(bytes(t), int(h), bytes(tw)) for t, h, tw in
            zip(res.txid, res.height, res.tweak_key)]
    if got != want or count != [(SQL_ROWS,)] or len(got) != SQL_ROWS \
            or none != [(0,)] or launches < -(-SQL_ROWS // 65536):
        raise AssertionError(f"sql bulk: {len(got)} rows against scan()'s "
                             f"{len(want)}, COUNT(*) {count}, another key "
                             f"{none}, launches {launches}")
    phase("sql", f"SQLEngine() on the card: {len(V.CASES)} golden cases as "
          f"SQL (CREATE / INSERT / cudasp_scan with labels and the wrong-key "
          f"cases) == expected; bulk CREATE TABLE AS ... FROM "
          f"range({SQL_ROWS}), batch_size := {SQL_BATCH}: {len(got)} rows "
          f"== scan() on the same columns, COUNT(*) {count[0][0]}, another "
          f"key 0; {launches} launches; engine {eng_secs:.3f} s against "
          f"scan() {scan_secs:.3f} s | {smi}")
    return launches


def build_files():
    """(path, mtime, size) of every file under the kernels' build tree."""
    from cudasp_tpu_torch.ops import kernels as K

    out = set()
    for d, _, files in os.walk(K._BUILD_ROOT):
        for f in files:
            st = os.stat(os.path.join(d, f))
            out.add((os.path.join(d, f), st.st_mtime_ns, st.st_size))
    return out


def cli_phase(table, planted, key, spend, smi):
    """cli: python -m cudasp_tpu_torch scan ... --metrics in a subprocess
    on the card: Parquet with --stream over the whole table where pyarrow
    imports, else JSONL of the first 262,144 rows; its JSONL rows ==
    planted, its metrics line parsed, and no file of the build tree
    written (0 nvcc builds: the libraries this process built serve it).
    Returns the subprocess's batches (its metrics line)."""
    import tempfile

    import numpy as np

    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError:
        pa = None
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        if pa is not None:
            rows, how = MAIN_ROWS, (f"parquet, --stream {STREAM_CHUNK} "
                                    "(pyarrow imports here)")
            path = os.path.join(tmp, "table.parquet")
            flat, offs = table["outputs"]

            def binary(a, width):
                return pa.FixedSizeBinaryArray.from_buffers(
                    pa.binary(width), len(a),
                    [None, pa.py_buffer(a.tobytes())]).cast(pa.binary())

            pq.write_table(pa.table({
                "txid": binary(table["txid"].astype(">i8"), 8),
                "height": pa.array(table["height"], pa.int64()),
                "tweak_key": binary(table["tweak_key"], 64),
                "outputs": pa.ListArray.from_arrays(
                    pa.array(offs.astype(np.int32)), pa.array(flat)),
            }), path)
            extra = ["--stream", str(STREAM_CHUNK)]
        else:
            rows, how = SIDE_ROWS, ("JSONL of the first rows: pyarrow does "
                                    "not import here, and --stream needs "
                                    "Parquet")
            path = os.path.join(tmp, "table.jsonl")
            flat, offs = table["outputs"]
            with open(path, "w") as f:
                for i in range(rows):
                    f.write(json.dumps({
                        "txid": int(table["txid"][i]).to_bytes(8, "big").hex(),
                        "height": int(table["height"][i]),
                        "tweak_key": table["tweak_key"][i].tobytes().hex(),
                        "outputs": flat[offs[i]:offs[i + 1]].tolist()}) + "\n")
            extra = []
        write_secs = time.perf_counter() - t0
        before = build_files()
        env = dict(os.environ, PYTHONPATH=root)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "cudasp_tpu_torch", "scan", "--input",
             path, "--scan-key", key.hex(), "--spend-key", spend.hex(),
             "--metrics", *extra], cwd=root, env=env, capture_output=True,
            text=True, timeout=600)
        secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli: exit {proc.returncode}\n"
                             f"{proc.stderr[-3000:]}")
    out = [json.loads(ln) for ln in proc.stdout.splitlines()]
    metrics = json.loads(next(ln for ln in proc.stderr.splitlines()
                              if ln.startswith("{")))
    want = planted[planted < rows]
    rebuilt = build_files() ^ before
    if [r["row"] for r in out] != want.tolist() \
            or [r["height"] for r in out] != (want + 800_000).tolist() \
            or metrics["rows_in"] != rows or metrics["matches"] != len(want) \
            or rebuilt:
        raise AssertionError(f"cli: {len(out)} rows (expected {len(want)}), "
                             f"metrics {metrics}, build files written "
                             f"{sorted(rebuilt)[:4]}")
    phase("cli", f"python -m cudasp_tpu_torch scan --metrics in a "
          f"subprocess on the card, {how}: {rows} rows, {len(out)} JSONL "
          f"rows == planted; metrics line: {metrics['batches']} batches, "
          f"upload {metrics['upload_mode']}, scan wall "
          f"{metrics['wall_seconds']} s ({rows / metrics['wall_seconds']:,.0f}"
          f" tx/s), total_seconds {metrics['total_seconds']:.3f} (pack "
          f"{metrics['pack_seconds']:.3f}, staging "
          f"{metrics['upload_seconds']:.3f}, device wait "
          f"{metrics['device_wait_seconds']:.3f}); the "
          f"subprocess {secs:.1f} s (load, scan, write); the input written "
          f"in {write_secs:.1f} s; 0 nvcc builds (no file of the build "
          f"tree written) | {smi}")
    return metrics["batches"]


def trace_phase(table, key, spend, smi):
    """trace: a 262,144-row scan under CUDASP_PROFILE_DIR and
    CUDASP_METRICS=1: the trace file holds the executor's spans and the
    scan kernel's device event (where CUPTI records kernels; else the
    launch's runtime event, and the line says which), and the metrics
    line has every key of the JAX package's. Returns the traced scan's
    launches."""
    import contextlib
    import glob
    import io
    import tempfile

    import torch

    import cudasp_tpu_torch as ct

    head = rows_of(table, 0, SIDE_ROWS)
    secs = []
    for _ in range(2):
        t0 = time.perf_counter()
        ct.scan(head, key, spend)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["CUDASP_PROFILE_DIR"] = tmp
        os.environ["CUDASP_METRICS"] = "1"
        traced = []
        try:
            # the first traced scan in the process pays the profiler's
            # start-up; the second is the steady cost, and is checked
            for _ in range(2):
                for f in glob.glob(os.path.join(tmp, "scan-*.json")):
                    os.remove(f)
                err = io.StringIO()
                reset_launches()
                with contextlib.redirect_stderr(err):
                    t0 = time.perf_counter()
                    ct.scan(head, key, spend)
                    torch.cuda.synchronize()
                    traced.append(time.perf_counter() - t0)
        finally:
            del os.environ["CUDASP_PROFILE_DIR"], os.environ["CUDASP_METRICS"]
        launches = launch_counts()[0]
        files = glob.glob(os.path.join(tmp, "scan-*.json"))
        if len(files) != 1:
            raise AssertionError(f"trace: {len(files)} trace files")
        trace_bytes = os.path.getsize(files[0])
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    device = [e for e in events if e.get("cat") == "kernel"
              and "scan_kernel" in e.get("name", "")]
    runtime = [e for e in events if e.get("cat") in ("cuda_runtime",
                                                      "cuda_driver")
               and "aunch" in e.get("name", "")]
    line = [json.loads(ln) for ln in err.getvalue().splitlines()
            if '"scan_metrics"' in ln]
    missing = set(REFERENCE_METRIC_KEYS) - set(line[0]) if line else None
    if not set(SPANS) <= names or not (device or runtime) or missing \
            or len(line) != 1 or launches <= 0:
        raise AssertionError(
            f"trace: spans {sorted(set(SPANS) - names)} missing, "
            f"{len(device)} kernel events, {len(runtime)} launch events, "
            f"{len(line)} metrics lines, keys missing {missing}")
    held = (f"{len(device)} device events of the scan kernel "
            f"({device[0]['name'][:60]}..., {device[0].get('dur')} us)"
            if device else
            f"no device kernel event (CUPTI records no kernels here): the "
            f"launch's runtime events instead, {len(runtime)} "
            f"({sorted({e['name'] for e in runtime})})")
    phase("trace", f"{SIDE_ROWS}-row scan under CUDASP_PROFILE_DIR and "
          f"CUDASP_METRICS=1: one trace file ({trace_bytes / 1e6:.2f} MB, "
          f"{len(events)} events) with the spans {list(SPANS)} and {held}; "
          f"the metrics line has all {len(REFERENCE_METRIC_KEYS)} keys of "
          f"the JAX package's ({len(line[0])} in all); scan {secs[1]:.3f} s "
          f"without the profiler, {traced[1]:.3f} s with it (the first "
          f"traced scan of the process {traced[0]:.3f} s); {launches} "
          f"launches | {smi}")
    return launches


def retry_phase(table, planted, key, spend, smi):
    """retry: the 2,300,000-row main path with the launch wrapper
    (ops.kernels.scan_flags, patched here) failing once at batch 2, and
    with a batch's result failing once at batch 4 (the executor's wait on
    the card, where a fault of the card shows): batch_retries == 1 and
    the planted rows, each; then batch 2's launch failing twice:
    ExecutionError(2). Returns the launches of the first run."""
    import numpy as np
    import torch

    import cudasp_tpu_torch as ct
    from cudasp_tpu_torch.ops import kernels as K
    from cudasp_tpu_torch.runtime import executor as X

    real_launch, real_wait = K.scan_flags, X._Cuda.wait
    state = {"launch": 0, "wait": 0, "fail": ()}

    def counted(what, real):
        def fn(*a, **kw):
            state[what] += 1
            if (what, state[what]) in state["fail"]:
                raise RuntimeError(f"injected {what} fault")
            return real(*a, **kw)
        return fn

    K.scan_flags = counted("launch", real_launch)
    X._Cuda.wait = counted("wait", real_wait)
    runs = []
    try:
        for fail in ({("launch", 3)}, {("wait", 5)}):
            state.update(launch=0, wait=0, fail=fail)
            reset_launches()
            t0 = time.perf_counter()
            res = ct.scan(table, key, spend)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            m = res.metrics
            if m.batch_retries != 1 or not np.array_equal(res.indices,
                                                          planted) \
                    or not np.array_equal(res.height, planted + 800_000):
                raise AssertionError(f"retry {fail}: batch_retries "
                                     f"{m.batch_retries}, {len(res)} rows")
            runs.append((fail, launch_counts()[0], m.batches, secs))
        state.update(launch=0, wait=0, fail={("launch", 3), ("launch", 4)})
        try:
            ct.scan(table, key, spend)
            raise AssertionError("retry: a batch that failed twice did not "
                                 "raise")
        except ct.ExecutionError as e:
            err = e
        if err.batch_index != 2 or "batch 2 failed" not in str(err):
            raise AssertionError(f"retry: {err!r} names another batch")
    finally:
        K.scan_flags, X._Cuda.wait = real_launch, real_wait
        torch.cuda.synchronize()
    phase("retry", "; ".join(
        f"{next(iter(f))[0]} of batch {next(iter(f))[1] - 1} failing once: "
        f"batch_retries 1, {n} launches for {b} batches, matches == planted "
        f"in {s:.3f} s" for f, n, b, s in runs)
        + f"; batch 2's launch failing twice: {err} | {smi}")
    return runs[0][1]


XLA_NARROW = 8192           # the JAX package's XLA tile, timed beside ours


def golden_rows(case):
    """A golden case's table (with heights) and its matching row indices."""
    table = {"height": [r.height for r in case.rows], **golden_table(case)}
    return table, [i for i, r in enumerate(case.rows)
                   if r.height in case.expected_heights]


def off_curve_case0():
    """gecc_case0 with row 0's y + 2 (same parity, off the curve): the XLA
    backend computes on the literal (x, y) and does not match it; the
    kernel reads only y's parity and does."""
    from cudasp_tpu_torch.oracle import vectors as V

    table, _ = golden_rows(V.CASES[0])
    blobs = table["tweak_key"].copy()
    y = int.from_bytes(blobs[0, 32:].tobytes(), "little") + 2
    blobs[0, 32:] = list(y.to_bytes(32, "little"))
    table["tweak_key"] = blobs
    return table


def tuning_phase(smi):
    """The card's resolved tuning row; block_rows=None against the
    default and the H100 row's explicit value on a golden case; the
    autotune tool's dry, quick sweep in a subprocess, which writes
    nothing."""
    import glob

    import cudasp_tpu_torch as ct
    from cudasp_tpu_torch.oracle import vectors as V
    from cudasp_tpu_torch.runtime import tuning

    t0 = time.perf_counter()
    d = tuning.defaults()
    case = next(c for c in V.CASES if c.label_blobs)
    table, want = golden_rows(case)
    rows = {}
    for name, cfg in (("block_rows=None", ct.ScanConfig(block_rows=None)),
                      ("ScanConfig()", ct.ScanConfig()),
                      ("block_rows=256", ct.ScanConfig(block_rows=256))):
        res = ct.scan(table, case.scan_key_blob, case.spend_blob,
                      case.label_blobs, config=cfg)
        rows[name] = (res.indices.tolist(), res.metrics.launch_rows)
    if any(r[0] != want for r in rows.values()) or len(set(
            r[1] for r in rows.values())) != 1:
        raise AssertionError(f"tuning: rows {rows}, expected {want}")
    pattern = os.path.join(tuning.TUNING_DIR, "tuning_*.json")
    before = sorted(glob.glob(pattern))
    t1 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "cudasp_tpu_torch.tools.autotune",
         "--dry-run", "--quick"], capture_output=True, text=True,
        timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    sweep = time.perf_counter() - t1
    print(out.stdout + out.stderr, flush=True)
    if out.returncode != 0 or "best:" not in out.stdout:
        raise AssertionError(f"autotune --dry-run --quick: exit "
                             f"{out.returncode}")
    if sorted(glob.glob(pattern)) != before:
        raise AssertionError("autotune --dry-run wrote a tuning row")
    phase("tuning", f"{tuning.device_kind()}: tuning.defaults() = {d} "
          f"(CUDASP_BLOCK_ROWS {os.environ.get('CUDASP_BLOCK_ROWS')}, "
          f"CUDASP_TILE {os.environ.get('CUDASP_TILE')}); {case.name} "
          f"with block_rows=None, ScanConfig() and block_rows=256: rows "
          f"{want}, {rows['ScanConfig()'][1]} rows a launch; autotune "
          f"--dry-run --quick {sweep:.1f} s, exit 0, no file written | "
          f"{smi} [{time.perf_counter() - t0:.1f} s]")


def xla_golden_phase(smi):
    """Every golden case through ScanConfig(backend="xla") on the card,
    fused False and True, against its expected rows and the same scan on
    the CPU; the off-curve row: card == CPU == no match (the kernel
    matches it)."""
    import cudasp_tpu_torch as ct
    from cudasp_tpu_torch.oracle import vectors as V

    t0 = time.perf_counter()
    reset_launches()
    card = []
    for case in V.CASES:
        table, want = golden_rows(case)
        got = {}
        for fused in (False, True):
            for dev in ("cuda", "cpu"):
                if dev == "cpu" and fused:
                    continue
                t1 = time.perf_counter()
                res = ct.scan(table, case.scan_key_blob, case.spend_blob,
                              case.label_blobs, device=dev,
                              config=ct.ScanConfig(backend="xla",
                                                   fused=fused))
                if dev == "cuda":
                    card.append(time.perf_counter() - t1)
                got[dev, fused] = res.indices.tolist()
        if any(g != want for g in got.values()):
            raise AssertionError(f"xla-golden {case.name}: {got}, "
                                 f"expected {want}")
    case = V.CASES[0]
    table = off_curve_case0()
    off = {dev: ct.scan(table, case.scan_key_blob, case.spend_blob,
                        device=dev, config=ct.ScanConfig(backend="xla")
                        ).indices.tolist() for dev in ("cuda", "cpu")}
    kernel_launches = launch_counts()
    kern = ct.scan(table, case.scan_key_blob, case.spend_blob).indices
    if off != {"cuda": [], "cpu": []} or kern.tolist() != [0]:
        raise AssertionError(f"xla-golden off-curve row: xla {off}, "
                             f"kernel {kern.tolist()}")
    if kernel_launches != (0, 0, 0):
        raise AssertionError(f"xla-golden: the XLA backend launched the "
                             f"scan kernel {kernel_launches}")
    phase("xla-golden", f"{len(V.CASES)} cases x fused False/True on the "
          f"card == expected == device='cpu' ({len(card)} card scans, "
          f"{min(card):.2f}-{max(card):.2f} s each, 256 rows a batch); "
          f"off-curve row (gecc_case0, y + 2): card {off['cuda']} == cpu "
          f"{off['cpu']}, the kernel {kern.tolist()}; scan-kernel "
          f"launches on the XLA scans {kernel_launches} | {smi} "
          f"[{time.perf_counter() - t0:.1f} s]")


def xla_main_path(table, planted, key, spend, kernel_rows, smi):
    """The 2,300,000-row table through ScanConfig(backend="xla") on the
    card: the planted rows and the kernel path's, its metrics and peak
    memory, no scan-kernel launch; then one pipeline batch of 262,144
    rows against one of 8,192 (the JAX package's XLA tile), by CUDA
    events on device-resident planes."""
    import numpy as np
    import torch

    import cudasp_tpu_torch as ct
    from cudasp_tpu_torch.io import ingest
    from cudasp_tpu_torch.ops import field as F
    from cudasp_tpu_torch.ops import pipeline as PL

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t1 = time.perf_counter()
    res = ct.scan(table, key, spend, config=ct.ScanConfig(backend="xla"))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not np.array_equal(res.indices, planted) or not np.array_equal(
            res.indices, kernel_rows):
        raise AssertionError(
            f"xla-main-path: {len(res.indices)} matches, expected "
            f"{len(planted)}; first differences "
            f"{np.setxor1d(res.indices, planted)[:10].tolist()}")
    if launches != (0, 0, 0):
        raise AssertionError(f"xla-main-path launched the scan kernel "
                             f"{launches}")
    m = res.metrics
    sched, sp, lab, _ = ingest.pack_query_keys(key, spend, [])
    q = PL.query_limbs(dev_tensor(sp), dev_tensor(lab))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    batch = {}
    for width in (ct.api.TILE_CUDA, XLA_NARROW):
        rows = PL.from_planes(*pack_rows(table, width, "xy")[0])
        F.PRODUCTS[0] = F.SQUARES[0] = 0
        with torch.inference_mode():
            ev[0].record()
            flags = PL.scan_batch(*rows, sched.glv, *q, nlabels=0)
            ev[1].record()
            torch.cuda.synchronize()
        got = np.flatnonzero(flags.cpu().numpy())
        if not np.array_equal(got, planted[planted < width]):
            raise AssertionError(f"xla batch of {width}: wrong flags")
        batch[width] = (ev[0].elapsed_time(ev[1]),
                        F.PRODUCTS[0] / width, F.SQUARES[0] / width)
        del rows, flags
    wide, narrow = batch[ct.api.TILE_CUDA], batch[XLA_NARROW]
    phase("xla-main-path", f"ScanConfig(backend='xla'): {MAIN_ROWS} rows "
          f"in {secs:.3f} s = {MAIN_ROWS / secs:,.0f} tx/s end to end; "
          f"{len(res.indices)} matches == planted == the kernel path's; "
          f"{m.batches} batches of {m.launch_rows} rows, pack "
          f"{m.pack_seconds:.3f} s, staging {m.upload_seconds:.3f} s, H2D "
          f"{m.h2d_seconds:.4f} s, device wait "
          f"{m.device_wait_seconds:.3f} s, executor {m.device_seconds:.3f} "
          f"s; peak device memory {peak / 2**30:.2f} GiB; scan-kernel "
          f"launches {launches}; one pipeline batch (events): "
          f"{ct.api.TILE_CUDA} rows {wide[0]:.1f} ms "
          f"({ct.api.TILE_CUDA / wide[0] * 1e3:,.0f} rows/s, "
          f"{wide[1]:.0f} products + {wide[2]:.0f} squares a row), "
          f"{XLA_NARROW} rows {narrow[0]:.1f} ms "
          f"({XLA_NARROW / narrow[0] * 1e3:,.0f} rows/s) | {smi} "
          f"[{time.perf_counter() - t0:.1f} s]")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import cudasp_tpu_torch as ct
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
    static_secs, ablate_secs, pack_secs = build_all(static_keys)
    fx = K.KERNELS["fixed"]
    bs = fx.build_seconds
    ptxas = K.ptxas_info(fx.build_log)
    phase("build", "csrc/scan.cu (fixed + wnaf): "
          + ("cached" if bs is None else f"nvcc {bs:.1f} s") + " | "
          + ptxas_text(ptxas))
    st = K.KERNELS["static"]
    phase("build-static", f"{len(static_secs)} keys, {st.nvcc_runs} nvcc "
          f"builds: " + ", ".join(f"{d} {v:.1f} s" for d, v in
                                  static_secs.items())
          + f"; all builds {time.perf_counter() - t0:.1f} s | "
          + ptxas_text(K.ptxas_info(st.build_log)))
    ptxas.update(K.ptxas_info(st.build_log))
    static_runs = st.nvcc_runs
    from cudasp_tpu_torch.io import native
    phase("build-ablate", "csrc/scan.cu with -DSP_ABLATE=<stage> (fixed "
          "ladder only; ablate_probe's): " + ", ".join(
              f"{n} {v:.1f} s" for n, v in ablate_secs.items())
          + f"; csrc/pack.cpp (g++ {' '.join(native.GXX_FLAGS)}): "
          + (f"{native.STATE.build_seconds:.1f} s" if native.STATE.runs
             else "cached") + f", loaded after {pack_secs:.1f} s")
    from cudasp_tpu_torch.ops import probes as P
    pb = P.PROBES.build_seconds
    phase("build-probe", "csrc/probe.cu (alu, bench, stage kernels): "
          + ("cached" if pb is None else f"nvcc {pb:.1f} s") + " | "
          + " | ".join(f"{n}: {v}" for n, v in
                       probe_ptxas(P.PROBES.build_log).items()))

    # --- what ptxas made of the field code: SASS counts ------------------
    nvcc = K.find_nvcc()
    main_static = query(key, spend, ())[0].wnaf_static
    sass = {}
    for name, so in (("csrc/scan.cu", fx.library()._name),
                     ("the main key's static unit",
                      st.library(main_static)._name),
                     ("csrc/probe.cu", P.PROBES.library()._name)):
        counts = {n: c for n, c in K.sass_counts(so, nvcc).items()
                  if not n.startswith("bench") or "field" in n}
        sass.update(counts)
        phase("sass", f"{name} (cuobjdump -sass): {sass_text(counts)}")

    # --- the carry chains' PTX on the card --------------------------------
    t0 = time.perf_counter()
    pairs, bad = field_edges(torch.device("cuda"))
    phase("field-edges", f"{len(CRAFTED) ** 2} crafted + "
          f"{pairs - len(CRAFTED) ** 2} random edge-biased pairs, fe_mul / "
          f"fe_sqr / fe_add / fe_sub on the card (field_kernel, "
          f"{P.PROBES.field_launches} launches) == the carry chains' "
          f"algorithm on Python integers (the op mod p, below 2^256): "
          f"mismatches {bad} [{time.perf_counter() - t0:.1f} s]")

    # --- the host packer against the numpy packer ------------------------
    native_pack = native_pack_phase(table, smi)
    calls = PackCalls()

    # --- kernel vs plain on the card -------------------------------------
    # tallies by kernel: each ladder's exact wires, and "hi" (K12) for
    # every ladder on the cut wires
    mism = {name: 0 for name in MAIN_PATHS}
    max_err = {name: 0 for name in MAIN_PATHS}

    def tally(name, r):
        mism[name] += r[0]
        max_err[name] = max(max_err[name], r[1])

    for case in V.CASES:
        tab = golden_table(case)
        expect = {i for i, r in enumerate(case.rows)
                  if r.height in case.expected_heights}
        q = query(case.scan_key_blob, case.spend_blob, case.label_blobs)
        nout = int(np.diff(tab["outputs"][1]).max())
        for wire in ("x", "xy"):
            planes, _ = pack_rows(tab, len(case.rows), wire)
            plain = {}
            for ladder in LADDERS:
                tally(ladder, compare(case.name, ladder, planes, None, q,
                                      wire, expect, plain=plain))
        for hi in CUTS:
            planes, _ = pack_rows(tab, len(case.rows), "x", hi_only=hi)
            plain = {}
            for ladder in LADDERS:
                tally("hi", compare(case.name, ladder, planes, None, q, "x",
                                    expect, hi_only=hi, nout=nout,
                                    plain=plain))
    phase("golden", f"{len(V.CASES)} cases x {len(LADDERS)} ladders x "
          f"(2 exact wires: kernel == plain == expected; 3 cut wires: "
          f"kernel == plain >= expected; the fixed ladder's plain version "
          f"once a case and wire)")

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
    # K12: each cut wire, outputs exact and corrupted below the cut (the
    # planted rows must still flag), and one dead-tile batch
    flagged = {}
    for hi in CUTS:
        for below in (0, BELOW_CUT[hi]):
            planes, _ = pack_rows(table, RANDOM_ROWS, "x", hi_only=hi,
                                  below=below)
            for ladder in LADDERS:
                r = compare(f"random/below={below:#x}", ladder, planes,
                            None, q, "x", exp_r, pack_flags=True,
                            hi_only=hi, nout=OUTPUTS_PER_ROW)
                tally("hi", r)
            flagged[f"{hi}{'/corrupted' if below else ''}"] = r[2]
    planes, bmask = pack_rows(table, RANDOM_ROWS, "x", live_rows=live,
                              hi_only="hi8")
    for ladder in LADDERS:
        tally("hi", compare("blockmask", ladder, planes, bmask, q, "x",
                            exp_live, pack_flags=True, hi_only="hi8",
                            nout=OUTPUTS_PER_ROW))
    phase("kernel-vs-plain", f"{RANDOM_ROWS} random rows (wires x/xy, "
          f"int8/packed flags, {len(exp_r)} planted; cut wires with "
          f"outputs exact and corrupted below the cut, rows flagged "
          f"{flagged}) and a dead-tile batch, each ladder: mismatches "
          f"{mism}")

    # --- each ladder on each wire at the main path's launch shape, timed --
    width = ct.api.TILE_CUDA
    exp_w = set(planted[planted < width].tolist())
    sched, sp, lab, comb = q
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    reps = 10
    timing = {}
    plain_at = {(ladder, wire) for _, ladder, wire in MAIN_PATHS.values()}
    for wire in ("x", "xy") + CUTS:
        hi = wire if wire in CUTS else None
        planes, _ = pack_rows(table, width, "x" if hi else wire, hi_only=hi)
        for ladder in LADDERS:
            t0 = time.perf_counter()
            digits, static = sched.operands(ladder)
            kern = K.KERNELS[ladder]
            counts = kern.launches, kern.hi_launches

            def run():
                return K.scan_flags(*planes, digits, sp, lab, comb,
                                    pack_flags=True, wire="x" if hi else wire,
                                    ladder=ladder, static_sched=static,
                                    hi_only=hi, nout=OUTPUTS_PER_ROW)

            kf = run()
            ev[0].record()
            for _ in range(reps):
                run()
            ev[1].record()
            torch.cuda.synchronize()
            t = {"ms": ev[0].elapsed_time(ev[1]) / reps}
            if (ladder, wire) in plain_at:
                # the plain version once, on a main path's wire: its
                # time, its field products (the bound) and its flags
                reset_field_counts()
                ev[0].record()
                pf = K.scan_plain(*planes, digits, sp, lab, comb,
                                  wire="x" if hi else wire, ladder=ladder,
                                  static_sched=static, hi_only=hi,
                                  nout=OUTPUTS_PER_ROW)
                ev[1].record()
                torch.cuda.synchronize()
                t["plain_ms"] = ev[0].elapsed_time(ev[1])
                products, squares = field_counts()
                tally("hi" if hi else ladder, check(
                    f"main-batch/{ladder}/{wire}", kf, K.pack_flag_words(pf),
                    width, exp_w, superset=hi is not None))
                del pf
                nbytes = (sum(p.numel() * 4 for p in planes) + width // 8
                          + comb.numel() * 4 + sp.numel() * 4)
                ops, ops_old = imad_bounds(products, squares)
                by_ops = ops / IMAD_PER_S > nbytes / HBM_BYTES_PER_S
                t.update(products=products / width, squares=squares / width,
                         bound_by="operations" if by_ops else "bytes",
                         bound_ms=max(nbytes / HBM_BYTES_PER_S,
                                      ops / IMAD_PER_S) * 1e3,
                         bound_ms_products_only=max(
                             nbytes / HBM_BYTES_PER_S,
                             ops_old / IMAD_PER_S) * 1e3)
            kern.launches, kern.hi_launches = counts
            timing[ladder, wire] = t
            phase("kernel-time", f"{ladder}/{wire}, {width} rows: kernel "
                  f"{t['ms']:.3f} ms ({width / t['ms'] * 1e3:,.0f} rows/s)"
                  + (f", plain {t['plain_ms']:.1f} ms, bound "
                     f"{t['bound_ms']:.3f} ms by {t['bound_by']} "
                     f"({t['products']:.0f} field products and "
                     f"{t['squares']:.0f} squares a row; products only: "
                     f"{t['bound_ms_products_only']:.3f} ms)"
                     if "plain_ms" in t else "")
                  + f" | {smi} [{time.perf_counter() - t0:.1f} s]")
    def ratio(ladder, wire):
        return timing[ladder, wire]["ms"] / timing[ladder, "x"]["ms"]

    phase("kernel-ratios", "xy / x (the share upload='auto' models for "
          "full64): " + ", ".join(f"{ladder} {ratio(ladder, 'xy'):.4f}"
                                  for ladder in LADDERS)
          + "; cut / x: " + ", ".join(
              f"{ladder}/{hi} {ratio(ladder, hi):.4f}"
              for ladder in LADDERS for hi in CUTS) + f" | {smi}")

    # --- the main paths ---------------------------------------------------
    head = {k: (v[:4096] if k != "outputs" else
                (v[0][:4096 * OUTPUTS_PER_ROW], v[1][:4097]))
            for k, v in table.items()}
    main_launches = {}
    main_rows = {}
    for name, (fields, ladder, wire) in MAIN_PATHS.items():
        ct.scan(head, key, spend, config=ct.ScanConfig(**fields))  # warm-up
        for kern in K.KERNELS.values():
            kern.launches = kern.hi_launches = 0
        calls.reset()
        t0 = time.perf_counter()
        res = ct.scan(table, key, spend, config=ct.ScanConfig(**fields))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {n: kern.launches for n, kern in K.KERNELS.items()}
        cut = K.KERNELS[ladder].hi_launches
        packed = dict(calls.by_thread)
        # every batch was packed by the C packer on the feeder thread (the
        # exact pass's, on the caller's)
        if packed.get("cudasp-feeder") != res.metrics.batches or set(
                packed) - {"cudasp-feeder", "MainThread"} or (
                name != "hi" and "MainThread" in packed) or feeders():
            raise AssertionError(f"main path {name}: pack_wire calls by "
                                 f"thread {packed}, {res.metrics.batches} "
                                 f"batches")
        if not np.array_equal(res.indices, planted):
            raise AssertionError(
                f"main path {name}: {len(res.indices)} matches, expected "
                f"{len(planted)}; first differences "
                f"{np.setxor1d(res.indices, planted)[:10].tolist()}")
        if not np.array_equal(res.height, planted + 800_000):
            raise AssertionError(f"main path {name}: heights differ")
        # the path's kernel ran, and no other ladder's; the hi8 path ran
        # K12 and the exact pass on the fixed ladder's exact wire
        exact = counts[ladder] - cut
        if (cut if name == "hi" else counts[ladder]) <= 0 or any(
                n for other, n in counts.items() if other != ladder) or (
                name == "hi" and exact <= 0):
            raise AssertionError(f"main path {name}: launches {counts}, "
                                 f"{cut} on a cut wire")
        main_launches[name] = cut if name == "hi" else exact
        main_rows[name] = res.indices
        m = res.metrics
        kms = timing[ladder, wire]["ms"]
        extra = ""
        if name == "hi":
            extra = (f"; K12 launches {cut}, exact-pass launches {exact}, "
                     f"reverified_rows {m.reverified_rows}, "
                     f"{m.upload_bytes / MAIN_ROWS:.2f} B/row up")
        elif not fields.get("upload"):
            extra = (f"; auto chose {m.upload_mode} (kernel0 "
                     f"{m.kernel0_seconds * 1e3:.3f} ms, H2D by events "
                     f"{m.link_bytes_per_second / 1e9:.3f} GB/s, "
                     f"{m.h2d_seconds:.4f} s of H2D), cut-wire launches "
                     f"{cut}, {m.upload_bytes / MAIN_ROWS:.2f} B/row up")
        phase("main-path", f"ScanConfig({fields}): {MAIN_ROWS} rows in "
              f"{secs:.3f} s = {MAIN_ROWS / secs:,.0f} tx/s end to end; "
              f"C packer calls by thread {packed}; "
              f"{len(res.indices)} matches == planted; launches {counts}; "
              f"ladder {m.ladder}, upload {m.upload_mode}, {m.launch_rows} "
              f"rows a launch; pack {m.pack_seconds:.3f} s, staging "
              f"{m.upload_seconds:.3f} s, H2D {m.h2d_seconds:.4f} s, device "
              f"wait {m.device_wait_seconds:.3f} s, "
              f"{m.upload_bytes / 1e6:.1f} MB up; kernel-only "
              f"{width / kms * 1e3:,.0f} rows/s{extra} | {smi}")

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

    # --- the feeder's faults, the ramp -----------------------------------
    feeder_phase(table, planted, key, spend, calls, smi)
    ramp_phase(table, planted, key, spend, smi)

    # --- the reference's whole ScanConfig: tuning, the XLA backend ---------
    tuning_phase(smi)
    xla_golden_phase(smi)
    xla_main_path(table, planted, key, spend, main_rows["fixed"], smi)

    # --- the user surface: the stream (this slice's main path: killed and
    # resumed from its cursor), SQL, the CLI, tracing, batch retry -------
    surface = stream_phase(table, planted, key, spend, smi)
    surface["sql"] = sql_phase(smi)
    surface["cli (batches, its metrics line)"] = cli_phase(
        table, planted, key, spend, smi)
    surface["trace"] = trace_phase(table, key, spend, smi)
    surface["retry"] = retry_phase(table, planted, key, spend, smi)

    # --- the sharded scan: against the single launch and the plain
    # version, timed; the mesh main paths; two processes on gloo ---------
    sharded = sharded_phase(table, planted, key, spend, smi)
    mesh_launches, exchange = mesh_main_paths(table, planted, key, spend,
                                              calls, smi)
    multihost_phase()

    # --- the probe kernels: each case against its plain version, then
    # the probe tools' own run at the scan's launch width -----------------
    from cudasp_tpu_torch.tools import alu_probe, microbench, stage_profile

    t0 = time.perf_counter()
    comb = K.comb_table("cuda")
    pv = {k: [0, 0, 0] for k in P.ProbeLibrary.KERNEL_NAMES}
    # every case at 1 and 3 repeats on a few lanes, then once more at the
    # scan's launch width, the width the probe tools run at
    for lanes, repeats in ((PROBE_LANES, (1, 3)), (width, (1,))):
        res = probe_vs_plain(torch.device("cuda"), comb, lanes, repeats)
        for k, v in res.items():
            pv[k] = [pv[k][0] + v[0], max(pv[k][1], v[1]), pv[k][2] + v[2]]
        phase("probe-vs-plain", f"{lanes} lanes, repeats {repeats}: "
              + ", ".join(f"{k} {v[2]} cases, mismatches {v[0]}, max "
                          f"|err| {v[1]}" for k, v in res.items())
              + f" [{time.perf_counter() - t0:.1f} s]")
        t0 = time.perf_counter()
    t0 = time.perf_counter()
    for name in P.PROBES.launches:
        P.PROBES.launches[name] = 0
    for kern in K.KERNELS.values():
        kern.launches = kern.hi_launches = 0
    alu = alu_probe.main([])
    bench = microbench.main([])
    stages = stage_profile.main([])
    torch.cuda.synchronize()
    probe_launches = dict(P.PROBES.launches)
    full_launches = K.KERNELS["fixed"].launches
    if min(probe_launches.values()) <= 0 or full_launches <= 0:
        raise AssertionError(f"probe tools: launches {probe_launches}, "
                             f"scan kernel {full_launches}")
    imad = alu["int32 mul+add"]["ops_per_s"]
    fmul = bench["field mul"]["per_s"]
    fsqr = bench["field sqr"]["per_s"]
    implied = IMAD_PER_S / IMAD_PER_PRODUCT
    implied_sqr = IMAD_PER_S / IMAD_PER_SQUARE
    x_alu = P.to_device(P.raw_planes(np.random.default_rng(SEED),
                                     (8, width // 8), low=1), "cuda")
    clocks = sm_clock_under_load(x_alu)
    sm_mhz = float(clocks.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    at_clock = 64 * sms * sm_mhz * 1e6
    phase("probe-time", f"tools at {width} lanes: launches "
          f"{probe_launches} (+ {full_launches} scan launches for FULL); "
          f"int32 mul+add {imad / 1e12:.3f} T/s measured against the "
          f"peak IMAD_PER_S {IMAD_PER_S / 1e12:.3f} T/s ({imad / IMAD_PER_S:.3f}"
          f"x); SM clock under that load, max: {clocks}; 64 x {sms} SMs "
          f"at that clock {at_clock / 1e12:.3f} T/s ({imad / at_clock:.3f}"
          f"x); field mul {fmul / 1e9:.1f} G products/s measured against "
          f"{implied / 1e9:.1f} G implied ({fmul / implied:.3f}x: "
          f"{IMAD_PER_S / fmul:.0f} multiply-adds' time a product), field "
          f"sqr {fsqr / 1e9:.1f} G/s against {implied_sqr / 1e9:.1f} G "
          f"implied ({fsqr / implied_sqr:.3f}x: {IMAD_PER_S / fsqr:.0f} a "
          f"square); stages "
          + ", ".join(f"{n} {stages[n]['ns_per_row']:.2f}"
                      for n in P.STAGES)
          + f" ns/row; budget {stages['budget']['ns_per_row']:.2f} against "
          f"FULL {stages['FULL']['ns_per_row']:.2f} ns/row "
          f"({stages['budget']['share']:.1%}) | {smi} "
          f"[{time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    probes = probe_entries(torch.device("cuda"), comb)
    phase("probe-entries", " | ".join(
        f"{k} ({v['case']}, {v['iters']} repeats, {v['lanes']} lanes): "
        f"kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.1f} ms, bound "
        f"{v['bound_ms']:.4f} ms by {v['bound_by']}"
        for k, v in probes.items()) + f" | {smi} "
        f"[{time.perf_counter() - t0:.1f} s]")

    # --- the slice's tools ------------------------------------------------
    ablate = tools_phase(stages, smi)

    # --- the bench and the curve; the oracle CLI on the card host --------
    oracle_cli_phase(smi)
    bench_curve_phase(smi)

    def probe_entry(name):
        v = probes[name]
        return {
            "name": name, "route": "cuda",
            "source": "cudasp_tpu_torch/csrc/probe.cu",
            "replaces": PROBE_REPLACES[name],
            "launches": probe_launches[name],
            "mismatches": pv[name][0], "cases": pv[name][2],
            "max_abs_err": max(pv[name][1], v["max_abs_err"]),
            "ms": v["ms"], "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": None, "case": v["case"], "iters": v["iters"],
            "lanes": v["lanes"], "products": v["products"],
            "squares": v["squares"],
            "bound_ms_products_only": v["bound_ms_products_only"],
            "sass": {n: c for n, c in sass.items() if n.startswith("bench")}
            if name == "bench_kernel" else None}

    def entry(name):
        _, ladder, wire = MAIN_PATHS[name]
        t = timing[ladder, wire]
        e = {
            "name": KERNEL_NAMES[name],
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "wire": wire,
            "launches": main_launches[name],
            "mismatches": mism[name],
            "max_abs_err": max_err[name],
            "ms": t["ms"],
            "ms_x": timing[ladder, "x"]["ms"],
            "ms_xy": timing[ladder, "xy"]["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "products_per_row": t["products"],
            "squares_per_row": t["squares"],
            "bound_ms_products_only": t["bound_ms_products_only"],
            "ptxas": ptxas.get(ladder),
            "sass": sass.get(ladder),
            "library_ms": None,
        }
        if name == "hi":
            e.update({f"ms_{lad}_{hi}": timing[lad, hi]["ms"]
                      for lad in LADDERS for hi in CUTS})
        if name == "fixed":
            e["launches_by_path"] = {k: v for k, v in surface.items()
                                     if k != "stream-mesh"}
            # ablate_probe's SP_ABLATE variants of this kernel: base - the
            # variant's ms, a stage each
            e["ablate_stage_ms"] = {n: v["cost_ms"] for n, v in
                                    ablate["stages"].items()}
            e["ablate_base_ms"] = ablate["base_ms"]
        return e

    sharded_entry = {
        "name": "scan_kernel_sharded", "route": "cuda",
        "source": "cudasp_tpu_torch/csrc/scan.cu",
        "wrapper": "cudasp_tpu_torch/ops/kernels.py:scan_flags_sharded",
        "replaces": "cudasp_tpu/ops/kernels.py:832-893",
        "mesh": "4 x cuda:0", "wire": "x",
        "launches": mesh_launches["mesh4"],
        "launches_by_path": {**mesh_launches,
                             "stream-mesh": surface["stream-mesh"]},
        "mismatches": sharded["mismatches"],
        "max_abs_err": sharded["max_abs_err"],
        "ms": sharded["ms"], "single_ms": sharded["single_ms"],
        "runs_ms": sharded["runs_ms"], "plain_ms": sharded["plain_ms"],
        "bound_ms": sharded["bound_ms"], "bound_by": sharded["bound_by"],
        "products_per_row": sharded["products_per_row"],
        "squares_per_row": sharded["squares_per_row"],
        "bound_ms_products_only": sharded["bound_ms_products_only"],
        "exchange_ms": exchange["mesh4"]["ms"],
        "exchange_host_ms": exchange["mesh4"]["host_ms"],
        "all_cards": sharded["all_cards"] and {
            **sharded["all_cards"],
            "exchange_ms": exchange["all-cards"]["ms"]},
        "library_ms": None}
    print(json.dumps({"kernels": [entry(name) for name in MAIN_PATHS]
                      + [sharded_entry]
                      + [probe_entry(name) for name in PROBE_ENTRIES]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-worker"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(multihost_worker(*map(int, sys.argv[2:4]), sys.argv[4]))
    sys.exit(main())
