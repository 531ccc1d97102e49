"""The port's wNAF and per-key static ladders against the JAX package: the
schedules equal the JAX package's, the plain ladders compute the oracle's
k x P, the plain golden flags of each ladder equal the expected rows, and
scan(ladder="wnaf") / scan(static_key=True) return the JAX oracle's rows.
Plus the ladder's config resolution and the per-key build: its digest, its
disk and process cache, and its care with the key (private directories,
no generated source or schedule left behind), through a stand-in nvcc
that builds a stub library with g++."""

import os
import shutil
import stat
import sys

import numpy as np
import pytest
import torch

from cudasp_tpu.ops import scalar as JS
from cudasp_tpu.oracle import ec as JO
from cudasp_tpu.oracle import encoding as JE
from cudasp_tpu.oracle import pipeline as JP
from cudasp_tpu.oracle import vectors as JV

import cudasp_tpu_torch as ct
from cudasp_tpu_torch import api as TA
from cudasp_tpu_torch.io import ingest as TI
from cudasp_tpu_torch.ops import field as TF
from cudasp_tpu_torch.ops import kernels as TK
from cudasp_tpu_torch.ops import scalar as TS
from cudasp_tpu_torch.runtime import executor
from cudasp_tpu_torch.runtime.executor import BatchExecutor

G = (JO.GX, JO.GY)
N = JO.N
BR = 32
SMALL_KEY = (1 << 95) + 12345          # below ~2^96: GLV half 2 is empty
EDGE_KEYS = [0, 1, 3, N - 1, N, SMALL_KEY, (1 << 255) - 19]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the machine
    (measured: 5x slower for these files), and these tensors are small."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "big") for _ in range(n)]


def test_wnaf_schedules_equal_jax():
    for k in EDGE_KEYS + _keys(11, 200):
        np.testing.assert_array_equal(TS.glv_wnaf_steps(k),
                                      JS.glv_wnaf_steps(k))
        assert TS.glv_wnaf_static(k) == JS.glv_wnaf_static(k), k
    # k == 0 and k == 1 (mod n): one step, the +P init
    for k in (0, 1, N, N + 1):
        assert TS.glv_wnaf_static(k) == ((0, 32),)
    assert not any((code >> 4) & 1 for _, code in
                   TS.glv_wnaf_static(SMALL_KEY))


def _affine(x, y, z):
    zi = TF.inv(z)
    zi2 = TF.sqr(zi)
    xs = TF.canonical(TF.mul(x, zi2))
    ys = TF.canonical(TF.mul(y, TF.mul(zi, zi2)))
    return [(TF.limbs_to_int(xs[i]), TF.limbs_to_int(ys[i]))
            for i in range(x.shape[0])]


@pytest.mark.parametrize("ladder", ["wnaf", "static"])
def test_plain_ladder_gives_oracle_k_times_p(ladder):
    rng = np.random.default_rng(12)
    pts = [JO.ec_mul(G, int(k)) for k in rng.integers(1, 2**62, size=4)]
    tw = torch.from_numpy(np.stack(
        [np.concatenate([TF.int_to_words(p[0]), TF.int_to_words(p[1])])
         for p in pts], axis=1).view(np.int32))          # (16, 4), wire xy
    ovm = torch.zeros((1, len(pts)), dtype=torch.int32)
    # n has the schedule of 0 (test_wnaf_schedules_equal_jax)
    for k in [k for k in EDGE_KEYS if k != N] + _keys(13, 2):
        got = _affine(*TK.stage_ecdh(tw, ovm, TS.glv_wnaf_steps(k), "xy",
                                     ladder, TS.glv_wnaf_static(k)))
        # k == 0 (mod n) is the defined +P of the JAX package
        want = [p if k % N == 0 else JO.ec_mul(p, k) for p in pts]
        assert got == want, hex(k)


def _plain_case_flags(case, wire, ladder):
    rows = case.rows
    blobs = np.stack([np.frombuffer(r.tweak_blob, np.uint8) for r in rows])
    flat = np.concatenate([np.asarray(r.outputs, np.int64) for r in rows])
    offs = np.cumsum([0] + [len(r.outputs) for r in rows]).astype(np.int64)
    b = next(TI.iter_packed(blobs, flat, offs, len(blobs), 2))
    planes = TK.pack_batch_arrays(b.tweak_blobs, b.row_valid, b.outputs_hi,
                                  b.outputs_lo, b.outputs_valid,
                                  block_rows=BR, wire=wire)
    sched, sp, lab, _ = TI.pack_query_keys(
        case.scan_key_blob, case.spend_blob, case.label_blobs)
    digits, static = sched.operands(ladder)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))

    flags = TK.scan_flags(*(t(p) for p in planes), digits, t(sp), t(lab),
                          TK.comb_table("cpu"), block_rows=BR, wire=wire,
                          ladder=ladder, static_sched=static)
    return (flags[0, :len(rows)].numpy() != 0).tolist()


@pytest.mark.parametrize("ladder", ["wnaf", "static"])
def test_plain_golden_flags_per_ladder(ladder):
    for case in JV.CASES:
        want = [r.height in case.expected_heights for r in case.rows]
        for wire in ("x", "xy"):
            assert _plain_case_flags(case, wire, ladder) == want, (
                case.name, wire)


@pytest.fixture(scope="module")
def seeded():
    return _seeded_table(21)


def _seeded_table(seed, n=40, pool=5):
    """A small table over `pool` points with base and label matches, and
    the JAX oracle's matching rows (a row matches when one of its outputs
    is among its point's candidate values, as in the oracle's
    scan_row)."""
    rng = np.random.default_rng(seed)
    key = int.from_bytes(rng.bytes(32), "big") % N
    spend = JO.ec_mul(G, int(rng.integers(1, 2**62)))
    label = JO.ec_mul(G, int(rng.integers(1, 2**62)))
    pts = [JO.ec_mul(G, int(k)) for k in rng.integers(1, 2**62, size=pool)]
    cands = [JP.candidate_values(p, key, spend, [label]) for p in pts]
    pick = rng.integers(0, pool, size=n)
    outputs = []
    for j in pick:
        outs = [int(v) for v in rng.integers(-2**62, 2**62, size=3)]
        r = rng.random()
        if r < 0.25:
            outs[int(rng.integers(0, 3))] = cands[j][0]
        elif r < 0.4:
            outs[int(rng.integers(0, 3))] = cands[j][1]
        outputs.append(outs)
    table = {"height": np.arange(n, dtype=np.int64),
             "tweak_key": np.stack([np.frombuffer(JE.point_to_blob64(pts[j]),
                                                  np.uint8) for j in pick]),
             "outputs": outputs}
    want = np.flatnonzero([bool(set(o) & set(cands[j]))
                           for j, o in zip(pick, outputs)])
    return (table, JE.scalar_to_blob32(key), JE.point_to_blob64(spend),
            [JE.point_to_blob64(label)], want)


@pytest.mark.parametrize("cfg", [dict(ladder="wnaf"), dict(static_key=True)],
                         ids=["wnaf", "static_key"])
def test_scan_ladder_rows_equal_jax_oracle(seeded, cfg):
    table, key, spend, labels, want = seeded
    assert 5 < len(want) < 30
    res = ct.scan(table, key, spend, labels, device="cpu",
                  config=ct.ScanConfig(block_rows=BR, **cfg))
    np.testing.assert_array_equal(res.indices, want)
    assert res.metrics.ladder == ("static" if "static_key" in cfg
                                  else "wnaf")


def test_ladder_config_resolution(monkeypatch):
    monkeypatch.delenv("CUDASP_LADDER", raising=False)
    assert TA.resolve_ladder(ct.ScanConfig()) == "fixed"
    assert TA.resolve_ladder(ct.ScanConfig(ladder="wnaf")) == "wnaf"
    assert TA.resolve_ladder(ct.ScanConfig(ladder="wnaf",
                                           static_key=True)) == "static"
    monkeypatch.setenv("CUDASP_LADDER", "wnaf")         # fills "auto" only
    assert TA.resolve_ladder(ct.ScanConfig()) == "wnaf"
    assert TA.resolve_ladder(ct.ScanConfig(ladder="fixed")) == "fixed"
    monkeypatch.setenv("CUDASP_LADDER", "comb")
    with pytest.raises(ct.BindError):
        TA.resolve_ladder(ct.ScanConfig())
    monkeypatch.delenv("CUDASP_LADDER")
    case = JV.CASES[0]
    table = {"tweak_key": np.frombuffer(case.rows[0].tweak_blob,
                                        np.uint8)[None],
             "outputs": [list(case.rows[0].outputs)]}
    with pytest.raises(ct.BindError, match="ladder"):
        ct.scan(table, case.scan_key_blob, case.spend_blob, device="cpu",
                config=ct.ScanConfig(ladder="comb"))
    with pytest.raises(ValueError):
        BatchExecutor("cpu", ladder="comb")


def test_static_schedule_checked_and_digest_per_key():
    a, b = TS.glv_wnaf_static(_keys(14, 1)[0]), TS.glv_wnaf_static(3)
    again = [list(step) for step in TS.glv_wnaf_static(_keys(14, 1)[0])]
    assert TK.static_digest(a) == TK.static_digest(again)
    assert TK.static_digest(a) != TK.static_digest(b)
    assert TK.static_digest(a) in TK.static_source(a)
    for bad in ([], [(1, 32)], [(0, 0)], [(0, 32), (256, 0)],
                [(0, 32), (1, 64)], [(0, 32.0)], [(0, "32")], [(0,)],
                [(0, 32)] * (TS.WNAF_STEPS + 1)):
        with pytest.raises(ValueError):
            TK.check_static_sched(bad)


FAKE_NVCC = r'''#!{python}
# Stands in for nvcc: checks that the generated source is private, then
# builds a stub library with the static entry point, or fails quoting a
# line of the source as nvcc would.
import os, stat, subprocess, sys
args = sys.argv[1:]
out, src = args[args.index("-o") + 1], args[-1]
if stat.S_IMODE(os.stat(src).st_mode) & 0o077:
    sys.exit("generated source readable by others")
if os.environ.get("FAKE_NVCC_FAIL"):
    line = [ln for ln in open(src) if "Step<" in ln][0]
    sys.exit("key.cu(12): error: bad step\n" + line + "ptxas fatal")
stub = out + ".c"
with open(stub, "w") as f:
    f.write("int cudasp_scan_static_launch(void) { return 0; }\n")
subprocess.run(["g++", "-x", "c", "-shared", "-fPIC", "-o", out, stub],
               check=True)
os.remove(stub)
print("ptxas info    : Used 40 registers")
'''


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.replace("{python}", sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    root = tmp_path / "build"
    monkeypatch.setattr(TK, "_BUILD_ROOT", str(root))
    return root


def _mode(path):
    return stat.S_IMODE(os.stat(path).st_mode)


def test_static_build_cache_keeps_the_key_private(fake_nvcc, monkeypatch):
    assert shutil.which("g++"), "g++ builds the stand-in nvcc's stub"
    a, b, c = (TS.glv_wnaf_static(k) for k in _keys(15, 3))
    kern = TK.ScanKernel("static")
    lib = kern.library(a)
    out = fake_nvcc / "static" / TK.static_digest(a)
    assert kern.nvcc_runs == 1 and kern.build_seconds is not None
    assert _mode(fake_nvcc / "static") == _mode(out) == 0o700
    assert sorted(os.listdir(out)) == ["libcudasp_scan_static.so",
                                       "nvcc.log"]
    # a second scan with the key builds nothing: in the process ...
    assert kern.library(list(a)) is lib and kern.nvcc_runs == 1
    # ... or in a new one, from the disk
    fresh = TK.ScanKernel("static")
    fresh.library(a)
    assert fresh.nvcc_runs == 0 and fresh.build_seconds is None
    kern.library(b)
    assert kern.nvcc_runs == 2
    # a failed build raises without the schedule and leaves nothing behind
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    with pytest.raises(RuntimeError, match="nvcc failed") as err:
        kern.library(c)
    assert "Step<" not in str(err.value) and "ptxas fatal" in str(err.value)
    assert os.listdir(fake_nvcc / "static" / TK.static_digest(c)) == []
    for steps in (a, b, c):
        logs = [kern.build_log, str(err.value)]
        assert not any(repr(steps)[1:-1] in s for s in logs)


def test_static_key_scan_raises_before_any_batch_when_nvcc_fails(
        seeded, fake_nvcc, monkeypatch):
    """ScanConfig(static_key=True) on a GPU: a failed per-key build raises
    before the executor stages a batch, and no other ladder runs."""
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def no_batches(*a, **k):
        raise AssertionError("a batch ran after a failed build")

    # the executor's device stages (staging and launches on the card, or
    # the plain version): neither may be set up after the failed build
    monkeypatch.setattr(executor, "_Cuda", no_batches)
    monkeypatch.setattr(executor, "_Cpu", no_batches)
    table, key, spend, labels, _ = seeded
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ct.scan(table, key, spend, labels,
                config=ct.ScanConfig(static_key=True))
