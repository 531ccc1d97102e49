"""The prefilter wires of the port (hi32 / hi16 / hi8) against the JAX
package: batch packing is byte-identical, the plain version's cut flags
equal the JAX kernel's in interpret mode (exact values, values corrupted
below the cut, and above it), scan() on a cut returns the exact rows
through the exact second pass, and upload="auto" follows the reference's
model (cudasp_tpu/runtime/executor.py:361-392)."""

import numpy as np
import pytest
import torch

from cudasp_tpu.ops import kernels as JK
from cudasp_tpu.oracle import ec as JO
from cudasp_tpu.oracle import encoding as JE
from cudasp_tpu.oracle import pipeline as JP
from cudasp_tpu.oracle import vectors as JV

import cudasp_tpu_torch as ct
from cudasp_tpu_torch.io import ingest as TI
from cudasp_tpu_torch.ops import kernels as TK
from cudasp_tpu_torch.runtime import executor as TX

CUTS = ["hi32", "hi16", "hi8"]
JAX_HI = {"hi32": True, "hi16": "hi16", "hi8": "hi8"}
SMALL = dict(block_rows=32)     # 128-row batches keep the CPU runs short


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the machine
    (measured: 5x slower for these files), and these tensors are small."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed, B=45, M=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(B, 64), dtype=np.uint8),
            rng.random(B) < 0.9,
            rng.integers(-2**31, 2**31, size=(B, M)).astype(np.int32),
            rng.integers(-2**31, 2**31, size=(B, M)).astype(np.int32),
            rng.random((B, M)) < 0.7)


@pytest.mark.parametrize("hi_only", CUTS)
def test_pack_batch_arrays_cut_byte_identical(hi_only):
    for seed, M in enumerate((1, 3, 4, 6)):
        args = _batch(seed, M=M)
        ours = TK.pack_batch_arrays(*args, block_rows=32, hi_only=hi_only)
        ref = JK.pack_batch_arrays(*args, block_rows=32,
                                   hi_only=JAX_HI[hi_only])
        assert len(ours) == len(ref) == 4
        for a, r in zip(ours, ref):
            assert a.dtype == r.dtype == np.uint32
            assert a.shape == r.shape
            assert a.tobytes() == r.tobytes()
        assert ours[1].shape[0] == TK.hi_plane_rows(hi_only, M)
    # the limits of the packed validity unit, and no cut on the xy wire
    too_wide = {"hi16": 15, "hi8": 7}.get(hi_only)
    for pack, hi in ((TK.pack_batch_arrays, hi_only),
                     (JK.pack_batch_arrays, JAX_HI[hi_only])):
        if too_wide:
            with pytest.raises(ValueError):
                pack(*_batch(9, M=too_wide), block_rows=32, hi_only=hi)
        with pytest.raises(ValueError):
            pack(*_batch(9), block_rows=32, hi_only=hi, wire="xy")


def _case3(M):
    """Golden case 3 (labels) tiled to 128 rows, as the JAX package's own
    interpret-mode tests build it."""
    from tests.test_kernels import _kernel_case_arrays

    case = JV.CASES[3]
    arrays = _kernel_case_arrays(case, 128, M=M)
    sched, sp, lab, _ = TI.pack_query_keys(case.scan_key_blob,
                                           case.spend_blob,
                                           case.label_blobs)
    return arrays, sched, sp, lab


# the JAX programs of tests/test_wnaf_hi32.py's interpret parity tests
# (same ladder, output width and static arguments), so the two files
# share their compiles
JAX_PROGRAM = {"hi32": ("wnaf", 8), "hi16": ("fixed", 8), "hi8": ("fixed", 4)}
BELOW = {"hi32": 0, "hi16": 0x5A5A, "hi8": 0x5A5A5A}


@pytest.mark.parametrize("hi_only", CUTS)
def test_plain_cut_flags_equal_jax_interpret(hi_only):
    """On golden case 3 at B = 128: the plain version's flags equal the
    JAX kernel's in interpret mode with the outputs exact, with their bits
    below the cut corrupted (still flagged: a superset), and with their
    top bit flipped (no row flags)."""
    import jax.numpy as jnp

    ladder, M = JAX_PROGRAM[hi_only]
    (tweaks, oh, ol, ov, expect, sx, sy, lx, ly, nl, _), sched, sp, lab = \
        _case3(M)
    digits = sched.operands(ladder)[0]
    B = len(expect)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))

    def both(oh_, ol_):
        planes = JK.pack_batch_arrays(tweaks, np.ones(B, bool), oh_, ol_,
                                      ov, 128, hi_only=JAX_HI[hi_only])
        nout = {} if hi_only == "hi32" else {"nout": M}
        ref = np.asarray(JK._scan_pallas_call(
            *(jnp.asarray(a) for a in planes), jnp.asarray(digits),
            jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(lx),
            jnp.asarray(ly), JK.comb_table_kernel(), nlabels=nl,
            block_rows=128, interpret=True, ladder=ladder,
            hi_only=JAX_HI[hi_only], **nout))[0] != 0
        ours = TK.pack_batch_arrays(tweaks, np.ones(B, bool), oh_, ol_, ov,
                                    128, hi_only=hi_only)
        got = TK.scan_flags(*(t(p) for p in ours), digits, t(sp), t(lab),
                            TK.comb_table("cpu"), block_rows=128,
                            ladder=ladder, hi_only=hi_only, nout=M)
        np.testing.assert_array_equal(got[0].numpy() != 0, ref)
        return ref

    assert expect.any()
    np.testing.assert_array_equal(both(oh, ol), expect)
    low = np.where(ov, BELOW[hi_only], 0).astype(np.int32)
    np.testing.assert_array_equal(
        both(oh ^ low, ol ^ np.where(ov, -1, 0).astype(np.int32)), expect)
    top = np.where(ov, np.int32(-2**31), 0).astype(np.int32)
    assert not both(oh ^ top, ol).any()


def _decoy_table(seed, n=100, M=3, pool=6, share=0.2, decoy=0.15):
    """Rows over `pool` oracle points with M outputs each: a `share` of
    them carry the row's true upper-64 value (planted), a `decoy` share
    that value with its lowest bit flipped (decoys: every cut flags them,
    the exact wire does not)."""
    rng = np.random.default_rng(seed)
    key = int.from_bytes(rng.bytes(32), "big") % JO.N
    spend = JO.ec_mul((JO.GX, JO.GY), int(rng.integers(1, 2**62)))
    pts = [JO.ec_mul((JO.GX, JO.GY), int(k))
           for k in rng.integers(1, 2**62, size=pool)]
    vals = [JP.candidate_values(p, key, spend)[0] for p in pts]
    pick = rng.integers(0, pool, size=n)
    outputs = [[int(v) for v in rng.integers(-2**62, 2**62, size=M)]
               for _ in range(n)]
    r = rng.random(n)
    planted, decoys = np.flatnonzero(r < share), np.flatnonzero(
        r >= 1 - decoy)
    for rows, flip in ((planted, 0), (decoys, 1)):
        for i in rows:
            outputs[i][int(rng.integers(0, M))] = vals[pick[i]] ^ flip
    table = {"height": np.arange(n, dtype=np.int64),
             "tweak_key": np.stack([np.frombuffer(
                 JE.point_to_blob64(pts[j]), np.uint8) for j in pick]),
             "outputs": outputs}
    return (table, JE.scalar_to_blob32(key), JE.point_to_blob64(spend),
            planted, decoys)


def _packed(table, batch, M=3):
    flat, offs = TI.outputs_to_csr(table["outputs"])
    return TI.iter_packed(table["tweak_key"], flat, offs, batch, M)


def _executor_rows(table, key, spend, upload, batch=32):
    """The executor alone on 32-row batches: (matched rows, metrics)."""
    from cudasp_tpu_torch.runtime.metrics import ScanMetrics

    sched, sp, lab, _ = TI.pack_query_keys(key, spend, ())
    m = ScanMetrics()
    out = TX.BatchExecutor("cpu", block_rows=32, upload=upload).run(
        _packed(table, batch), sched, sp, lab, m)
    return np.unique(np.concatenate(
        [src[fl & (src >= 0)] for fl, src in out])), m


@pytest.fixture(scope="module")
def decoys():
    return _decoy_table(21)


@pytest.mark.parametrize("upload", CUTS)
def test_scan_cut_exact_pass_gives_the_exact_rows(decoys, upload):
    table, key, spend, planted, dec = decoys
    res = ct.scan(table, key, spend, device="cpu",
                  config=ct.ScanConfig(upload=upload, **SMALL))
    np.testing.assert_array_equal(res.indices, planted)
    m = res.metrics
    assert m.upload_mode == upload
    # every planted row and decoy went through the exact pass; hi16 and
    # hi8 may also flag random outputs that share the top bits
    assert m.reverified_rows >= len(planted) + len(dec)
    if upload == "hi32":
        assert m.reverified_rows == len(planted) + len(dec)


def test_hi8_above_six_outputs_runs_hi16_with_a_warning():
    table, key, spend, planted, _ = _decoy_table(22, n=40, M=7)
    with pytest.warns(UserWarning, match="using hi16"):
        res = ct.scan(table, key, spend, device="cpu",
                      config=ct.ScanConfig(upload="hi8", **SMALL))
    np.testing.assert_array_equal(res.indices, planted)
    assert res.metrics.upload_mode == "hi16"
    assert res.metrics.reverified_rows >= len(planted)


def test_auto_is_full_on_the_cpu_and_cudasp_upload_fills_auto_only(
        decoys, monkeypatch):
    table, key, spend, planted, _ = decoys
    head = {k: v[:40] for k, v in table.items()}
    want = planted[planted < 40]
    cases = [(None, ct.ScanConfig(**SMALL), "full"),
             ("hi8", ct.ScanConfig(**SMALL), "hi8"),
             ("hi8", ct.ScanConfig(upload="full", **SMALL), "full")]
    for env, cfg, mode in cases:
        if env is None:
            monkeypatch.delenv("CUDASP_UPLOAD", raising=False)
        else:
            monkeypatch.setenv("CUDASP_UPLOAD", env)
        res = ct.scan(head, key, spend, device="cpu", config=cfg)
        np.testing.assert_array_equal(res.indices, want)
        assert res.metrics.upload_mode == mode
    monkeypatch.setenv("CUDASP_UPLOAD", "hi4")
    with pytest.raises(ct.BindError):
        ct.scan(head, key, spend, device="cpu", config=ct.ScanConfig())


def test_exact_pass_failure_raises_execution_error(decoys, monkeypatch):
    """A failure in the exact pass carries the index of the batch whose
    flagged rows it was re-scanning; nothing falls back to another wire."""
    table, key, spend, _, _ = decoys
    real = TK.scan_flags

    def exact_fails(*a, hi_only=None, **kw):
        if hi_only is None:
            raise RuntimeError("injected")
        return real(*a, hi_only=hi_only, **kw)

    monkeypatch.setattr(TK, "scan_flags", exact_fails)
    with pytest.raises(ct.ExecutionError) as err:
        ct.scan(table, key, spend, device="cpu", batch_size=64,
                config=ct.ScanConfig(upload="hi32", **SMALL))
    assert err.value.batch_index == 0 and "injected" in str(err.value)


@pytest.mark.parametrize("mode,bytes_per_row",
                         [("full64", 92), ("full", 60), ("hi32", 48),
                          ("hi16", 40), ("hi8", 36)])
def test_wire_bytes_per_row_at_three_outputs(decoys, mode, bytes_per_row):
    """What a row puts on the wire at M = 3, counted on the planes the
    card's staging sends (a cut's dummies stay behind), before the
    blockmask row."""
    planes, _ = TX._planes(next(_packed(decoys[0], 32)), 32, mode)
    sent = sum(p.nbytes for p in TX.wire_planes(planes, mode))
    assert sent == 32 * bytes_per_row == 32 * 4 * TX.wire_rows(mode, 3)


def _reference_decide(k0, ups, w, M, cut, want, veto, sqrt_share):
    """cudasp_tpu/runtime/executor.py:361-392, _decide, as written there
    (upload_state's fields as arguments; returns the new `want`)."""
    rate = max(sent / dt for dt, sent in ups[-4:])
    cut_rows = (8 + M + 1 if cut == "hi32"
                else 8 + (M + 2) // 2 if cut == "hi16"
                else 8 + (M + 4) // 4)
    cand = {
        "full64": max(4 * w * (16 + 2 * M + 1) / rate,
                      k0 * (1.0 - sqrt_share)),
        "full": max(4 * w * (8 + 2 * M + 1) / rate, k0),
        cut: max(4 * w * cut_rows / rate, k0),
    }
    if veto:
        del cand[cut]
    cur = want or "full"
    best = min(cand, key=cand.get)
    if best != cur and cand[best] < 0.85 * cand.get(cur, float("inf")):
        want = None if best == "full" else best
    return want


def test_auto_decide_follows_the_reference_model():
    width, M, share = 262_144, 3, TX.XY_KERNEL_SHARE["fixed"]
    k0 = 0.016
    # named cases: a slow link picks the cut, a fast one keeps full (the
    # full64 gain of 1 - 14.945 / 16.158 = 7.5% is under the hysteresis),
    # a kernel 20% faster on full64 takes it, the veto drops the cut
    assert TX.auto_decide(k0, 50e6, width, M, "hi8", "full", False,
                          share) == "hi8"
    assert TX.auto_decide(k0, 25e9, width, M, "hi8", "full", False,
                          share) == "full"
    assert TX.auto_decide(k0, 25e9, width, M, "hi8", "full", False,
                          0.8) == "full64"
    assert TX.auto_decide(k0, 50e6, width, M, "hi8", "full", True,
                          share) == "full"
    assert TX.auto_decide(k0, 50e6, width, M, "hi8", "hi8", True,
                          share) == "full"
    # hysteresis: hi8 stays while full is at most 15% faster
    mid = 4 * width * TX.wire_rows("full", M) / (0.9 * k0)
    assert TX.auto_decide(k0, mid, width, M, "hi8", "hi8", False,
                          share) == "hi8"
    # and on a grid, the reference's own formula
    rng = np.random.default_rng(5)
    for _ in range(400):
        k0 = float(rng.uniform(1e-3, 0.05))
        rate = float(10 ** rng.uniform(6.5, 10.5))
        w = int(rng.choice([4096, 65_536, 262_144]))
        M = int(rng.integers(1, 7))
        cut = str(rng.choice(CUTS))
        cur = str(rng.choice(["full", "full64", cut]))
        veto = bool(rng.random() < 0.3)
        if veto and cur == cut:
            cur = "full"
        ref = _reference_decide(k0, [(1.0, rate)], w, M, cut,
                                None if cur == "full" else cur, veto,
                                1.0 - share) or "full"
        assert TX.auto_decide(k0, rate, w, M, cut, cur, veto, share) \
            == ref, (k0, rate, w, M, cut, cur, veto)


class _TimedCpu(TX._Cpu):
    """The plain version with the card's timings faked: a 50 MB/s link
    and a 1 us kernel, so "auto" runs its loop on the CPU, link-bound."""

    timed = True

    def stage(self, wire, bmask):
        _, ops, bm, staged, _ = super().stage(wire, bmask)
        sent = sum(p.nbytes for p in wire)
        return {"sent": sent}, ops, bm, staged, sent

    def wait(self, slot, outs, metrics):
        return [o.numpy() for o in outs], slot["sent"] / 50e6, 1e-6


def test_auto_loop_cuts_on_a_slow_link_memoizes_and_vetoes(monkeypatch):
    """The auto loop with faked device times: batches 0 and 1 ship full
    (batch 1 is staged before batch 0's times are read), then hi8; the
    rows stay exact through the exact pass, and a second scan of the same
    shape starts on the memoized hi8. On a table where every row matches,
    the density veto sends the scan back to full."""
    table, key, spend, planted, _ = _decoy_table(25, n=128, share=0.03,
                                                 decoy=0.0)
    monkeypatch.setattr(TX, "_Cpu", _TimedCpu)
    monkeypatch.setattr(TX.BatchExecutor, "_auto_memo", TX.OrderedDict())
    memo = TX.BatchExecutor._auto_memo
    modes = []
    real = TK.scan_flags

    def spy(*a, hi_only=None, **kw):
        modes.append(hi_only)
        return real(*a, hi_only=hi_only, **kw)

    monkeypatch.setattr(TK, "scan_flags", spy)
    rows, m = _executor_rows(table, key, spend, "auto")
    np.testing.assert_array_equal(rows, planted)
    assert modes == [None, None, "hi8", "hi8", None]   # + the exact pass
    assert m.upload_mode == "hi8" and m.reverified_rows > 0
    assert m.kernel0_seconds == 1e-6
    assert m.link_bytes_per_second == pytest.approx(50e6)
    assert memo[("fixed", 32, 3)] == (1e-6, "hi8")
    modes.clear()
    rows, _ = _executor_rows(table, key, spend, "auto")
    np.testing.assert_array_equal(rows, planted)
    assert modes[0] == "hi8"
    # every row matches: the first cut batch (2) flags all its rows, and
    # the veto turns the cuts off from the next batch staged (4) on, and
    # for the memo
    memo.clear()
    modes.clear()
    tab, k2, s2, hot, _ = _decoy_table(24, n=160, share=1.0, decoy=0.0)
    rows, m = _executor_rows(tab, k2, s2, "auto")
    np.testing.assert_array_equal(rows, hot)
    # then the exact pass: 64 rows at the scan's 32-row width
    assert modes == [None, None, "hi8", "hi8", None, None, None]
    assert memo[("fixed", 32, 3)][1] == "full"
