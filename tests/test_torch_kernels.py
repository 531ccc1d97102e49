"""The port's ops/kernels.py against the JAX package: batch packing is
byte-identical, and the kernel's plain version gives the flags of the JAX
reference pipeline (the ops/pipeline.py stage functions, as the JAX
package's own CPU tests run it) on every golden case, plus the reference
behaviours the kernel must keep."""

import numpy as np
import pytest
import torch

from cudasp_tpu.io import ingest as JI
from cudasp_tpu.ops import kernels as JK
from cudasp_tpu.ops import pipeline as JPL
from cudasp_tpu.oracle import ec as JO
from cudasp_tpu.oracle import vectors as JV
from cudasp_tpu.runtime.executor import _flags_to_bool as jax_flags_to_bool

from cudasp_tpu_torch.io import ingest as TI
from cudasp_tpu_torch.ops import field as TF
from cudasp_tpu_torch.ops import kernels as TK
from cudasp_tpu_torch.ops import scalar as TS
from cudasp_tpu_torch.oracle import encoding as TE
from cudasp_tpu_torch.oracle import pipeline as TP

BR = 32      # block rows: small tiles keep the plain version quick on CPU


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the machine
    (measured: 5x slower for these files), and these tensors are small."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ragged(seed, n=45, max_len=4):
    rng = np.random.default_rng(seed)
    blobs = rng.integers(0, 256, size=(n, 64), dtype=np.uint8)
    lens = rng.integers(1, max_len + 1, size=n)
    flat = rng.integers(-2**63, 2**63 - 1, size=int(lens.sum()),
                        dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return blobs, flat, offs


@pytest.mark.parametrize("wire", ["x", "xy"])
def test_pack_batch_arrays_byte_identical(wire):
    blobs, flat, offs = _ragged(1)
    b = next(TI.iter_packed(blobs, flat, offs, 64, 4))
    ours = TK.pack_batch_arrays(b.tweak_blobs, b.row_valid, b.outputs_hi,
                                b.outputs_lo, b.outputs_valid, block_rows=BR,
                                wire=wire)
    ref = JK.pack_batch_arrays(b.tweak_blobs, b.row_valid, b.outputs_hi,
                               b.outputs_lo, b.outputs_valid, block_rows=BR,
                               wire=wire)
    assert len(ours) == len(ref) == 4
    for a, r in zip(ours, ref):
        assert a.dtype == r.dtype == np.uint32
        assert a.shape == r.shape
        assert a.tobytes() == r.tobytes()
    with pytest.raises(ValueError):
        TK.pack_batch_arrays(b.tweak_blobs, b.row_valid,
                             np.zeros((64, 31), np.int32),
                             np.zeros((64, 31), np.int32),
                             np.ones((64, 31), bool))


@pytest.mark.parametrize("n_live", [0, 1, 31, 32, 33, 95, 96])
def test_live_blockmask_equal(n_live):
    ours = TK.live_blockmask(n_live, 3, 32)
    ref = JK.live_blockmask(n_live, 3, 32)
    if ref is None:
        assert ours is None
    else:
        np.testing.assert_array_equal(ours, ref)


def _case_inputs(case):
    rows = case.rows
    blobs = np.stack([np.frombuffer(r.tweak_blob, np.uint8) for r in rows])
    flat = np.concatenate([np.asarray(r.outputs, np.int64) for r in rows])
    offs = np.cumsum([0] + [len(r.outputs) for r in rows]).astype(np.int64)
    # one outputs width for every case (golden rows have 1 or 2 outputs),
    # so the JAX reference compiles one program per label count
    return blobs, flat, offs, 2


def _plain_flags(blobs, flat, offs, M, key, spend, labels, wire,
                 bmask=None):
    b = next(TI.iter_packed(blobs, flat, offs, len(blobs), M))
    planes = TK.pack_batch_arrays(b.tweak_blobs, b.row_valid, b.outputs_hi,
                                  b.outputs_lo, b.outputs_valid,
                                  block_rows=BR, wire=wire)
    sched, sp, lab, _ = TI.pack_query_keys(key, spend, labels)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))

    flags = TK.scan_flags(*(t(p) for p in planes), sched.odd, t(sp), t(lab),
                          TK.comb_table("cpu"),
                          None if bmask is None else t(bmask),
                          block_rows=BR, wire=wire)
    return flags[0, :len(blobs)].numpy() != 0


def _jax_flags(blobs, flat, offs, M, key, spend, labels):
    """The JAX reference: the staged XLA pipeline over the JAX packing,
    at the 128-row batch shape the JAX package's own golden tests use."""
    (b,) = JI.pack_rows(blobs, flat, offs, 128, M)
    windows, sx, sy, lx, ly, n = JI.pack_query_keys(key, spend, labels)
    # the XLA stages read the first four schedule fields (as the JAX
    # executor passes them); the rest would only retrace per key
    flags = JPL.scan_batch(b.tweak_x, b.tweak_y, b.row_valid, b.outputs_hi,
                           b.outputs_lo, b.outputs_valid, tuple(windows[:4]),
                           sx, sy, lx, ly, nlabels=n)
    return np.asarray(flags)[:len(blobs)]


@pytest.mark.parametrize("case", JV.CASES, ids=[c.name for c in JV.CASES])
def test_plain_flags_equal_jax_reference_on_golden(case):
    expected = np.array([r.height in case.expected_heights
                         for r in case.rows])
    blobs, flat, offs, M = _case_inputs(case)
    args = (case.scan_key_blob, case.spend_blob, case.label_blobs)
    ref = _jax_flags(blobs, flat, offs, M, *args)
    np.testing.assert_array_equal(ref, expected)
    for wire in ("x", "xy"):
        ours = _plain_flags(blobs, flat, offs, M, *args, wire)
        np.testing.assert_array_equal(ours, ref)


def test_x_wire_reads_only_y_parity():
    """An invalid y with the right parity still matches on the x wire (the
    kernel recovers y from x); the xy wire and the JAX XLA reference compute
    on the literal off-curve point and do not match."""
    case = JV.CASES[0]                       # gecc_case0: row 100 matches
    blobs, flat, offs, M = _case_inputs(case)
    blobs = blobs[:1].copy()
    flat, offs = flat[:offs[1]], offs[:2]
    x, y = TE.blob64_to_point(bytes(blobs[0]))
    blobs[0] = np.frombuffer(TE.point_to_blob64((x, (y + 2) % 2**256)),
                             np.uint8)
    args = (case.scan_key_blob, case.spend_blob, ())
    assert _plain_flags(blobs, flat, offs, M, *args, "x").tolist() == [True]
    assert _plain_flags(blobs, flat, offs, M, *args, "xy").tolist() == [False]
    assert _jax_flags(blobs, flat, offs, M, *args).tolist() == [False]


def test_off_curve_spend_key_scans():
    case = next(c for c in JV.CASES if c.name == "wrong_keys_no_match")
    assert not JO.is_on_curve(TE.blob64_to_point(case.spend_blob))
    blobs, flat, offs, M = _case_inputs(case)
    got = _plain_flags(blobs, flat, offs, M, case.scan_key_blob,
                       case.spend_blob, (), "x")
    assert got.tolist() == [False]


def test_dead_candidate_never_matches():
    """spend = -(t G) puts the final point at infinity (z == 0); its affine
    x would read as 0, and an output of 0 must still not match."""
    case = JV.CASES[0]
    row = case.rows[0]
    tweak = TE.blob64_to_point(row.tweak_blob)
    key = TE.blob32_to_scalar(case.scan_key_blob)
    t = int.from_bytes(TP.shared_secret_hash(JO.ec_mul(tweak, key)), "big")
    spend = JO.ec_neg(JO.ec_mul((JO.GX, JO.GY), t % JO.N))
    blobs = np.frombuffer(row.tweak_blob, np.uint8)[None]
    flat, offs = np.array([0, 5], np.int64), np.array([0, 2], np.int64)
    args = (case.scan_key_blob, TE.point_to_blob64(spend), ())
    for wire in ("x", "xy"):
        assert _plain_flags(blobs, flat, offs, 2, *args, wire).tolist() \
            == [False]
    assert _jax_flags(blobs, flat, offs, 2, *args).tolist() == [False]


@pytest.mark.parametrize("t", [0, 5, JO.N + 5, 2**256 - 1])
def test_comb_takes_raw_hash_bytes(t):
    """t x G + spend from the raw 32 bytes, including t >= n (no mod-n
    step) and t = 0 (the comb's sum stays at infinity: final = spend)."""
    g = (JO.GX, JO.GY)
    spend = JO.ec_mul(g, 123456789)
    hw = torch.tensor([[(t >> (32 * (7 - j))) & 0xFFFFFFFF
                        for j in range(8)]], dtype=torch.int64)
    sp = torch.from_numpy(np.stack(
        [TF.int_to_words(c) for c in spend]).view(np.int32))
    x, y, z = TK.stage_output_final(hw, sp, TK.comb_table("cpu"))
    zi = TF.inv(z)
    ax = TF.limbs_to_int(TF.canonical(TF.mul(x, TF.sqr(zi)))[0])
    want = JO.ec_add(JO.ec_mul(g, t % JO.N), spend)
    assert ax == want[0]


def test_packed_flags_match_jax_epilogue_and_decoder():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    f = rng.integers(0, 2, size=(1, 96)).astype(np.int8)
    ours = TK.pack_flag_words(torch.from_numpy(f)).numpy()
    bits = jnp.asarray(f[0]).astype(jnp.uint32).reshape(-1, 32)
    ref = np.asarray(jnp.sum(bits << jnp.arange(32, dtype=jnp.uint32)[None],
                             axis=1, dtype=jnp.uint32)[None])
    np.testing.assert_array_equal(ours.view(np.uint32), ref)
    np.testing.assert_array_equal(TK.flags_to_bool(ours, 90),
                                  jax_flags_to_bool(ref, 90))
    np.testing.assert_array_equal(TK.flags_to_bool(f, 90), f[0, :90] != 0)


def test_blockmask_zeroes_dead_tiles():
    """Rows of a dead tile flag 0 even when they would match."""
    case = JV.CASES[0]
    blobs, flat, offs, M = _case_inputs(case)
    n = 2 * BR
    blobs = np.repeat(blobs[:1], n, axis=0)
    lens = offs[1] - offs[0]
    flat = np.tile(flat[:lens], n)
    offs = np.arange(n + 1, dtype=np.int64) * lens
    args = (case.scan_key_blob, case.spend_blob, ())
    full = _plain_flags(blobs, flat, offs, M, *args, "x")
    assert full.all()
    bmask = np.array([1, 0], np.int32)
    part = _plain_flags(blobs, flat, offs, M, *args, "x", bmask=bmask)
    assert part[:BR].all() and not part[BR:].any()


def test_scan_flags_checks_shapes_and_never_falls_back(monkeypatch):
    z = torch.zeros((8, 2 * BR), dtype=torch.int32)
    o = torch.zeros((3, 2 * BR), dtype=torch.int32)
    m = torch.zeros((1, 2 * BR), dtype=torch.int32)
    key = TS.glv_wnaf_static(12345)
    digits = {"fixed": np.zeros((2, 34), np.int32),
              "wnaf": TS.glv_wnaf_steps(12345), "static": None}
    sp = torch.zeros((2, 8), dtype=torch.int32)
    lab = torch.zeros((0, 2, 8), dtype=torch.int32)
    comb = TK.comb_table("cpu")
    for ladder, sched in digits.items():
        kw = dict(ladder=ladder, static_sched=key)
        with pytest.raises(ValueError):          # wire xy needs 16 rows
            TK.scan_flags(z, o, o, m, sched, sp, lab, comb, block_rows=BR,
                          wire="xy", **kw)
        with pytest.raises(ValueError):          # B not a block_rows multiple
            TK.scan_flags(z, o, o, m, sched, sp, lab, comb, block_rows=48,
                          **kw)
        with pytest.raises(ValueError):          # mask must be (1, B)
            TK.scan_flags(z, o, o, o, sched, sp, lab, comb, block_rows=BR,
                          **kw)
    # each data-driven ladder takes its own schedule's shape only
    for ladder, other in (("fixed", "wnaf"), ("wnaf", "fixed")):
        with pytest.raises(ValueError, match="digits"):
            TK.scan_flags(z, o, o, m, digits[other], sp, lab, comb,
                          block_rows=BR, ladder=ladder)
    with pytest.raises(ValueError, match="static_sched"):
        TK.scan_flags(z, o, o, m, None, sp, lab, comb, block_rows=BR,
                      ladder="static")
    with pytest.raises(ValueError, match="ladder"):
        TK.scan_flags(z, o, o, m, digits["fixed"], sp, lab, comb,
                      block_rows=BR, ladder="comb")
    # every ladder's build raises when nvcc is missing; nothing falls back
    monkeypatch.setattr(TK.shutil, "which", lambda _: None)
    monkeypatch.setattr(TK, "NVCC_DEFAULT", "/nonexistent/nvcc")
    monkeypatch.setattr(TK, "_BUILD_ROOT", "/nonexistent/build")
    for ladder in TK.LADDERS:
        with pytest.raises(RuntimeError, match="nvcc"):
            TK.ScanKernel(ladder).library(key)
