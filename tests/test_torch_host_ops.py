"""The port's host-side pieces equal the JAX package's: oracle copies,
scalar schedules, comb table, tag midstate, ingest and query packing, and
the from_jax_limbs state carrier."""

import numpy as np
import pytest

from cudasp_tpu.io import ingest as JI
from cudasp_tpu.ops import scalar as JS
from cudasp_tpu.oracle import ec as JO
from cudasp_tpu.oracle import encoding as JE
from cudasp_tpu.oracle import pipeline as JP
from cudasp_tpu.oracle import sha256 as JH
from cudasp_tpu.oracle import vectors as JV

import cudasp_tpu_torch as ct
from cudasp_tpu_torch.io import ingest as TI
from cudasp_tpu_torch.ops import field as TF
from cudasp_tpu_torch.ops import scalar as TS
from cudasp_tpu_torch.ops import sha256 as TH
from cudasp_tpu_torch.oracle import ec as TO
from cudasp_tpu_torch.oracle import encoding as TE
from cudasp_tpu_torch.oracle import pipeline as TP
from cudasp_tpu_torch.oracle import sha256 as TSH
from cudasp_tpu_torch.oracle import vectors as TV

G = (JO.GX, JO.GY)


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "big") for _ in range(n)]


def test_oracle_curve_constants_and_ops():
    for name in ("P", "N", "GX", "GY", "B_COEFF"):
        assert getattr(TO, name) == getattr(JO, name)
    for k in _keys(1, 6):
        p = JO.ec_mul(G, k % JO.N)
        assert TO.ec_mul(G, k % TO.N) == p
        q = JO.ec_mul(G, (k >> 7) + 3)
        assert TO.ec_add(p, q) == JO.ec_add(p, q)
        assert TO.ec_double(p) == JO.ec_double(p)
        assert TO.ec_neg(p) == JO.ec_neg(p)
        assert TO.is_on_curve(p) and TO.ec_add(p, TO.ec_neg(p)) is None
        sec1 = bytes([2 + (p[1] & 1)]) + p[0].to_bytes(32, "big")
        assert TO.decompress_point(sec1) == JO.decompress_point(sec1) == p


def test_oracle_encoding_sha_pipeline():
    for k in _keys(2, 3):
        p = JO.ec_mul(G, k % JO.N)
        blob = JE.point_to_blob64(p)
        assert TE.point_to_blob64(p) == blob
        assert TE.blob64_to_point(blob) == JE.blob64_to_point(blob) == p
        assert TE.scalar_to_blob32(k) == JE.scalar_to_blob32(k)
        assert TE.blob32_to_scalar(JE.scalar_to_blob32(k)) == k
        spend = JO.ec_mul(G, (k >> 3) % JO.N)
        assert (TP.candidate_values(p, k, spend, [G])
                == JP.candidate_values(p, k, spend, [G]))
        assert TP.serialize_compressed(p) == JP.serialize_compressed(p)
        assert TP.upper64_signed(p[0]) == JP.upper64_signed(p[0])
    assert TSH.K == JH.K and TSH.IV == JH.IV
    assert TSH.tagged_midstate(b"x") == JH.tagged_midstate(b"x")
    assert TH.TAG_MIDSTATE == JH.tagged_midstate(b"BIP0352/SharedSecret")


def test_golden_vectors_are_the_same_facts():
    assert len(TV.CASES) == len(JV.CASES)
    for t, j in zip(TV.CASES, JV.CASES):
        assert (t.name, t.scan_key_blob, t.spend_blob, t.label_blobs,
                t.expected_heights) == (j.name, j.scan_key_blob,
                                        j.spend_blob, j.label_blobs,
                                        j.expected_heights)
        assert [(r.height, r.txid, r.tweak_blob, r.outputs) for r in t.rows] \
            == [(r.height, r.txid, r.tweak_blob, r.outputs) for r in j.rows]


@pytest.mark.parametrize("seed", [3, 4])
def test_glv_split_and_odd_schedule(seed):
    keys = _keys(seed, 8) + [1, 2, JO.N - 1, 2**96 + 7]
    for k in keys:
        assert TS.glv_split(k) == JS.glv_split(k)
        np.testing.assert_array_equal(TS.glv_odd_sched(k),
                                      JS.glv_odd_sched(k))


def test_comb_table_equals_jax_via_from_jax_limbs():
    j = JS.comb_table_np()                     # (32, 40, 256) 13-bit limbs
    jx = ct.from_jax_limbs(j[:, :20], axis=1)   # (32, 8, 256)
    jy = ct.from_jax_limbs(j[:, 20:], axis=1)
    t = TS.comb_table_np()                     # (32, 256, 2, 8)
    np.testing.assert_array_equal(t[:, :, 0], np.moveaxis(jx, 1, 2))
    np.testing.assert_array_equal(t[:, :, 1], np.moveaxis(jy, 1, 2))
    assert TF.words_to_int(t[5, 3, 0]) == JO.ec_mul(G, 3 << (8 * 26))[0]


def test_pack_query_keys_equal():
    for case in JV.CASES:
        jw, sx, sy, lx, ly, jn = JI.pack_query_keys(
            case.scan_key_blob, case.spend_blob, case.label_blobs)
        sched, spend, labels, n = TI.pack_query_keys(
            case.scan_key_blob, case.spend_blob, case.label_blobs)
        assert n == jn
        np.testing.assert_array_equal(sched.odd, jw.odd)
        np.testing.assert_array_equal(sched.wnaf, jw.wnaf)
        assert sched.wnaf_static == jw.wnaf_static
        np.testing.assert_array_equal(spend[0], ct.from_jax_limbs(sx)[:, 0])
        np.testing.assert_array_equal(spend[1], ct.from_jax_limbs(sy)[:, 0])
        for i in range(n):
            np.testing.assert_array_equal(
                labels[i, 0], ct.from_jax_limbs(lx[i])[:, 0])
            np.testing.assert_array_equal(
                labels[i, 1], ct.from_jax_limbs(ly[i])[:, 0])


def test_from_jax_limbs_roundtrip_and_rejects_noncanonical():
    from cudasp_tpu.ops import field as JF

    vals = [0, 1, JO.P - 1, 2**256 - 1] + _keys(5, 4)
    limbs = np.stack([JF.int_to_limbs(v) for v in vals], axis=1)  # (20, n)
    words = ct.from_jax_limbs(limbs)
    assert words.shape == (8, len(vals)) and words.dtype == np.uint32
    assert [TF.words_to_int(words[:, i]) for i in range(len(vals))] == vals
    bad = limbs.copy()
    bad[19, 0] = 1 << 13
    with pytest.raises(ValueError):
        ct.from_jax_limbs(bad)


def test_ingest_helpers_equal():
    rng = np.random.default_rng(6)
    pts = [JO.ec_mul(G, int(k)) for k in rng.integers(1, 2**40, size=5)]
    blobs = np.stack([np.frombuffer(JE.point_to_blob64(p), np.uint8)
                      for p in pts])
    jx, jy = JI.point_blobs_to_limbs(blobs)
    tx, ty = TI.point_blobs_to_limbs(blobs)
    np.testing.assert_array_equal(tx, ct.from_jax_limbs(jx))
    np.testing.assert_array_equal(ty, ct.from_jax_limbs(jy))
    vals = rng.integers(-2**63, 2**63 - 1, size=(4, 3), dtype=np.int64)
    for a, b in zip(TI.split_outputs_i64(vals), JI.split_outputs_i64(vals)):
        np.testing.assert_array_equal(a, b)
    lists = [[1, 2], [], [3], list(range(10))]
    for a, b in zip(TI.outputs_to_csr(lists), JI.outputs_to_csr(lists)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_outputs", [3, 4])
def test_iter_packed_equals_jax_kernel_layout(max_outputs):
    rng = np.random.default_rng(8)
    n = 37
    blobs = rng.integers(0, 256, size=(n, 64), dtype=np.uint8)
    lens = rng.integers(0, 9, size=n)
    lens[:3] = 3
    flat = rng.integers(-2**62, 2**62, size=int(lens.sum()), dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    rows = np.arange(n, dtype=np.int64) * 2
    ours = list(TI.iter_packed(blobs, flat, offs, 16, max_outputs, rows))
    ref = list(JI.iter_packed(blobs, flat, offs, 16, max_outputs, rows,
                              layout="kernel"))
    assert len(ours) == len(ref) > 1
    for a, b in zip(ours, ref):
        for name in ("tweak_blobs", "row_valid", "outputs_hi", "outputs_lo",
                     "outputs_valid", "source_rows"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
