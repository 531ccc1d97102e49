"""The port's XLA-backend pipeline (cudasp_tpu_torch/ops/pipeline.py)
against the JAX package's backend="xla" on the CPU: each stage as
canonical values (affine x and y, hash words, flags), the comb multiply
on degenerate scalars, and the composed scan_batch / scan_batch_fused, on
a 128-row batch of on-curve, golden and off-curve tweaks, for a key and
for k = 0. The functions under the stages are held one by one in
tests/test_torch_point_ops.py; whole scans in tests/test_torch_xla_scan.py.

JAX's stages run jitted at 128 rows, the width of the golden scans of the
other test files (their compiles are shared through the persistent
cache). JAX's one-program scan_batch_fused is not compiled here (about a
minute of XLA compile on this CPU): its staged twin, which the reference
defines to compute the same flags, is the reference for both of the
port's."""

import numpy as np
import pytest
import torch

from cudasp_tpu.io import ingest as JI
from cudasp_tpu.ops import field as JF
from cudasp_tpu.ops import pipeline as JPL
from cudasp_tpu.oracle import vectors as JV

from cudasp_tpu_torch.io import ingest
from cudasp_tpu_torch.ops import field as F
from cudasp_tpu_torch.ops import kernels as K
from cudasp_tpu_torch.ops import pipeline as PL
from cudasp_tpu_torch.ops import scalar as S
from cudasp_tpu_torch.oracle import ec as O
from cudasp_tpu_torch.oracle import encoding as E
from cudasp_tpu_torch.oracle import pipeline as OP

from tests.test_torch_point_ops import G, P, _jaffine, _taffine

B = 128          # the golden scans' batch width
M = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker (tests/test_torch_api.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The stages and the composed pipeline on a 128-row batch
# ---------------------------------------------------------------------------


def _batch():
    """128 rows: on-curve tweaks (some planted to match the base candidate
    or a label), the golden tweaks, off-curve points (random bytes, y + 2,
    (0, 0), all-ones words >= p, y = 0), a negated point, and padding."""
    rng = np.random.default_rng(11)
    key = int.from_bytes(rng.bytes(32), "big") % O.N
    spend = O.ec_mul(G, int(rng.integers(1, 2**62)))
    labels = [O.ec_mul(G, int(rng.integers(1, 2**62))) for _ in range(2)]
    pts = [O.ec_mul(G, int(k)) for k in rng.integers(1, 2**62, size=24)]
    pts += [E.blob64_to_point(r.tweak_blob) for c in JV.CASES
            for r in c.rows] + [O.ec_neg(pts[0])]
    blobs = [E.point_to_blob64(p) for p in pts]
    outputs = [list(rng.integers(-2**62, 2**62, size=1 + i % 3))
               for i in range(len(pts))]
    for i, p in enumerate(pts):
        if i % 4 != 3:
            vals = OP.candidate_values(p, key, spend, labels)
            outputs[i][-1] = vals[i % 3]
    bad = [rng.bytes(64) for _ in range(6)] + [
        E.point_to_blob64((pts[1][0], (pts[1][1] + 2) % P)),
        bytes(64), b"\xff" * 64, E.point_to_blob64((pts[2][0], 0))]
    blobs += bad
    outputs += [[int(v) for v in rng.integers(-2**62, 2**62, size=3)]
                for _ in bad]
    blobs = np.frombuffer(b"".join(blobs), np.uint8).reshape(-1, 64)
    flat, offs = ingest.outputs_to_csr(outputs)
    expect = np.zeros(B, bool)
    for i, p in enumerate(pts):
        expect[i] = OP.scan_row(p, key, spend, outputs[i], labels)
    return key, spend, labels, blobs, flat, offs, expect


@pytest.fixture(scope="module")
def staged():
    """Both packages' stages over _batch, for the batch's key and for
    k = 0 (every ECDH at infinity)."""
    key, spend, labels, blobs, flat, offs, expect = _batch()
    sblob = E.point_to_blob64(spend)
    lblobs = [E.point_to_blob64(p) for p in labels]
    jb = next(JI.iter_packed(blobs, flat, offs, batch_size=B, max_outputs=M))
    tb = next(ingest.iter_packed(blobs, flat, offs, batch_size=B,
                                 max_outputs=M))
    planes = K.pack_batch_arrays(tb.tweak_blobs, tb.row_valid, tb.outputs_hi,
                                 tb.outputs_lo, tb.outputs_valid,
                                 block_rows=B, wire="xy")
    rows = PL.from_planes(*(torch.from_numpy(p.view(np.int32))
                            for p in planes))
    out = {"expect": expect}
    for k in (key, 0):
        kb = E.scalar_to_blob32(k)
        w, sx, sy, lx, ly, nl = JI.pack_query_keys(kb, sblob, lblobs)
        je = JPL.stage_ecdh(jb.tweak_x, jb.tweak_y, w)
        jh = JPL.stage_serialize_hash(*je)
        jf = JPL.stage_output_final(*jh[:8], sx, sy)
        jm = JPL.stage_match(*jf, jh[8], jb.row_valid, jb.outputs_hi,
                             jb.outputs_lo, jb.outputs_valid, lx, ly,
                             nlabels=nl)
        js = JPL.scan_batch(jb.tweak_x, jb.tweak_y, jb.row_valid,
                            jb.outputs_hi, jb.outputs_lo, jb.outputs_valid,
                            w, sx, sy, lx, ly, nlabels=nl)
        sched, sp, lab, L = ingest.pack_query_keys(kb, sblob, lblobs)
        q = PL.query_limbs(torch.from_numpy(sp.view(np.int32)),
                           torch.from_numpy(lab.view(np.int32)))
        te = PL.stage_ecdh(rows[0], rows[1], sched.glv)
        th, tinf = PL.stage_serialize_hash(te)
        tf = PL.stage_output_final(th, q[0], q[1])
        tm = PL.stage_match(tf, tinf, *rows[2:], q[2], q[3])
        out[k] = dict(je=je, jh=jh, jf=jf, jm=np.asarray(jm),
                      js=np.asarray(js), te=te, th=th, tinf=tinf, tf=tf,
                      tm=tm.numpy(), rows=rows, sched=sched, q=q, L=L)
    out["key"], out["spend"] = key, spend
    return out


@pytest.mark.parametrize("which", ["key", "zero"])
def test_stage_ecdh_same_points_as_jax(staged, which):
    s = staged[staged["key"] if which == "key" else 0]
    ours, ref = _taffine(s["te"]), _jaffine(s["je"])
    assert ours == ref
    if which == "zero":
        assert ours == [None] * B
    else:
        assert sum(p is None for p in ours) == 0


@pytest.mark.parametrize("which", ["key", "zero"])
def test_stage_serialize_hash_same_words_as_jax(staged, which):
    s = staged[staged["key"] if which == "key" else 0]
    ref = np.stack([np.asarray(w) for w in s["jh"][:8]], -1)
    np.testing.assert_array_equal(s["th"].numpy(), ref.astype(np.int64))
    np.testing.assert_array_equal(s["tinf"].numpy(), np.asarray(s["jh"][8]))


@pytest.mark.parametrize("which", ["key", "zero"])
def test_stage_output_final_same_points_as_jax(staged, which):
    s = staged[staged["key"] if which == "key" else 0]
    assert _taffine(s["tf"]) == _jaffine(s["jf"])


@pytest.mark.parametrize("which", ["key", "zero"])
def test_stage_match_and_scan_batch_same_flags_as_jax(staged, which):
    """stage_match, scan_batch and scan_batch_fused against the JAX
    package's stage_match and scan_batch, and the oracle's rows."""
    s = staged[staged["key"] if which == "key" else 0]
    want = staged["expect"] if which == "key" else np.zeros(B, bool)
    np.testing.assert_array_equal(s["tm"], s["jm"])
    np.testing.assert_array_equal(s["js"], s["jm"])
    np.testing.assert_array_equal(s["tm"], want)
    assert want.sum() >= (20 if which == "key" else 0)
    if which == "zero":
        return
    for fn in (PL.scan_batch, PL.scan_batch_fused):
        flags = fn(*s["rows"], s["sched"].glv, *s["q"], nlabels=s["L"])
        np.testing.assert_array_equal(flags.numpy(), s["jm"])


def test_fixed_base_mul_degenerate_scalars_against_jax(staged):
    """t = 0, 1, n (raw bytes, no mod-n step: n x G is infinity), bytes
    with zeros, and t = n - 1 against the oracle; then through
    stage_output_final against the JAX package's on the same words."""
    rng = np.random.default_rng(13)
    ts = [0, 1, O.N, O.N - 1, 0x0100FF00 << 100, 2**256 - 1] + [
        int.from_bytes(rng.bytes(32), "big") for _ in range(B - 6)]
    hw = torch.tensor([[(t >> (32 * (7 - i))) & 0xFFFFFFFF for i in range(8)]
                       for t in ts], dtype=torch.int64)
    got = _taffine(S.fixed_base_mul(F.words_be_to_bytes(hw)))
    assert got[:6] == [O.ec_mul(G, t % O.N) if t % O.N else None
                       for t in ts[:6]]
    s = staged[staged["key"]]
    sp = staged["spend"]
    jw = [hw[:, i].numpy().astype(np.uint32) for i in range(8)]
    jf = JPL.stage_output_final(*jw, JF.pack_ints([sp[0]]),
                                JF.pack_ints([sp[1]]))
    tf = PL.stage_output_final(hw, s["q"][0], s["q"][1])
    assert _taffine(tf) == _jaffine(jf)
    assert _taffine(tf)[2] == sp          # n x G + spend
