"""The complete arithmetic under the port's XLA-backend pipeline
(cudasp_tpu_torch/ops/field.py, curve.py, scalar.py, sha256.py), each
function against its JAX counterpart on the CPU (eager, a few rows) and
the oracle: the big-endian views and the shared inversion, the complete
point adds in every degenerate case and to_affine, the GLV schedule and
window table, and the SHA-256 of the serialised point. The pipeline's
stages are in tests/test_torch_pipeline.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudasp_tpu.ops import curve as JC
from cudasp_tpu.ops import field as JF
from cudasp_tpu.ops import scalar as JS
from cudasp_tpu.ops import sha256 as JH

from cudasp_tpu_torch.ops import curve as C
from cudasp_tpu_torch.ops import field as F
from cudasp_tpu_torch.ops import scalar as S
from cudasp_tpu_torch.ops import sha256 as H
from cudasp_tpu_torch.oracle import ec as O
from cudasp_tpu_torch.oracle import pipeline as OP

P = F.P_INT
G = (O.GX, O.GY)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker (tests/test_torch_api.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _limbs(vals):
    """Python ints -> (n, 16) plain limbs."""
    return torch.tensor(np.stack([F.int_to_limbs(v % 2**256) for v in vals]))


def _ints(t):
    """(n, 16) plain limbs -> ints mod p."""
    return [F.limbs_to_int(r) % P for r in t.numpy()]


def _jints(limbs):
    """The JAX package's (20, n) limbs -> ints mod p."""
    return [v % P for v in JF.unpack_ints(np.asarray(limbs))]


def _affine(xs, ys, zs, infs):
    """Jacobian ints -> [None (infinity) or (x, y)], a zero z inverting to
    zero as in both packages."""
    out = []
    for x, y, z, inf in zip(xs, ys, zs, np.asarray(infs)):
        zi = pow(z, P - 2, P)
        out.append(None if inf else (x * zi * zi % P, y * zi ** 3 % P))
    return out


def _taffine(p):
    return _affine(_ints(p.x), _ints(p.y), _ints(p.z), p.inf.numpy())


def _jaffine(p):
    return _affine(_jints(p[0]), _jints(p[1]), _jints(p[2]), p[3])


def _jpoint(pts):
    """[None or (x, y)] -> the JAX package's JacPoint (infinity as
    infinity_like's zeros)."""
    z = [0 if p is None else 1 for p in pts]
    pts = [(0, 0) if p is None else p for p in pts]
    return JC.JacPoint(*(jnp.asarray(JF.pack_ints(v)) for v in (
        [p[0] for p in pts], [p[1] for p in pts], z)),
        jnp.asarray([zz == 0 for zz in z]))


def _tpoint(pts):
    z = [0 if p is None else 1 for p in pts]
    pts = [(0, 0) if p is None else p for p in pts]
    return C.JacPoint(_limbs([p[0] for p in pts]), _limbs([p[1] for p in pts]),
                      _limbs(z), torch.tensor([zz == 0 for zz in z]))


# ---------------------------------------------------------------------------
# Field, curve, scalar and hash functions, each against its JAX counterpart
# ---------------------------------------------------------------------------


def test_big_endian_views_and_shared_inversion_against_jax():
    rng = np.random.default_rng(3)
    vals = [0, 1, P - 1, 2**255 + 19] + [
        int.from_bytes(rng.bytes(32), "big") % P for _ in range(4)]
    a = F.canonical(_limbs(vals))
    ja = JF.pack_ints(vals)
    words = F.limbs_to_words_be(a)
    jwords = np.asarray(JF.limbs_to_words_be(JF.canonical(ja)))
    np.testing.assert_array_equal(words.numpy(), jwords.T.astype(np.int64))
    np.testing.assert_array_equal(
        F.words_be_to_bytes(words).numpy(),
        np.asarray(JF.words_be_to_bytes(jwords)).T)
    assert [int.from_bytes(bytes(r.tolist()), "big") for r in
            F.words_be_to_bytes(words).numpy()] == vals
    # inv_many is the port's inv_chain: zeros give zeros
    b = list(reversed(vals))
    ours = F.inv_many([_limbs(vals), _limbs(b)])
    ref = JF.inv_chain([ja, JF.pack_ints(b)])
    for o, r, v in zip(ours, ref, (vals, b)):
        assert _ints(o) == _jints(r) == [pow(x, P - 2, P) for x in v]


def _pairs():
    """(p, q) pairs that hit every branch of the complete adds: generic,
    p or q or both at infinity, p == q, p == -q, an off-curve p."""
    pts = [O.ec_mul(G, k) for k in (5, 7, 11)]
    off = (pts[0][0], (pts[0][1] + 2) % P)
    ps = [pts[0], None, pts[1], None, pts[1], pts[2], off, pts[2]]
    qs = [pts[1], pts[0], None, None, pts[1], O.ec_neg(pts[2]), pts[1],
          pts[2]]
    return ps, qs


def test_complete_adds_against_jax_and_the_oracle():
    """point_madd, point_add and point_dbl with their infinity flags, and
    to_affine, against the JAX package's madd, jadd, dbl and to_affine."""
    ps, qs = _pairs()
    tp, tq, jp, jq = _tpoint(ps), _tpoint(qs), _jpoint(ps), _jpoint(qs)
    taff = C.AffinePoint(tq.x, tq.y, tq.inf)
    jaff = JC.AffinePoint(jq.x, jq.y, jq.inf)
    cases = [(C.point_madd(tp, taff), JC.madd(jp, jaff)),
             (C.point_add(tp, tq), JC.jadd(jp, jq)),
             (C.point_dbl(tp), JC.dbl(jp))]
    for ours, ref in cases:
        assert _taffine(ours) == _jaffine(ref)
    # the oracle's sums (an off-curve p follows the same formulas: skip)
    want = [O.ec_add(p, q) for p, q in zip(ps, qs)]
    for ours, _ in cases[:2]:
        got = _taffine(ours)
        assert [g for i, g in enumerate(got) if i != 6] == \
            [w for i, w in enumerate(want) if i != 6]
    # to_affine: infinity maps to (0, 0); y optional
    s = cases[1][0]
    aff = C.to_affine(s)
    jaff2 = JC.to_affine(cases[1][1])
    assert _ints(F.canonical(aff.x)) == _jints(jaff2.x)
    assert _ints(F.canonical(aff.y)) == _jints(jaff2.y)
    assert aff.inf.tolist() == np.asarray(jaff2.inf).tolist()
    assert _ints(C.to_affine(s, want_y=False).y) == [0] * len(ps)


def test_glv_windows_and_window_table_against_jax():
    rng = np.random.default_rng(5)
    for k in [0, 1, O.N - 1, O.N] + [int.from_bytes(rng.bytes(32), "big")
                                     for _ in range(3)]:
        ours, ref = S.glv_windows(k), JS.glv_windows(k)
        for o, r in zip(ours, ref):
            np.testing.assert_array_equal(o, r)
        w1, n1, w2, n2 = ours
        a1 = sum(int(d) << (4 * (31 - i)) for i, d in enumerate(w1))
        a2 = sum(int(d) << (4 * (31 - i)) for i, d in enumerate(w2))
        assert ((-a1 if n1 else a1) + (-a2 if n2 else a2) * S.GLV_LAMBDA
                - k) % O.N == 0
    base = [O.ec_mul(G, 9), (5, 6)]                 # on and off the curve
    tb = C.affine(_limbs([p[0] for p in base]), _limbs([p[1] for p in base]))
    jb = JC.affine(JF.pack_ints([p[0] for p in base]),
                   JF.pack_ints([p[1] for p in base]))
    ours = S.window_table(tb)
    ref = JS._build_window_table(jb)
    assert len(ours) == 16
    for i, o in enumerate(ours):
        assert _taffine(o) == _jaffine(tuple(r[i] for r in ref))
    assert _taffine(ours[7])[0] == O.ec_mul(base[0], 7)


def test_tagged_hash_is_the_serialized_hash_of_jax():
    rng = np.random.default_rng(7)
    xw = rng.integers(0, 2**32, size=(8, 8), dtype=np.uint32)
    par = (np.arange(8) % 2).astype(np.uint32)
    ref = np.stack([np.asarray(w) for w in
                    JH.tagged_hash_serialized(xw, par)], -1)
    ours = H.tagged_hash(torch.from_numpy(xw.T.astype(np.int64)),
                         torch.from_numpy(par.astype(np.int64)))
    np.testing.assert_array_equal(ours.numpy(), ref.astype(np.int64))
    x = int.from_bytes(xw[:, 0].astype(">u4").tobytes(), "big")
    msg = bytes([2]) + x.to_bytes(32, "big") + bytes(4)
    assert ours[0].numpy().astype(">u4").tobytes() == OP.tagged_hash(
        OP.TAG, msg)
