"""The port's plain-torch field, curve and SHA ops equal cudasp_tpu's
ops/field.py, the TPU kernel's point formulas and ops/sha256.py, compared
as canonical integers, exactly, on random and edge values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudasp_tpu.ops import field as JF
from cudasp_tpu.ops import kernels as JK
from cudasp_tpu.ops import sha256 as JH
from cudasp_tpu.oracle import ec as JO

from cudasp_tpu_torch.ops import curve as TC
from cudasp_tpu_torch.ops import field as TF
from cudasp_tpu_torch.ops import sha256 as TH
from cudasp_tpu_torch.oracle import pipeline as TP

P = JF.P_INT


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the machine
    (measured: 5x slower for these files), and these tensors are small."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


EDGES = [0, 1, 2, 7, P - 1, P, P + 1, 2**256 - 1, 2**256, 2**256 + 977,
         2**256 + 2**255]


def _values(seed, n=8):
    rng = np.random.default_rng(seed)
    return EDGES + [int.from_bytes(rng.bytes(32), "big") for _ in range(n)]


def _port(vals):
    """ints (< 2^257) -> (B, 16) lazy limbs: values at or above 2^256 keep
    their excess in the top limb (2^16 <= limb < 2^17)."""
    rows = []
    for v in vals:
        limbs = TF.int_to_limbs(v % 2**256)
        limbs[15] += (v >> 256) << 16
        rows.append(limbs)
    return torch.from_numpy(np.stack(rows))


def _port_ints(a):
    c = TF.canonical(a).numpy()
    return [TF.limbs_to_int(r) for r in c]


def _jax(vals):
    return jnp.asarray(JF.pack_ints(vals))


def _jax_ints(a):
    return JF.unpack_ints(np.asarray(jax.jit(JF.canonical)(a)))


def test_lazy_inputs_cover_the_edges():
    vals = _values(0)
    assert _port_ints(_port(vals)) == [v % P for v in vals]
    assert _jax_ints(_jax(vals)) == [v % P for v in vals]


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_binary_ops(op):
    a = _values(1)
    b = _values(2)[::-1]
    got = _port_ints(getattr(TF, op)(_port(a), _port(b)))
    want = _jax_ints(jax.jit(getattr(JF, op))(_jax(a), _jax(b)))
    assert got == want
    ref = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
           "sub": lambda x, y: x - y}[op]
    assert got == [ref(x, y) % P for x, y in zip(a, b)]


@pytest.mark.parametrize("op", ["sqr", "neg", "inv", "sqrt_candidate"])
def test_unary_ops(op):
    a = _values(3)
    got = _port_ints(getattr(TF, op)(_port(a)))
    assert got == _jax_ints(jax.jit(getattr(JF, op))(_jax(a)))
    ref = {"sqr": lambda x: x * x, "neg": lambda x: -x,
           "inv": lambda x: pow(x, P - 2, P),
           "sqrt_candidate": lambda x: pow(x, (P + 1) // 4, P)}[op]
    assert got == [ref(x) % P for x in a]


def test_canonical_parity_zero_and_inv_many():
    a = _values(4)
    pa = _port(a)
    assert TF.parity(pa).tolist() == [int(x) for x in np.asarray(
        jax.jit(JF.is_odd)(_jax(a)))]
    assert TF.is_zero(pa).tolist() == [bool(x) for x in np.asarray(
        jax.jit(JF.is_zero)(_jax(a)))]
    zs = [pa, TF.mul_small(pa, 3)]
    got = [_port_ints(z) for z in TF.inv_many(zs)]
    want = [_jax_ints(z) for z in jax.jit(JF.inv_chain)([_jax(a), jax.jit(
        lambda x: JF.mul_small(x, 3))(_jax(a))])]
    assert got == want


def test_words_conversions():
    vals = [v % 2**256 for v in _values(5)]
    words = np.stack([TF.int_to_words(v) for v in vals])
    fe = TF.words_to_fe(torch.from_numpy(words.view(np.int32)))
    assert [TF.limbs_to_int(r) for r in fe.numpy()] == vals
    back = TF.fe_to_words(TF.canonical(fe)).numpy()
    assert [TF.words_to_int(r) for r in back] == [v % P for v in vals]


def _points(seed, n=6):
    rng = np.random.default_rng(seed)
    g = (JO.GX, JO.GY)
    return [JO.ec_mul(g, int(k)) for k in rng.integers(1, 2**60, size=n)]


def _jacobian(pts, seed):
    """Affine points -> Jacobian ints at random z."""
    rng = np.random.default_rng(seed)
    zs = [int.from_bytes(rng.bytes(32), "big") % P or 1 for _ in pts]
    return ([x * z * z % P for (x, _), z in zip(pts, zs)],
            [y * z ** 3 % P for (_, y), z in zip(pts, zs)], zs)


def _affine(x, y, z):
    out = []
    for xi, yi, zi in zip(x, y, z):
        if zi % P == 0:
            out.append(None)
            continue
        iz = pow(zi, P - 2, P)
        out.append((xi * iz * iz % P, yi * iz ** 3 % P))
    return out


def test_dbl_madd_zaddu_equal_tpu_kernel_formulas():
    p = _points(6)
    q = _points(7)
    x, y, z = _jacobian(p, 8)
    qx, qy = [a for a, _ in q], [b for _, b in q]
    # doubling
    got = _affine(*(_port_ints(v) for v in TC.dbl(_port(x), _port(y),
                                                  _port(z))))
    want = _affine(*(_jax_ints(v) for v in jax.jit(JK._dbl)(
        _jax(x), _jax(y), _jax(z))))
    assert got == want == [JO.ec_double(a) for a in p]
    # mixed add
    got = _affine(*(_port_ints(v) for v in TC.madd(
        _port(x), _port(y), _port(z), _port(qx), _port(qy))))
    want = _affine(*(_jax_ints(v) for v in jax.jit(JK._madd_core)(
        _jax(x), _jax(y), _jax(z), _jax(qx), _jax(qy))))
    assert got == want == [JO.ec_add(a, b) for a, b in zip(p, q)]
    # Co-Z add-and-update: both points at z
    q2x = [a * zz * zz % P for a, zz in zip(qx, z)]
    q2y = [b * zz ** 3 % P for b, zz in zip(qy, z)]
    ours = [_port_ints(v) for v in TC.zaddu(
        _port(x), _port(y), _port(q2x), _port(q2y), _port(z))]
    ref = [_jax_ints(v) for v in jax.jit(JK._zaddu)(
        _jax(x), _jax(y), _jax(q2x), _jax(q2y), _jax(z))]
    assert ours == ref
    assert _affine(ours[0], ours[1], ours[4]) == [
        JO.ec_add(a, b) for a, b in zip(p, q)]
    assert _affine(ours[2], ours[3], ours[4]) == p
    # the infinity-aware spend add: P = infinity gives Q
    pinf = torch.tensor([True, False] * 3)
    rx, ry, rz = TC.madd_complete_lite(_port(x), _port(y), _port(z), pinf,
                                       _port(qx), _port(qy))
    got = _affine(_port_ints(rx), _port_ints(ry), _port_ints(rz))
    assert got == [b if i % 2 == 0 else JO.ec_add(a, b)
                   for i, (a, b) in enumerate(zip(p, q))]


def test_tagged_hash_equals_jax_and_hashlib():
    pts = _points(9, 5)
    xw = np.stack([[(x >> (32 * (7 - j))) & 0xFFFFFFFF for j in range(8)]
                   for x, _ in pts]).astype(np.uint32)       # BE words
    par = np.array([y & 1 for _, y in pts], np.uint32)
    ours = TH.tagged_hash(torch.from_numpy(xw.astype(np.int64)),
                          torch.from_numpy(par.astype(np.int64))).numpy()
    ref = np.stack([np.asarray(w) for w in jax.jit(
        JH.tagged_hash_serialized)(jnp.asarray(xw.T), jnp.asarray(par))], 1)
    np.testing.assert_array_equal(ours, ref.astype(np.int64))
    for row, p in zip(ours, pts):
        digest = b"".join(int(w).to_bytes(4, "big") for w in row)
        assert digest == TP.shared_secret_hash(p)
