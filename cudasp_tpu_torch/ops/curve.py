"""Plain-torch Jacobian point arithmetic on secp256k1 (a = 0): the formulas
of the fused TPU kernel (cudasp_tpu/ops/kernels.py:232-296), which the CUDA
kernel repeats, on plain limbs (ops/field.py). Incomplete adds: P == +-Q is
not special-cased (for honest inputs it needs a ~2^-124 coincidence); the
callers own infinity handling."""

from __future__ import annotations

from . import field as F


def dbl(px, py, pz):
    """2P, Jacobian (3M+4S)."""
    a = F.sqr(px)
    b = F.sqr(py)
    c = F.sqr(b)
    d = F.mul_small(F.mul(px, b), 4)
    e = F.mul_small(a, 3)
    x3 = F.sub(F.sqr(e), F.mul_small(d, 2))
    y3 = F.sub(F.mul(e, F.sub(d, x3)), F.mul_small(c, 8))
    z3 = F.mul_small(F.mul(py, pz), 2)
    return x3, y3, z3


def madd(px, py, pz, qx, qy):
    """P + Q with Q affine (8M+3S); z3 == 0 when the x's coincide."""
    z1z1 = F.sqr(pz)
    h = F.sub(F.mul(qx, z1z1), px)
    r = F.sub(F.mul(qy, F.mul(pz, z1z1)), py)
    hh = F.sqr(h)
    h3 = F.mul(h, hh)
    v = F.mul(px, hh)
    x3 = F.sub(F.sub(F.sqr(r), h3), F.mul_small(v, 2))
    y3 = F.sub(F.mul(r, F.sub(v, x3)), F.mul(py, h3))
    z3 = F.mul(pz, h)
    return x3, y3, z3


def zaddu(x1, y1, x2, y2, z):
    """Co-Z add-and-update: P1 = (x1, y1), P2 = (x2, y2) share the implicit
    z. Returns (x3, y3, x1', y1', z3) with P1 + P2 = (x3, y3, z3) and
    P1 = (x1', y1', z3)."""
    e = F.sub(x1, x2)
    c = F.sqr(e)
    w1 = F.mul(x1, c)
    w2 = F.mul(x2, c)
    dy = F.sub(y1, y2)
    a1 = F.mul(y1, F.sub(w1, w2))
    x3 = F.sub(F.sub(F.sqr(dy), w1), w2)
    y3 = F.sub(F.mul(dy, F.sub(w1, x3)), a1)
    z3 = F.mul(z, e)
    return x3, y3, w1, a1, z3


def madd_complete_lite(px, py, pz, pinf, qx, qy):
    """P + Q where P may be infinity (pinf, bool (...)) and Q is a finite
    affine point; returns (x, y, z, inf=False)."""
    ax, ay, az = madd(px, py, pz, qx, qy)
    one = F.one_like(px)
    return (F.select(pinf, qx, ax), F.select(pinf, qy, ay),
            F.select(pinf, one, az))
