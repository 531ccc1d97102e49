"""Plain-torch Jacobian point arithmetic on secp256k1 (a = 0) on plain
limbs (ops/field.py), in two sets:

  * The fused TPU kernel's formulas (cudasp_tpu/ops/kernels.py:232-296),
    which the CUDA kernel repeats: dbl, madd, zaddu on bare coordinates.
    Incomplete adds: P == +-Q is not special-cased (for honest inputs it
    needs a ~2^-124 coincidence); the callers own infinity handling.
  * The XLA-graph pipeline's complete arithmetic (counterpart of
    cudasp_tpu/ops/curve.py): points carry an infinity flag
    (AffinePoint, JacPoint), and point_madd / point_add handle p or q at
    infinity, p == q (doubling) and p == -q (infinity). ops/pipeline.py
    uses these.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
    return _madd(px, py, pz, qx, qy)[:3]


def _madd(px, py, pz, qx, qy):
    """madd's (x3, y3, z3), and its h and r: h is 0 where P and Q share x,
    r where they also share y."""
    z1z1 = F.sqr(pz)
    h = F.sub(F.mul(qx, z1z1), px)
    r = F.sub(F.mul(qy, F.mul(pz, z1z1)), py)
    hh = F.sqr(h)
    h3 = F.mul(h, hh)
    v = F.mul(px, hh)
    x3 = F.sub(F.sub(F.sqr(r), h3), F.mul_small(v, 2))
    y3 = F.sub(F.mul(r, F.sub(v, x3)), F.mul(py, h3))
    z3 = F.mul(pz, h)
    return x3, y3, z3, h, r


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


# ---------------------------------------------------------------------------
# Complete arithmetic with infinity flags (cudasp_tpu/ops/curve.py:23-179)
# ---------------------------------------------------------------------------


class AffinePoint(NamedTuple):
    x: torch.Tensor             # (..., 16)
    y: torch.Tensor
    inf: torch.Tensor           # (...) bool


class JacPoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    inf: torch.Tensor


def affine(x, y, inf=None) -> AffinePoint:
    if inf is None:
        inf = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    return AffinePoint(x, y, inf)


def to_jacobian(p: AffinePoint) -> JacPoint:
    return JacPoint(p.x, p.y, F.one_like(p.x), p.inf)


def infinity_like(x) -> JacPoint:
    z = torch.zeros_like(x)
    return JacPoint(z, z, z, torch.ones(x.shape[:-1], dtype=torch.bool,
                                        device=x.device))


def select_point(mask, p: JacPoint, q: JacPoint) -> JacPoint:
    """Per row: mask ? p : q."""
    return JacPoint(F.select(mask, p.x, q.x), F.select(mask, p.y, q.y),
                    F.select(mask, p.z, q.z), torch.where(mask, p.inf, q.inf))


def point_dbl(p: JacPoint) -> JacPoint:
    """2P; infinity stays infinity."""
    return JacPoint(*dbl(p.x, p.y, p.z), p.inf)


def _apply_degenerate(p, q_promoted, q_inf, h, r, added):
    """The completeness epilogue of point_madd and point_add, from the
    add's h and r: where h == 0, p == q doubles (r == 0) and p == -q
    cancels; an operand at infinity gives the other. r's zero test and
    the doubling run only when some row needs them (host checks, as the
    reference's batch-level cond)."""
    out = added
    h_zero = F.is_zero(h)
    if bool(h_zero.any()):
        r_zero = F.is_zero(r)
        same = h_zero & r_zero
        if bool(same.any()):
            out = select_point(same, point_dbl(p), out)
        out = select_point(h_zero & ~r_zero, infinity_like(p.x), out)
    out = select_point(q_inf, p, out)
    return select_point(p.inf & ~q_inf, q_promoted, out)


def point_madd(p: JacPoint, q: AffinePoint) -> JacPoint:
    """Complete mixed add p (Jacobian) + q (affine): 8M + 3S plus the
    epilogue."""
    x3, y3, z3, h, r = _madd(p.x, p.y, p.z, q.x, q.y)
    added = JacPoint(x3, y3, z3, torch.zeros_like(p.inf))
    return _apply_degenerate(p, to_jacobian(q), q.inf, h, r, added)


def point_add(p: JacPoint, q: JacPoint) -> JacPoint:
    """Complete Jacobian + Jacobian add (add-2007-bl shape): 12M + 4S plus
    the epilogue."""
    z1z1 = F.sqr(p.z)
    z2z2 = F.sqr(q.z)
    u1 = F.mul(p.x, z2z2)
    s1 = F.mul(p.y, F.mul(q.z, z2z2))
    h = F.sub(F.mul(q.x, z1z1), u1)
    r = F.sub(F.mul(q.y, F.mul(p.z, z1z1)), s1)
    hh = F.sqr(h)
    h3 = F.mul(h, hh)
    v = F.mul(u1, hh)
    x3 = F.sub(F.sub(F.sqr(r), h3), F.mul_small(v, 2))
    y3 = F.sub(F.mul(r, F.sub(v, x3)), F.mul(s1, h3))
    z3 = F.mul(F.mul(p.z, q.z), h)
    added = JacPoint(x3, y3, z3, torch.zeros_like(p.inf))
    return _apply_degenerate(p, q, q.inf, h, r, added)


def to_affine(p: JacPoint, zinv=None, want_y: bool = True) -> AffinePoint:
    """x = X/Z^2, y = Y/Z^3, by one inversion unless zinv (a shared
    inversion's) is given. Infinity maps to (0, 0); want_y=False leaves y
    0."""
    if zinv is None:
        zinv = F.inv(F.select(p.inf, F.one_like(p.z), p.z))
    zero = torch.zeros_like(p.x)
    zi2 = F.sqr(zinv)
    ax = F.select(p.inf, zero, F.mul(p.x, zi2))
    if not want_y:
        return AffinePoint(ax, zero, p.inf)
    ay = F.select(p.inf, zero, F.mul(p.y, F.mul(zinv, zi2)))
    return AffinePoint(ax, ay, p.inf)
