"""secp256k1 arithmetic on Python integers, affine coordinates; the point
at infinity is ``None``."""

from __future__ import annotations

from typing import Optional, Tuple

# Curve: y^2 = x^3 + 7 over F_p.
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
B_COEFF = 7

Point = Optional[Tuple[int, int]]
INFINITY: Point = None


def _inv(v: int) -> int:
    """v^(p-2) mod p (0 for v == 0 mod p), by the extended-Euclid inverse."""
    v %= P
    return pow(v, -1, P) if v else 0


def is_on_curve(pt: Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + B_COEFF)) % P == 0


def ec_neg(pt: Point) -> Point:
    if pt is None:
        return None
    x, y = pt
    return (x, (-y) % P)


def ec_double(pt: Point) -> Point:
    if pt is None:
        return None
    x, y = pt
    if y == 0:
        return None
    lam = (3 * x * x) * _inv(2 * y) % P
    x3 = (lam * lam - 2 * x) % P
    y3 = (lam * (x - x3) - y) % P
    return (x3, y3)


def ec_add(p1: Point, p2: Point) -> Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        return ec_double(p1)
    lam = (y2 - y1) * _inv(x2 - x1) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def ec_mul(pt: Point, k: int) -> Point:
    """Scalar multiplication k*pt (k any non-negative integer)."""
    if k < 0:
        raise ValueError("negative scalar")
    acc: Point = None
    addend = pt
    while k:
        if k & 1:
            acc = ec_add(acc, addend)
        addend = ec_double(addend)
        k >>= 1
    return acc


def decompress_point(compressed: bytes) -> Point:
    """SEC1 compressed (33 bytes, 02/03 prefix) -> affine point
    (p == 3 mod 4, so sqrt(a) = a^((p+1)/4))."""
    if len(compressed) != 33 or compressed[0] not in (2, 3):
        raise ValueError("bad compressed point")
    x = int.from_bytes(compressed[1:], "big")
    rhs = (pow(x, 3, P) + B_COEFF) % P
    y = pow(rhs, (P + 1) // 4, P)
    if (y * y) % P != rhs:
        raise ValueError("not a quadratic residue: invalid x")
    if (y & 1) != (compressed[0] & 1):
        y = P - y
    return (x, y)
