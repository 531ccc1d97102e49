"""CPU reference of the whole BIP-352 scan of one row:

  * serialize: 0x02|parity prefix + 32-byte big-endian x + 4 zero bytes
  * tagged hash: SHA256(SHA256(tag)||SHA256(tag)||msg), tag
    "BIP0352/SharedSecret"
  * upper64: int64 of bits 192..255 of the affine x coordinate
  * labels add to final_point = output_point + spend (not output_point)
"""
from __future__ import annotations

import hashlib
from typing import Iterable, List, Sequence

from .ec import GX, GY, N, Point, ec_add, ec_mul

TAG = b"BIP0352/SharedSecret"
_G: Point = (GX, GY)


def tagged_hash(tag: bytes, msg: bytes) -> bytes:
    tag_hash = hashlib.sha256(tag).digest()
    return hashlib.sha256(tag_hash + tag_hash + msg).digest()


def serialize_compressed(pt: Point) -> bytes:
    """Compressed SEC1 (33 bytes) + 4 zero bytes (BIP-352 output index k=0)."""
    if pt is None:
        raise ValueError("cannot serialize the point at infinity")
    x, y = pt
    prefix = bytes([0x02 + (y & 1)])
    return prefix + x.to_bytes(32, "big") + b"\x00\x00\x00\x00"


def shared_secret_hash(ecdh_point: Point) -> bytes:
    return tagged_hash(TAG, serialize_compressed(ecdh_point))


def upper64_signed(x: int) -> int:
    """Bits 192..255 of x as a signed int64."""
    v = (x >> 192) & 0xFFFFFFFFFFFFFFFF
    return v - (1 << 64) if v >= (1 << 63) else v


def candidate_values(
    tweak_point: Point,
    scan_key: int,
    spend_point: Point,
    label_points: Sequence[Point] = (),
) -> List[int]:
    """All candidate upper-64 values of a row: [base, label_0, ...]."""
    ecdh = ec_mul(tweak_point, scan_key)
    t = int.from_bytes(shared_secret_hash(ecdh), "big")
    output_point = ec_mul(_G, t % N)
    final_point = ec_add(output_point, spend_point)
    if final_point is None:
        raise ValueError("final point at infinity")
    values = [upper64_signed(final_point[0])]
    for lp in label_points:
        labeled = ec_add(final_point, lp)
        if labeled is None:
            raise ValueError("labeled point at infinity")
        values.append(upper64_signed(labeled[0]))
    return values


def scan_row(
    tweak_point: Point,
    scan_key: int,
    spend_point: Point,
    outputs: Iterable[int],
    label_points: Sequence[Point] = (),
) -> bool:
    """True if the row matches (base case first, then each label in order)."""
    outs = set(outputs)
    for v in candidate_values(tweak_point, scan_key, spend_point,
                              label_points):
        if v in outs:
            return True
    return False
