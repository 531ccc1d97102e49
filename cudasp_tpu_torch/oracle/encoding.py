"""Blob encodings of the scan API: a 64-byte point blob is 32-byte x
(little-endian) || 32-byte y (little-endian); a 32-byte scalar blob is
little-endian."""

from __future__ import annotations

from .ec import Point


def point_to_blob64(pt: Point) -> bytes:
    if pt is None:
        raise ValueError("cannot encode the point at infinity")
    x, y = pt
    return x.to_bytes(32, "little") + y.to_bytes(32, "little")


def blob64_to_point(blob: bytes) -> Point:
    if len(blob) != 64:
        raise ValueError(f"point blob must be 64 bytes, got {len(blob)}")
    return (int.from_bytes(blob[:32], "little"),
            int.from_bytes(blob[32:], "little"))


def scalar_to_blob32(k: int) -> bytes:
    return k.to_bytes(32, "little")


def blob32_to_scalar(blob: bytes) -> int:
    if len(blob) != 32:
        raise ValueError(f"scalar blob must be 32 bytes, got {len(blob)}")
    return int.from_bytes(blob, "little")
