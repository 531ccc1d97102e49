"""Plain-torch BIP-352 tagged hash of 02/03 || x || 0^4 (37 bytes): one
SHA-256 compression per row from the tag midstate (counterpart of
cudasp_tpu/ops/kernels.py:174-201). uint32 arithmetic is emulated in int64
with a mask after every add."""

from __future__ import annotations

import torch

from ..oracle.sha256 import K as _K
from ..oracle.sha256 import tagged_midstate

TAG = b"BIP0352/SharedSecret"
TAG_MIDSTATE = tagged_midstate(TAG)
BITLEN = (64 + 37) * 8            # tag block + 37-byte message
M32 = 0xFFFFFFFF


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def tagged_hash(xw, par):
    """xw: (..., 8) int64 big-endian words of the canonical affine x
    (word 0 = bits 224..255); par: (...) int64 y parity. Returns (..., 8)
    int64 hash words, big-endian."""
    x = [xw[..., i] for i in range(8)]
    zero = torch.zeros_like(par)
    w = [(((0x02 + par) << 24) | (x[0] >> 8)) & M32]
    for i in range(1, 8):
        w.append(((x[i - 1] << 24) | (x[i] >> 8)) & M32)
    w.append((x[7] & 0xFF) << 24)
    w.append(zero + 0x00800000)
    w += [zero] * 5
    w.append(zero + BITLEN)
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = (zero + s for s in TAG_MIDSTATE)
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g & M32)
        t1 = (h + s1 + ch + _K[t] + w[t]) & M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & M32, c, b, a,
                                  (t1 + s0 + maj) & M32)
    return torch.stack([(s + v) & M32 for s, v in zip(
        TAG_MIDSTATE, (a, b, c, d, e, f, g, h))], -1)
