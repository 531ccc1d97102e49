"""secp256k1 prime field: the port's limb formats and the plain-torch ops.

Two formats, one value:

  * **Kernel words** (the wire and the CUDA kernel): a field element is 8
    little-endian uint32 words, held in int32 tensors (same bits). The
    kernel multiplies 32x32 -> 64 bit and folds with
    2^256 == 2^32 + 977 (mod p); p is pseudo-Mersenne, so there is no
    Montgomery form. Counterpart of the 20x13-bit int32 limbs of
    cudasp_tpu/ops/field.py, which exist only for the TPU's int32 vector
    unit.
  * **Plain limbs** (this module's torch ops, the plain version of the
    kernel): 16 limbs of 16 bits in int64, batch first, shape (..., 16).
    Torch has no unsigned 64-bit multiply-high, so 16-bit limbs keep every
    partial product (< 2^34) and every 16-term column (< 2^38) exact in
    int64. Reduction is lazy: after every op each limb is < 2^17 ("lazy
    form", any value mod p); only `canonical` produces the unique
    representative < p with exact 16-bit limbs.

Bounds, audited per op (lazy inputs, limbs < 2^17):
  mul:  columns < 2^38; fold of 2^256 -> limbs < 2^48; three carry passes
        -> < 2^48 -> < 2^42 (limb 0) -> < 2^27.1 -> < 2^16 + 2^12.
  add/sub/neg/mul_small: limbs < 2^21 before one carry pass whose top
        carry c15 <= 31, so limb 0 <= 2^16 + 977*31 + 31 < 2^17.
"""

from __future__ import annotations

import numpy as np
import torch

P_INT = 2**256 - 2**32 - 977
NL = 16                       # plain limbs
LB = 16                       # bits per plain limb
M16 = (1 << LB) - 1
NWORDS = 8                    # kernel words

# products performed by mul, and squares by sqr, since the last reset (one
# per element of the batch shape); read by chip_smoke.py to count the field
# products and squares a row needs for the kernel's bound (the card squares
# with 36 partial products where a product takes 64)
PRODUCTS = [0]
SQUARES = [0]


# ---------------------------------------------------------------------------
# Host conversions
# ---------------------------------------------------------------------------


def int_to_words(v: int) -> np.ndarray:
    """Integer < 2^256 -> (8,) uint32 little-endian words."""
    if not 0 <= v < 2**256:
        raise ValueError("value does not fit in 256 bits")
    return np.array([(v >> (32 * i)) & 0xFFFFFFFF for i in range(NWORDS)],
                    dtype=np.uint32)


def words_to_int(words) -> int:
    w = np.asarray(words, dtype=np.uint64).reshape(-1)
    return sum(int(x) << (32 * i) for i, x in enumerate(w))


def int_to_limbs(v: int) -> np.ndarray:
    """Integer < 2^256 -> (16,) int64 plain limbs."""
    if not 0 <= v < 2**256:
        raise ValueError("value does not fit in 256 bits")
    return np.array([(v >> (LB * i)) & M16 for i in range(NL)], np.int64)


def limbs_to_int(limbs) -> int:
    a = np.asarray(limbs, dtype=np.int64).reshape(-1)
    return sum(int(x) << (LB * i) for i, x in enumerate(a))


def limbs13_to_words(limbs: np.ndarray, axis: int = 0) -> np.ndarray:
    """20x13-bit limb arrays (the JAX package's format, limb axis `axis`)
    of values < 2^256 -> uint32 words with 8 words on that axis. Raises on
    limbs that are not exact 13-bit limbs of such a value."""
    a = np.moveaxis(np.asarray(limbs, dtype=np.int64), axis, 0)
    if a.shape[0] != 20:
        raise ValueError(f"expected 20 limbs on axis {axis}, got {a.shape}")
    if (a < 0).any() or (a >> 13).any() or (a[19] >> (256 - 13 * 19)).any():
        raise ValueError("not 13-bit limbs of a value below 2^256")
    flat = a.reshape(20, -1).astype(np.uint64)
    out = np.zeros((NWORDS, flat.shape[1]), np.uint64)
    for i in range(20):
        k, s = divmod(13 * i, 32)
        out[k] |= (flat[i] << np.uint64(s)) & np.uint64(0xFFFFFFFF)
        if s + 13 > 32 and k + 1 < NWORDS:     # limb 19's spill is 0
            out[k + 1] |= flat[i] >> np.uint64(32 - s)
    out = out.astype(np.uint32).reshape((NWORDS,) + a.shape[1:])
    return np.moveaxis(out, 0, axis)


# ---------------------------------------------------------------------------
# Torch conversions between the two formats
# ---------------------------------------------------------------------------


def words_to_fe(words: torch.Tensor) -> torch.Tensor:
    """(..., 8) kernel words (int32 or int64 bits) -> (..., 16) int64."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & M16, w >> LB], dim=-1).reshape(
        w.shape[:-1] + (NL,))


def fe_to_words(a: torch.Tensor) -> torch.Tensor:
    """Canonical (..., 16) -> (..., 8) int64 words (values < 2^32)."""
    return a[..., 0::2] | (a[..., 1::2] << LB)


def const(v: int, like: torch.Tensor) -> torch.Tensor:
    """A field constant as (16,) int64 on `like`'s device (broadcasts)."""
    return _dev(int_to_limbs(v % P_INT), like)


# ---------------------------------------------------------------------------
# Lazy reduction
# ---------------------------------------------------------------------------

_FOLD = np.zeros(NL, np.int64)
_FOLD[0], _FOLD[2] = 977, 1                        # 2^256 == 2^32 + 977
_FOLD1 = np.roll(_FOLD, 1)                         # 2^272 == 2^48 + 977*2^16


def _subtrahend(mult: int, slack: int) -> np.ndarray:
    """Limbs of mult*p with every limb >= slack * 2^16 (so D - b >= 0
    limbwise for any lazy b)."""
    v = mult * P_INT
    out = []
    for _ in range(NL - 1):
        out.append((v & M16) + (slack << LB))
        v = (v >> LB) - slack
    if v < (slack << LB):
        raise ValueError("top limb below slack")
    out.append(v)
    d = np.array(out, np.int64)
    assert limbs_to_int(d) == mult * P_INT
    return d


_D = _subtrahend(8, 2)                             # limbs in [2^17, 2^20)
_P = int_to_limbs(P_INT)


# constants already on a card, by (bytes, device): a host-to-device copy
# from pageable memory would wait for the card's queue at every op
_ON_DEVICE: dict = {}


def _dev(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.device.type == "cpu":
        return torch.from_numpy(arr)
    key = (arr.tobytes(), like.device)
    t = _ON_DEVICE.get(key)
    if t is None:
        t = _ON_DEVICE[key] = torch.as_tensor(arr, device=like.device)
    return t


def _carry(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry pass; the carry out of limb 15 folds back."""
    c = x >> LB
    top = c[..., NL - 1:]
    shifted = torch.nn.functional.pad(c[..., :NL - 1], (1, 0))
    return (x & M16) + shifted + top * _dev(_FOLD, x)


def add(a, b):
    return _carry(a + b)


def sub(a, b):
    return _carry(a + (_dev(_D, b) - b))


def neg(b):
    return _carry(_dev(_D, b) - b)


def mul_small(a, k: int):
    if not 0 < k <= 15:
        raise ValueError("mul_small takes 1 <= k <= 15")
    return _carry(a * k)


def mul(a, b):
    """a * b (mod p), lazy in and out."""
    a, b = torch.broadcast_tensors(a, b)
    PRODUCTS[0] += a[..., 0].numel()
    return _mul(a, b)


def _mul(a, b):
    prod = a.unsqueeze(-1) * b.unsqueeze(-2)              # (..., 16, 16)
    lead = prod.shape[:-2]
    # skew rows: row i shifted right by i -> columns i + j
    sk = torch.nn.functional.pad(prod, (0, 2 * NL + 1 - NL))  # (..,16,33)
    sk = sk.reshape(lead + (NL * (2 * NL + 1),))[..., :NL * 2 * NL]
    cols = sk.reshape(lead + (NL, 2 * NL)).sum(-2)        # (..., 32)
    lo, hi = cols[..., :NL], cols[..., NL:]
    # hi_k * 2^(256+16k) == hi_k * 2^16k * (2^32 + 977); k = 14 lands at
    # 2^256 again (k = 15 is always zero: columns stop at 30)
    r = (lo + 977 * hi
         + torch.nn.functional.pad(hi[..., :NL - 2], (2, 0))
         + hi[..., NL - 2:NL - 1] * _dev(_FOLD, a)
         + hi[..., NL - 1:] * _dev(_FOLD1, a))
    return _carry(_carry(_carry(r)))


def sqr(a):
    SQUARES[0] += a[..., 0].numel()
    return _mul(a, a)


def sqr_n(a, n: int):
    for _ in range(n):
        a = sqr(a)
    return a


# ---------------------------------------------------------------------------
# Canonical form
# ---------------------------------------------------------------------------


def _ripple(x: torch.Tensor):
    """Exact sequential carry: (..., 16) non-negative -> (exact 16-bit
    limbs, carry out of the top as (..., 1))."""
    cols = list(x.unbind(-1))
    c = torch.zeros_like(cols[0])
    for i in range(NL):
        v = cols[i] + c
        cols[i] = v & M16
        c = v >> LB
    return torch.stack(cols, -1), c.unsqueeze(-1)


def canonical(a):
    """Unique representative < p, exact 16-bit limbs."""
    x, t = _ripple(a)
    x, t = _ripple(x + t * _dev(_FOLD, x))
    x, t = _ripple(x + t * _dev(_FOLD, x))      # t == 0 from here: < 2^256
    # subtract p once when x >= p (x < 2^256 < 2p)
    d = x - _dev(_P, x)
    cols = list(d.unbind(-1))
    borrow = torch.zeros_like(cols[0])
    for i in range(NL):
        v = cols[i] - borrow
        borrow = (v < 0).to(v.dtype)
        cols[i] = v + (borrow << LB)
    ge = (borrow == 0).unsqueeze(-1)
    return torch.where(ge, torch.stack(cols, -1), x)


def is_zero(a):
    """a == 0 (mod p) -> bool (...)."""
    return (canonical(a) == 0).all(-1)


def parity(a):
    """Low bit of the canonical value -> int64 (...)."""
    return canonical(a)[..., 0] & 1


def select(mask, a, b):
    """mask (...) bool -> a where mask else b, per element."""
    return torch.where(mask.unsqueeze(-1), a, b)


def one_like(a):
    return torch.zeros_like(a) + const(1, a)


# ---------------------------------------------------------------------------
# Exponentiation chains (libsecp256k1's), 255 squarings + 15 products
# ---------------------------------------------------------------------------


def _x223(a):
    x2 = mul(sqr(a), a)
    x3 = mul(sqr(x2), a)
    x6 = mul(sqr_n(x3, 3), x3)
    x9 = mul(sqr_n(x6, 3), x3)
    x11 = mul(sqr_n(x9, 2), x2)
    x22 = mul(sqr_n(x11, 11), x11)
    x44 = mul(sqr_n(x22, 22), x22)
    x88 = mul(sqr_n(x44, 44), x44)
    x176 = mul(sqr_n(x88, 88), x88)
    x220 = mul(sqr_n(x176, 44), x44)
    x223 = mul(sqr_n(x220, 3), x3)
    return x2, x22, x223


def inv(a):
    """a^(p-2); inv(0) == 0."""
    x2, x22, x223 = _x223(a)
    t = mul(sqr_n(x223, 23), x22)
    t = mul(sqr_n(t, 5), a)
    t = mul(sqr_n(t, 3), x2)
    return mul(sqr_n(t, 2), a)


def sqrt_candidate(a):
    """a^((p+1)/4): the square root when a is a quadratic residue."""
    x2, x22, x223 = _x223(a)
    t = mul(sqr_n(x223, 23), x22)
    t = mul(sqr_n(t, 6), x2)
    return sqr_n(t, 2)


def inv_many(zs):
    """Montgomery-trick inversion of a list of same-shape elements: one
    exponentiation in all; zero inputs give zero inverses."""
    nz = [is_zero(z) for z in zs]
    one = one_like(zs[0])
    safe = [select(m, one, z) for m, z in zip(nz, zs)]
    prefix = [safe[0]]
    for z in safe[1:]:
        prefix.append(mul(prefix[-1], z))
    run = inv(prefix[-1])
    out = [None] * len(zs)
    for i in range(len(zs) - 1, 0, -1):
        out[i] = mul(run, prefix[i - 1])
        run = mul(run, safe[i])
    out[0] = run
    return [select(m, torch.zeros_like(o), o) for m, o in zip(nz, out)]


# ---------------------------------------------------------------------------
# Big-endian views (counterparts of limbs_to_words_be / words_be_to_bytes,
# cudasp_tpu/ops/field.py:569-595). inv_many is the counterpart of
# inv_chain (:545): one exponentiation, zero inputs give zero inverses.
# ---------------------------------------------------------------------------


def limbs_to_words_be(a):
    """Canonical (..., 16) -> (..., 8) int64 big-endian words (word 0 =
    bits 224..255). The input must be canonical."""
    return fe_to_words(a).flip(-1)


def words_be_to_bytes(words):
    """(..., 8) big-endian words -> (..., 32) int64 bytes, most
    significant first."""
    shifts = torch.tensor([24, 16, 8, 0], device=words.device)
    return ((words.unsqueeze(-1) >> shifts) & 0xFF).reshape(
        words.shape[:-1] + (32,))
