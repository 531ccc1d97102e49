"""Host-side (numpy) scalar schedules and the fixed-base comb table:
counterparts of cudasp_tpu/ops/scalar.py:88-295 and :350-383.

  * glv_split / glv_odd_sched: the scan key as two GLV half-scalars, each
    recoded into 32 all-nonzero odd radix-16 digits plus a parity
    correction, so the per-row ladder needs no zero-skip and no infinity
    tracking. The schedule is shared by every row.
  * glv_wnaf_steps / glv_wnaf_static: the two halves as width-5 wNAF,
    merged into one step list over a shared doubling chain (~43 adds
    instead of 64, same 8-entry odd-multiple table): as data for the
    "wnaf" ladder, or trimmed for the per-key "static" build.
  * comb_table_np: t x G for per-row hash scalars t as 32 table reads, one
    per byte of t: entry [i, b] = b * 2^(8*(31-i)) * G (entry 0 = infinity,
    stored as (0, 0)).

And the XLA-graph pipeline's scalar multiplications in plain torch
(counterparts of cudasp_tpu/ops/scalar.py:61-85, :297-354 and :397-426),
on the complete point arithmetic of ops/curve.py: glv_windows (the key's
two 4-bit GLV schedules, zero digits included), ecdh_shared_scalar_glv
(from infinity, over per-row tables [0..15]P) and fixed_base_mul (the
comb table read by a gather, a complete add per byte).
"""

from __future__ import annotations

import numpy as np
import torch

from ..oracle import ec as O
from . import curve as C
from . import field as F

# secp256k1 GLV endomorphism: lambda*(x, y) = (beta*x, y)
GLV_LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
GLV_BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
_G1A = 0x3086D221A7D46BCDE86C90E49284EB15
_G1B = -0xE4437ED6010E88286F547FA90ABFE4C3
_G2A = 0x114CA50F7A8E2F3F657C1108D9D44CFD8
_G2B = _G1A

ODD_WINDOWS = 32          # 128 signed bits / 4 per window
COMB_WINDOWS = 32         # one window per byte of t
GLV_WINDOWS = 32          # 128 bits / 4 per window, the pipeline's ladder


def glv_split(k: int):
    """k (mod n) -> (|k1|, k1 < 0, |k2|, k2 < 0) with k == k1 + k2*lambda
    (mod n) and |k1|, |k2| < 2^128 (round-to-nearest lattice reduction)."""
    n = O.N
    k = k % n

    def rounded_div(a, b):
        return (a + b // 2) // b

    c1 = rounded_div(_G2B * k, n)
    c2 = rounded_div(-_G1B * k, n)
    k2 = -c1 * _G1B - c2 * _G2B
    k1 = (k - k2 * GLV_LAMBDA) % n
    if k1 > n // 2:
        k1 -= n
    if (k1 + k2 * GLV_LAMBDA) % n != k or max(abs(k1), abs(k2)) >= 2**128:
        raise ArithmeticError("GLV split out of range")
    return abs(k1), k1 < 0, abs(k2), k2 < 0


def glv_odd_sched(k: int) -> np.ndarray:
    """(2, 34) int32 odd-digit ladder schedule, one row per GLV half.

    Cols 0..31, most significant first: idx | sign << 3, where the digit is
    sign * (2*idx + 1). Col 32: correction flag e (the half was recoded as
    K + e to make it odd). Col 33: the y plane of the correction add
    (0 = +y, 1 = -y), which subtracts e*P again."""
    a1, n1, a2, n2 = glv_split(k)
    out = np.zeros((2, ODD_WINDOWS + 2), dtype=np.int32)
    for h, (a, neg) in enumerate(((a1, n1), (a2, n2))):
        e = 0 if (a & 1) else 1
        kp = a + e
        half = (kp + (1 << 128) - 1) // 2
        digs = []
        for i in range(ODD_WINDOWS):
            d = 0
            for j in range(4):
                bit = (half >> (4 * i + j)) & 1
                d += (2 * bit - 1) << j
            digs.append(d)
        if sum(dd << (4 * i) for i, dd in enumerate(digs)) != kp:
            raise ArithmeticError("odd-digit recoding failed")
        for i, d in enumerate(digs[::-1]):
            if neg:
                d = -d
            out[h, i] = ((abs(d) - 1) // 2) | ((1 if d < 0 else 0) << 3)
        out[h, ODD_WINDOWS] = e
        out[h, ODD_WINDOWS + 1] = 0 if neg else 1
    return out


WNAF_WIDTH = 5        # odd digits +-{1..15}: the fixed ladder's 8-entry table
WNAF_STEPS = 54       # worst case: 2 halves x ceil(129/5) adds + a trailing
#                       doubling step


def wnaf_digits(v: int, width: int = WNAF_WIDTH):
    """LSB-first wNAF digits of v >= 0: odd values in +-{1..2^(width-1)-1}
    or 0, with >= width-1 zeros after every nonzero digit."""
    digs = []
    while v:
        if v & 1:
            d = v & ((1 << width) - 1)
            if d >= (1 << (width - 1)):
                d -= 1 << width
            v -= d
        else:
            d = 0
        digs.append(d)
        v >>= 1
    return digs


def glv_wnaf_steps(k: int) -> np.ndarray:
    """(2, WNAF_STEPS) int32 schedule of the "wnaf" ladder.

    Both GLV halves are recoded as width-5 wNAF and merged into one step
    list over a shared doubling chain, most significant first. Row 0,
    col i = doublings before step i's add; row 1 = the add's code: bits
    0-2 odd-multiple index (|d|-1)/2, bit 3 negate y, bit 4 GLV half
    (1: lambda*P, whose x is beta*x), bit 5 live (0 = padding or the
    trailing doubling step, no add). Step 0 is a live add with 0
    doublings that initializes the accumulator, so the ladder needs no
    infinity tracking. k == 0 (mod n) encodes as a single +P add: defined
    garbage that cannot match."""
    a1, n1, a2, n2 = glv_split(k)
    events: dict = {}
    for h, (a, neg) in enumerate(((a1, n1), (a2, n2))):
        for pos, d in enumerate(wnaf_digits(a)):
            if d == 0:
                continue
            if neg:
                d = -d
            events.setdefault(pos, []).append(
                (h, (abs(d) - 1) // 2, 1 if d < 0 else 0))
    if not events:
        events[0] = [(0, 0, 0)]
    poss = sorted(events, reverse=True)
    flat = []
    prev = poss[0]
    for pos in poss:
        nd = prev - pos
        for j, ev in enumerate(events[pos]):
            flat.append((nd if j == 0 else 0, ev))
            nd = 0
        prev = pos
    if poss[-1] > 0:                       # doublings down to bit 0
        flat.append((poss[-1], None))
    if len(flat) > WNAF_STEPS:
        raise ArithmeticError("wNAF schedule longer than WNAF_STEPS")
    steps = np.zeros((2, WNAF_STEPS), np.int32)
    for i, (nd, ev) in enumerate(flat):
        steps[0, i] = nd
        if ev is not None:
            h, idx, sgn = ev
            steps[1, i] = idx | (sgn << 3) | (h << 4) | (1 << 5)
    return steps


def glv_wnaf_static(k: int) -> tuple:
    """The "static" ladder's schedule: glv_wnaf_steps with the dead
    padding steps dropped, as a hashable tuple of (n_doublings, add_code)
    int pairs. It is compiled into a per-key kernel, so it re-encodes the
    scan key: treat it, and anything built from it, as secret."""
    steps = glv_wnaf_steps(k)
    out = []
    for i in range(WNAF_STEPS):
        nd, code = int(steps[0, i]), int(steps[1, i])
        if nd or (code >> 5):
            out.append((nd, code))
    return tuple(out)


_comb_cache = []


def comb_table_np() -> np.ndarray:
    """(32, 256, 2, 8) uint32 comb table in kernel words: [i, b, 0] = x and
    [i, b, 1] = y of b * 2^(8*(31-i)) * G; entry b = 0 is (0, 0). Built
    from the oracle on first use (about 0.2 s) and kept in memory."""
    if not _comb_cache:
        out = np.zeros((COMB_WINDOWS, 256, 2, F.NWORDS), np.uint32)
        g = (O.GX, O.GY)
        for i in range(COMB_WINDOWS):
            base = O.ec_mul(g, 1 << (8 * (COMB_WINDOWS - 1 - i)))
            acc = None
            for b in range(1, 256):
                acc = O.ec_add(acc, base)
                out[i, b, 0] = F.int_to_words(acc[0])
                out[i, b, 1] = F.int_to_words(acc[1])
        _comb_cache.append(out)
    return _comb_cache[0]


# ---------------------------------------------------------------------------
# The XLA-graph pipeline's scalar multiplications (plain torch)
# ---------------------------------------------------------------------------


def glv_windows(k: int):
    """The pipeline's GLV schedule of the scan key: (w1, neg1, w2, neg2),
    w1 and w2 (32,) int32 4-bit digits of |k1| and |k2|, most significant
    first, zero digits included; neg1 and neg2 the halves' signs."""
    a1, n1, a2, n2 = glv_split(k)

    def digits(v):
        return np.array([(v >> (4 * (GLV_WINDOWS - 1 - i))) & 0xF
                         for i in range(GLV_WINDOWS)], dtype=np.int32)
    return digits(a1), np.int32(n1), digits(a2), np.int32(n2)


def window_table(base: C.AffinePoint) -> list:
    """Per-row [0..15] x P as 16 JacPoints: entry 0 is infinity, 2P a
    doubling, 3P..15P a chain of incomplete adds (kP + P cannot
    degenerate for 2 <= k <= 14 when P has prime order; an off-curve P
    gives defined values that cannot match)."""
    t1 = C.to_jacobian(base)
    tbl = [C.infinity_like(base.x), t1, C.point_dbl(t1)]
    for _ in range(13):                 # the reference's madd_fast
        prev = tbl[-1]
        x, y, z = C.madd(prev.x, prev.y, prev.z, base.x, base.y)
        tbl.append(C.JacPoint(x, y, z, prev.inf | base.inf))
    return tbl


def ecdh_shared_scalar_glv(w1, neg1, w2, neg2,
                           base: C.AffinePoint) -> C.JacPoint:
    """k x P for a batch of points P sharing one scalar k, given as
    glv_windows(k): 32 steps of 4 doublings and two complete adds of table
    picks (P's table, and lambda P's: (beta x, y)), from infinity."""
    y_neg = F.neg(base.y)
    base1 = C.AffinePoint(base.x, y_neg if int(neg1) else base.y, base.inf)
    base2 = C.AffinePoint(F.mul(F.const(GLV_BETA, base.x), base.x),
                          y_neg if int(neg2) else base.y, base.inf)
    t1 = window_table(base1)
    t2 = window_table(base2)
    acc = C.infinity_like(base.x)
    for d1, d2 in zip(np.asarray(w1), np.asarray(w2)):
        for _ in range(4):
            acc = C.point_dbl(acc)
        acc = C.point_add(acc, t1[int(d1)])
        acc = C.point_add(acc, t2[int(d2)])
    return acc


def comb_limbs(device) -> torch.Tensor:
    """comb_table_np as (32, 256, 2, 16) int64 plain limbs on `device`."""
    return F.words_to_fe(torch.from_numpy(
        comb_table_np().view(np.int32)).to(device))


def fixed_base_mul(scalar_bytes) -> C.JacPoint:
    """scalar_bytes: (..., 32) big-endian bytes of per-row scalars t (no
    mod-n step). t x G as 32 gathers from the comb table, one per byte,
    each followed by a complete mixed add; byte 0 reads infinity."""
    comb = comb_limbs(scalar_bytes.device)
    acc = C.infinity_like(torch.zeros(scalar_bytes.shape[:-1] + (F.NL,),
                                      dtype=torch.int64,
                                      device=scalar_bytes.device))
    for i in range(COMB_WINDOWS):
        b = scalar_bytes[..., i]
        q = comb[i][b]                                  # (..., 2, 16)
        acc = C.point_madd(acc, C.AffinePoint(q[..., 0, :], q[..., 1, :],
                                              b == 0))
    return acc
