"""The XLA-graph backend's scan pipeline as plain torch tensor ops
(counterpart of cudasp_tpu/ops/pipeline.py, the JAX package's
backend="xla"):

    ecdh  = scan_key x tweak          (GLV windows over per-row tables)
    ser   = 02/03 || x || 0^4         (canonical big-endian words)
    t     = tagged_sha256(ser)        (one compression from the midstate)
    out   = t x G                     (comb gathers, complete adds)
    final = out + spend
    cand_j = final + label_j
    match = some candidate's upper 64 x bits among the row's outputs

It reads the literal tweak point (x, y), not a decompressed one, and every
add is complete: a point at infinity never matches, and a row whose ECDH
is infinity never matches. So it differs from the scan kernel on purpose
where the kernel reads only y's parity (an off-curve row can match there).

No hand-written kernel: the reference's backend is a jnp graph outside any
Pallas kernel, and this is its counterpart on the plain limbs of
ops/field.py (rows first, (B, 16) int64). Each op is one torch call, on
the card or the CPU as its tensors lie.

scan_batch runs the three stages in turn (their intermediates stay on the
device). The reference's scan_batch_fused is one XLA program where
scan_batch is three; eager torch compiles nothing, so the port's
scan_batch_fused runs the same ops, and ScanConfig(fused=) is accepted
with the same flags either way.
"""

from __future__ import annotations

import torch

from . import curve as C
from . import field as F
from . import scalar as S
from . import sha256 as H

M32 = 0xFFFFFFFF


def from_planes(tweak_words, outputs_hi, outputs_lo, outputs_mask):
    """The kernel's planes on the "xy" wire (ops.kernels.pack_batch_arrays,
    the 64-byte point: (16, B) x then y words) -> scan_batch's row
    operands: tweak_x, tweak_y (B, 16) plain limbs, row_valid (B,) bool,
    outputs_hi, outputs_lo (B, M) int64 words, outputs_valid (B, M) bool."""
    if tweak_words.shape[0] != 16:
        raise ValueError("the pipeline reads the literal (x, y): tweak "
                         "words must be the (16, B) planes of wire 'xy'")
    m = outputs_mask[0].to(torch.int64) & M32
    M = outputs_hi.shape[0]
    ov = ((m[:, None] >> torch.arange(M, device=m.device)) & 1) != 0
    return (F.words_to_fe(tweak_words[:8].T),
            F.words_to_fe(tweak_words[8:].T), ((m >> 31) & 1) != 0,
            outputs_hi.T.to(torch.int64) & M32,
            outputs_lo.T.to(torch.int64) & M32, ov)


def query_limbs(spend, labels):
    """spend (2, 8) and labels (L, 2, 8) kernel words (tensors) ->
    (spend_x, spend_y (16,), label_x, label_y (L, 16)) plain limbs."""
    sp = F.words_to_fe(spend)
    lab = F.words_to_fe(labels)
    return sp[0], sp[1], lab[:, 0], lab[:, 1]


def _upper64_words(x_canonical):
    """Bits 224..255 and 192..223 of a canonical element, as int64 words
    (the reference's ExtractUpper64 as two 32-bit halves)."""
    words = F.limbs_to_words_be(x_canonical)
    return words[..., 0], words[..., 1]


def _candidate_match(point, zinv, outputs_hi, outputs_lo, outputs_valid):
    """Match flags of one candidate, given its shared-inverted Z."""
    aff = C.to_affine(point, zinv=zinv, want_y=False)
    hi, lo = _upper64_words(F.canonical(aff.x))
    eq = (hi[:, None] == outputs_hi) & (lo[:, None] == outputs_lo)
    return (eq & outputs_valid).any(-1) & ~point.inf


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


def stage_ecdh(tweak_x, tweak_y, scan_windows) -> C.JacPoint:
    """Rows -> ecdh point. scan_windows: scalar.glv_windows of the scan key
    (w1, neg1, w2, neg2; host arrays)."""
    w1, n1, w2, n2 = scan_windows[:4]
    return S.ecdh_shared_scalar_glv(w1, n1, w2, n2,
                                    C.affine(tweak_x, tweak_y))


def stage_serialize_hash(ecdh: C.JacPoint):
    """ecdh point -> ((B, 8) int64 big-endian hash words, ecdh at
    infinity (B,) bool). Infinity hashes as x = 0, parity 0."""
    aff = C.to_affine(ecdh)
    x_can = F.canonical(aff.x)
    parity = F.canonical(aff.y)[..., 0] & 1
    return H.tagged_hash(F.limbs_to_words_be(x_can), parity), ecdh.inf


def stage_output_final(hw, spend_x, spend_y) -> C.JacPoint:
    """Hash words -> t x G + spend (the raw hash bytes, no mod-n step)."""
    out = S.fixed_base_mul(F.words_be_to_bytes(hw))
    spend = C.AffinePoint(spend_x, spend_y,
                          torch.zeros((), dtype=torch.bool,
                                      device=hw.device))
    return C.point_madd(out, spend)


def stage_match(final: C.JacPoint, ecdh_inf, row_valid, outputs_hi,
                outputs_lo, outputs_valid, label_x, label_y):
    """Candidates final and final + label_j -> (B,) bool: the row is
    valid, its ECDH finite, and some live candidate's upper 64 bits equal
    a valid output. One shared inversion for all the candidates' Z."""
    no_inf = torch.zeros((), dtype=torch.bool, device=final.x.device)
    candidates = [final] + [
        C.point_madd(final, C.AffinePoint(lx, ly, no_inf))
        for lx, ly in zip(label_x, label_y)]
    zinvs = F.inv_many([F.select(c.inf, F.one_like(c.z), c.z)
                        for c in candidates])
    hit = torch.zeros_like(row_valid)
    for c, zi in zip(candidates, zinvs):
        hit = hit | _candidate_match(c, zi, outputs_hi, outputs_lo,
                                     outputs_valid)
    return hit & row_valid & ~ecdh_inf


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------


def scan_batch(tweak_x, tweak_y, row_valid, outputs_hi, outputs_lo,
               outputs_valid, scan_windows, spend_x, spend_y, label_x,
               label_y, *, nlabels: int):
    """The staged pipeline: three stage calls, then the match. Returns
    (B,) bool."""
    ecdh = stage_ecdh(tweak_x, tweak_y, scan_windows)
    hw, ecdh_inf = stage_serialize_hash(ecdh)
    final = stage_output_final(hw, spend_x, spend_y)
    return stage_match(final, ecdh_inf, row_valid, outputs_hi, outputs_lo,
                       outputs_valid, label_x[:nlabels], label_y[:nlabels])


def scan_batch_fused(tweak_x, tweak_y, row_valid, outputs_hi, outputs_lo,
                     outputs_valid, scan_windows, spend_x, spend_y, label_x,
                     label_y, *, nlabels: int):
    """The reference's single-program variant. Eager torch has no program
    to fuse, so it runs scan_batch's ops (module docstring). Returns (B,)
    bool."""
    return scan_batch(tweak_x, tweak_y, row_valid, outputs_hi, outputs_lo,
                      outputs_valid, scan_windows, spend_x, spend_y, label_x,
                      label_y, nlabels=nlabels)
