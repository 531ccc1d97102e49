"""Columnar ingest: host-side packing of scan inputs into fixed-shape
batches (counterpart of cudasp_tpu/io/ingest.py:112-273, kernel layout
only). Ragged per-row output lists become padded (B, M) planes; rows with
more than M outputs split into virtual rows that share a source index,
gathered by the port's C packer (io/native.py count_chunks and
pack_outputs); dense tables take numpy slices. The XLA backend
(ops/pipeline.py) reads the same batches, through the kernel's "xy" wire
planes (the literal 64-byte point): it needs no layout of its own."""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from ..oracle.encoding import blob32_to_scalar, blob64_to_point
from ..ops import field as F
from ..ops import scalar as S
from . import native


def point_blobs_to_limbs(blobs: np.ndarray):
    """(B, 64) uint8 point blobs (LE x || LE y) -> two (8, B) uint32 word
    planes: the port's kernel format of the x and y coordinates (the C
    packer's pack_points)."""
    return native.pack_points(blobs)


def split_outputs_i64(vals: np.ndarray):
    """int64 array -> (hi, lo) int32 bit halves."""
    v = np.ascontiguousarray(np.asarray(vals, dtype=np.int64))
    if sys.byteorder == "little":
        w = v.view(np.int32).reshape(v.shape + (2,))
        return np.ascontiguousarray(w[..., 1]), np.ascontiguousarray(w[..., 0])
    lo = (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32).reshape(v.shape)
    hi = ((v >> 32) & 0xFFFFFFFF).astype(np.uint32).view(np.int32).reshape(
        v.shape)
    return hi, lo


def outputs_to_csr(outputs_list: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """List of per-row int64 sequences -> (flat values, offsets (n+1,))."""
    lens = np.fromiter((len(o) for o in outputs_list), dtype=np.int64,
                       count=len(outputs_list))
    offsets = np.zeros(len(outputs_list) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    if offsets[-1]:
        flat = np.concatenate([np.asarray(o, dtype=np.int64).reshape(-1)
                               for o in outputs_list if len(o)])
    else:
        flat = np.zeros(0, np.int64)
    return flat, offsets


@dataclass
class PackedBatch:
    """One fixed-shape batch (B rows, M output slots)."""
    tweak_blobs: np.ndarray     # (B, 64) uint8
    row_valid: np.ndarray       # (B,) bool
    outputs_hi: np.ndarray      # (B, M) int32
    outputs_lo: np.ndarray      # (B, M) int32
    outputs_valid: np.ndarray   # (B, M) bool
    source_rows: np.ndarray     # (B,) int64 original row index, -1 = pad

    @property
    def n_valid(self) -> int:
        return int(self.row_valid.sum())


def iter_packed(tweak_blobs: np.ndarray, outputs_flat: np.ndarray,
                outputs_offsets: np.ndarray, batch_size: int,
                max_outputs: int, row_indices: Optional[np.ndarray] = None,
                ramp: int = 0):
    """Yield PackedBatches of batch_size rows, lazily, so the executor's
    feeder packs ahead while the device computes. Rows with empty outputs
    are dropped (they can never match); rows with more than max_outputs
    values split into virtual rows sharing a source index (the executor's
    feeder times the pulls: metrics.pack_seconds). ramp: if > 0 and the
    table spans more than one batch, the first batch is this many rows (a
    small pipeline-fill batch: the first upload overlaps nothing), as in
    the JAX package's iter_packed(ramp=)."""
    tweak_blobs = np.ascontiguousarray(tweak_blobs, dtype=np.uint8)
    offsets = np.ascontiguousarray(outputs_offsets, dtype=np.int64)
    n = len(offsets) - 1
    if row_indices is None:
        row_indices = np.arange(n, dtype=np.int64)
    lens = offsets[1:] - offsets[:-1]
    # dense tables (every row has exactly max_outputs values) take slices
    uniform = bool((lens == max_outputs).all())
    if uniform:
        total = n
        src = chunk = None
    else:
        nch, total = native.count_chunks(offsets, max_outputs)
        src = np.repeat(np.arange(n, dtype=np.int64), nch)
        cum = np.zeros(n + 1, np.int64)
        np.cumsum(nch, out=cum[1:])
        chunk = np.arange(total, dtype=np.int64) - np.repeat(cum[:-1], nch)
    if total == 0:
        return
    flat = np.ascontiguousarray(outputs_flat, np.int64)
    flat2d = flat.reshape(n, max_outputs) if uniform else None
    use_ramp = bool(ramp and 0 < ramp < batch_size and total > batch_size)
    starts = ([0] + list(range(ramp, total, batch_size)) if use_ramp
              else list(range(0, total, batch_size)))
    for bi, start in enumerate(starts):
        stop = starts[bi + 1] if bi + 1 < len(starts) else total
        k = stop - start
        pad = (ramp if use_ramp and bi == 0 else batch_size) - k
        sl = slice(start, stop)

        def padrows(a, fill=0):
            if pad == 0:
                return a
            return np.concatenate(
                [a, np.full((pad,) + a.shape[1:], fill, dtype=a.dtype)])

        if uniform:
            hi, lo = split_outputs_i64(flat2d[sl])
            vmask = np.ones((k, max_outputs), bool)
            blobs = tweak_blobs[sl]
            srcs = row_indices[sl]
        else:
            hi, lo, vmask = native.pack_outputs(flat, offsets, src[sl],
                                                chunk[sl], max_outputs)
            blobs = tweak_blobs[src[sl]]
            srcs = row_indices[src[sl]]
        batch = PackedBatch(
            tweak_blobs=padrows(blobs),
            row_valid=np.concatenate([np.ones(k, bool), np.zeros(pad, bool)]),
            outputs_hi=padrows(hi), outputs_lo=padrows(lo),
            outputs_valid=padrows(vmask),
            source_rows=padrows(srcs, fill=-1))
        yield batch


@dataclass(frozen=True)
class ScanSchedule:
    """The scan key's ladder schedules (counterpart of the JAX package's
    ScanSchedule)."""
    odd: np.ndarray          # (2, 34) int32, the "fixed" ladder
    wnaf: np.ndarray         # (2, 54) int32, the "wnaf" ladder
    wnaf_static: tuple       # (nd, code) pairs, the per-key "static" build
    glv: tuple               # scalar.glv_windows: the XLA backend's ladder

    def operands(self, ladder: str):
        """(digits, static_sched) as scan_flags takes them for `ladder`."""
        if ladder == "static":
            return None, self.wnaf_static
        return (self.wnaf if ladder == "wnaf" else self.odd), None


def pack_query_keys(scan_key_blob: bytes, spend_blob: bytes,
                    label_blobs: Iterable[bytes]):
    """Per-query shared operands in kernel format:
    (ScanSchedule, spend (2, 8) uint32 [x words, y words],
    labels (L, 2, 8) uint32, L)."""
    k = blob32_to_scalar(bytes(scan_key_blob))
    sched = ScanSchedule(S.glv_odd_sched(k), S.glv_wnaf_steps(k),
                         S.glv_wnaf_static(k), S.glv_windows(k))
    spend = np.stack([F.int_to_words(c)
                      for c in blob64_to_point(bytes(spend_blob))])
    labels = [blob64_to_point(bytes(lb)) for lb in label_blobs]
    lab = np.zeros((len(labels), 2, F.NWORDS), np.uint32)
    for i, (lx, ly) in enumerate(labels):
        lab[i, 0] = F.int_to_words(lx)
        lab[i, 1] = F.int_to_words(ly)
    return sched, spend, lab, len(labels)
