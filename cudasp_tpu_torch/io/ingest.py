"""Columnar ingest: host-side packing of scan inputs into fixed-shape
batches (counterpart of cudasp_tpu/io/ingest.py:112-273, kernel layout
only). Ragged per-row output lists become padded (B, M) planes; rows with
more than M outputs split into virtual rows that share a source index.
Everything is vectorised numpy. The XLA backend (ops/pipeline.py) reads
the same batches, through the kernel's "xy" wire planes (the literal
64-byte point): it needs no layout of its own."""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from ..oracle.encoding import blob32_to_scalar, blob64_to_point
from ..ops import field as F
from ..ops import scalar as S


def point_blobs_to_limbs(blobs: np.ndarray):
    """(B, 64) uint8 point blobs (LE x || LE y) -> two (8, B) uint32 word
    planes: the port's kernel format of the x and y coordinates."""
    b = np.ascontiguousarray(blobs, dtype=np.uint8)
    if b.ndim != 2 or b.shape[1] != 64:
        raise ValueError("expected (B, 64) byte array")
    words = b.view("<u4").astype(np.uint32)               # (B, 16)
    return (np.ascontiguousarray(words[:, :8].T),
            np.ascontiguousarray(words[:, 8:].T))


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
                pack_seconds: Optional[list] = None):
    """Yield PackedBatches of batch_size rows, lazily, so the executor packs
    batch i+1 while the device computes batch i. Rows with empty outputs
    are dropped (they can never match); rows with more than max_outputs
    values split into virtual rows sharing a source index.
    pack_seconds: optional 1-element list accumulating host pack time."""
    t0 = time.perf_counter()
    tweak_blobs = np.ascontiguousarray(tweak_blobs, dtype=np.uint8)
    offsets = np.asarray(outputs_offsets, dtype=np.int64)
    n = len(offsets) - 1
    if row_indices is None:
        row_indices = np.arange(n, dtype=np.int64)
    lens = offsets[1:] - offsets[:-1]
    # dense tables (every row has exactly max_outputs values) take slices
    uniform = bool((lens == max_outputs).all())
    if uniform:
        total = n
        src = starts = take = None
    else:
        nch = (lens + max_outputs - 1) // max_outputs
        total = int(nch.sum())
        src = np.repeat(np.arange(n, dtype=np.int64), nch)
        cum = np.zeros(n + 1, np.int64)
        np.cumsum(nch, out=cum[1:])
        chunk = np.arange(total, dtype=np.int64) - np.repeat(cum[:-1], nch)
        starts = offsets[src] + chunk * max_outputs
        take = np.minimum(lens[src] - chunk * max_outputs, max_outputs)
    if pack_seconds is not None:
        pack_seconds[0] += time.perf_counter() - t0
    if total == 0:
        return
    midx = np.arange(max_outputs, dtype=np.int64)[None]
    flat = np.asarray(outputs_flat, np.int64)
    flat2d = flat.reshape(n, max_outputs) if uniform else None
    for start in range(0, total, batch_size):
        t0 = time.perf_counter()
        stop = min(start + batch_size, total)
        k = stop - start
        pad = batch_size - k
        sl = slice(start, stop)

        def padrows(a, fill=0):
            if pad == 0:
                return a
            return np.concatenate(
                [a, np.full((pad,) + a.shape[1:], fill, dtype=a.dtype)])

        if uniform:
            vals = flat2d[sl]
            vmask = np.ones((k, max_outputs), bool)
            blobs = tweak_blobs[sl]
            srcs = row_indices[sl]
        else:
            gidx = starts[sl, None] + midx
            vmask = midx < take[sl, None]
            vals = flat[np.where(vmask, gidx, 0)]
            blobs = tweak_blobs[src[sl]]
            srcs = row_indices[src[sl]]
        hi, lo = split_outputs_i64(vals)
        batch = PackedBatch(
            tweak_blobs=padrows(blobs),
            row_valid=np.concatenate([np.ones(k, bool), np.zeros(pad, bool)]),
            outputs_hi=padrows(hi), outputs_lo=padrows(lo),
            outputs_valid=padrows(vmask),
            source_rows=padrows(srcs, fill=-1))
        if pack_seconds is not None:
            pack_seconds[0] += time.perf_counter() - t0
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
