"""Batch executor: packed batches through the scan kernel on one device
(counterpart of cudasp_tpu/runtime/executor.py `_run_pallas`, single GPU).

Upload modes (per row at 3 outputs, plus the blockmask row): "full64"
(the 64-byte point, 92 B: the kernel skips the square root), "full" (x
and the y parity bit, 60 B), and the prefilter cuts "hi32" (48 B), "hi16"
(40 B) and "hi8" (36 B), which ship only the top 32, 16 or 8 bits of each
output. A cut's flags are a superset of the exact flags: after the last
batch, the rows it flagged go through an exact second pass on the "full"
wire, and their exact flags replace the prefilter's. "auto" picks a mode
per batch by the reference's model (`auto_decide`); on the CPU it is
"full", as the reference's is under interpret mode.

On a CUDA device each batch's wire planes are staged into a pinned host
buffer and go up in ONE H2D copy on a copy stream; the kernel runs on a
compute stream ordered after that copy by an event, and its flags come
back D2H on the compute stream. A cut's dummy planes never cross the
wire: they are made on the device. Two buffer sets alternate, so batch
i+1 packs on the host and uploads while batch i computes. Every H2D and
every kernel is timed with CUDA events on its own stream; "auto" reads
the link rate and the batch-0 kernel time from them. Everything is one
Python loop of streams and events: no background threads, so a failure
cannot leave the caller waiting on a dead feeder. Any failure of batch i,
or of the exact pass over its rows, raises ExecutionError(i).

On the CPU the same loop calls the kernel's plain version."""

from __future__ import annotations

import time
import warnings
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..io.ingest import PackedBatch
from ..ops import kernels as K
from .errors import ExecutionError
from .metrics import ScanMetrics

CUTS = tuple(hi for hi in K.HI_ONLY if hi)          # hi32, hi16, hi8
UPLOADS = ("full", "full64") + CUTS + ("auto",)
# The kernel's time on the xy wire (full64: no square root) over its time
# on the x wire (full), per 262,144-row launch, measured on an NVIDIA H100
# 80GB HBM3 at a 700 W power limit by chip_smoke.py (PERF.md section 5):
# fixed 14.945 / 16.158 ms, wnaf 13.844 / 15.087 ms, static 15.179 /
# 16.505 ms.
XY_KERNEL_SHARE = {"fixed": 14.945 / 16.158, "wnaf": 13.844 / 15.087,
                   "static": 15.179 / 16.505}
HYSTERESIS = 0.85     # a new mode must model at least 15% faster
VETO_SHARE = 0.05     # more cut rows flagged than this: cuts off, sticky
AUTO_MEMO_MAX = 64    # (ladder, width, M) entries of kernel0 + decision


def wire_rows(mode: str, M: int) -> int:
    """uint32 words a row puts on the wire in `mode` at M outputs (the
    planes; the blockmask row comes on top)."""
    if mode == "full64":
        return 16 + 2 * M + 1
    if mode == "full":
        return 8 + 2 * M + 1
    if mode == "hi32":
        return 8 + M + 1
    return 8 + K.hi_plane_rows(mode, M)


def cut_tag_for(M: int, want: str = "hi8", warn: bool = True) -> str:
    """The cut usable at M outputs a row: the packed validity unit caps
    hi8 at 6 outputs and hi16 at 14, so a cut degrades one notch at a
    time, hi8 -> hi16 -> hi32, with a warning when it was asked for."""
    if want == "hi8" and M > K.HI_UNITS["hi8"][2]:
        if warn:
            warnings.warn(f"hi8 upload supports at most 6 outputs/row "
                          f"(got {M}); using hi16", stacklevel=3)
        want = "hi16"
    if want == "hi16" and M > K.HI_UNITS["hi16"][2]:
        if warn:
            warnings.warn(f"hi16 upload supports at most 14 outputs/row "
                          f"(got {M}); using hi32", stacklevel=3)
        want = "hi32"
    return want


def auto_decide(kernel0: float, rate: float, width: int, M: int, cut: str,
                current: str, veto: bool, xy_share: float) -> str:
    """The reference's model (cudasp_tpu/runtime/executor.py:361-392):
    modeled batch time t(mode) = max(bytes(mode) / rate, kernel(mode)),
    with kernel(full) = kernel(cut) = kernel0 and kernel(full64) = kernel0
    x xy_share. The best mode replaces `current` only when it models 15%
    faster; after the density veto the cut is no candidate."""
    cand = {mode: max(4 * width * wire_rows(mode, M) / rate,
                      kernel0 * (xy_share if mode == "full64" else 1.0))
            for mode in ("full64", "full", cut)}
    if veto:
        del cand[cut]
    best = min(cand, key=cand.get)
    if best != current and cand[best] < HYSTERESIS * cand.get(
            current, float("inf")):
        return best
    return current


def wire_planes(planes, mode: str):
    """The planes of a batch that cross the wire in `mode`: a cut drops
    ol (a dummy), hi16 / hi8 the ovm plane too."""
    if mode not in CUTS:
        return list(planes)
    if mode in K.HI_UNITS:
        return list(planes[:2])
    return [planes[0], planes[1], planes[3]]


def _width(n: int, block_rows: int) -> int:
    """Lane width pack_batch_arrays gives n rows."""
    return max(block_rows, -(-n // block_rows) * block_rows)


def _planes(b: PackedBatch, block_rows: int, mode: str):
    """PackedBatch -> (plane arrays as int32 views, blockmask or None)."""
    planes = K.pack_batch_arrays(
        b.tweak_blobs, b.row_valid, b.outputs_hi, b.outputs_lo,
        b.outputs_valid, block_rows=block_rows,
        wire="xy" if mode == "full64" else "x",
        hi_only=mode if mode in CUTS else None)
    width = planes[0].shape[1]
    bmask = K.live_blockmask(b.n_valid, width // block_rows, block_rows)
    return [p.view(np.int32) for p in planes], bmask


@dataclass
class _Auto:
    """upload="auto" over one scan: the mode it wants, the batch-0 kernel
    seconds, recent (H2D seconds, bytes), and the sticky density veto."""
    want: str = "full"
    kernel0: Optional[float] = None
    uploads: list = field(default_factory=list)
    veto: bool = False


class _Device:
    """Where a batch's flags are computed. submit(planes, bmask, mode, M)
    -> ticket (handle, staging seconds, bytes up); result(ticket, metrics)
    -> (flags, H2D seconds, kernel seconds), the times None off the card.
    timed: whether there are device times for "auto" to read."""

    timed = False

    def __init__(self, ex, digits, static, sp, lab, comb):
        self.ex, self.static = ex, static
        self.args = (digits, sp, lab, comb)

    def flags(self, ops, bmask, mode, M):
        """One launch (or plain-version call) on one upload mode. Flags
        come packed 32 a word where the lane width allows, else int8."""
        width = ops[0].shape[1]
        return K.scan_flags(
            *ops, *self.args, bmask, block_rows=self.ex.block_rows,
            wire="xy" if mode == "full64" else "x",
            pack_flags=width % 32 == 0, ladder=self.ex.ladder,
            static_sched=self.static, hi_only=mode if mode in CUTS else None,
            nout=M)


class _Cpu(_Device):
    """The kernel's plain version, one batch at a time. It has no device
    times, so "auto" is "full" here."""

    def submit(self, planes, bmask, mode, M):
        flags = self.flags([torch.from_numpy(p) for p in planes],
                           None if bmask is None else torch.from_numpy(bmask),
                           mode, M)
        # (ticket, staging seconds, bytes up): nothing crosses a wire here
        return flags.numpy(), 0.0, 0

    def result(self, ticket, metrics):
        """(flags, H2D seconds, kernel seconds): no device times here."""
        return ticket[0], None, None


class _Cuda(_Device):
    """Staging, H2D, kernel and D2H of a batch on one card, two buffer
    sets alternating (module docstring)."""

    timed = True

    def __init__(self, ex, digits, static, sp, lab, comb):
        super().__init__(ex, digits, static, sp, lab, comb)
        dev = ex.device
        self.copy_stream = torch.cuda.Stream(dev)
        self.compute_stream = torch.cuda.Stream(dev)
        self.slots = [None, None]
        self.n = 0
        self.dummies = {}

    def _slot(self, k, words):
        slot = self.slots[k]
        if slot is None or slot["host"].numel() < words:
            # the old set, if any, stays alive with the batch that holds it
            timed = dict(enable_timing=True)
            slot = self.slots[k] = {
                "host": torch.empty(words, dtype=torch.int32,
                                    pin_memory=True),
                "dev": torch.empty(words, dtype=torch.int32,
                                   device=self.ex.device),
                "flags": None,
                "h2d0": torch.cuda.Event(**timed),
                "h2d": torch.cuda.Event(**timed),
                "k0": torch.cuda.Event(**timed),
                "k1": torch.cuda.Event(**timed),
                "done": torch.cuda.Event(**timed),
            }
        return slot

    def _dummy(self, shape):
        """A cut's dummy plane, made on the card (never uploaded)."""
        if shape not in self.dummies:
            self.dummies[shape] = torch.zeros(shape, dtype=torch.int32,
                                              device=self.ex.device)
        return self.dummies[shape]

    def submit(self, planes, bmask, mode, M):
        hi = mode if mode in CUTS else None
        wire = wire_planes(planes, mode)
        width = planes[0].shape[1]
        nrow = sum(p.shape[0] for p in wire) + 1        # + blockmask
        slot = self._slot(self.n % 2, nrow * width)
        self.n += 1
        # the H2D that last read this staging buffer must be done
        slot["h2d"].synchronize()
        t0 = time.perf_counter()
        host = slot["host"][:nrow * width].view(nrow, width)
        hv = host.numpy()
        at, views = 0, []
        for p in wire:
            hv[at:at + p.shape[0]] = p
            views.append((at, at + p.shape[0]))
            at += p.shape[0]
        if bmask is not None:
            hv[at, :len(bmask)] = bmask
        staged = time.perf_counter() - t0
        dv = slot["dev"][:nrow * width].view(nrow, width)
        with torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(slot["done"])
            slot["h2d0"].record(self.copy_stream)
            dv.copy_(host, non_blocking=True)
            slot["h2d"].record(self.copy_stream)
        with torch.cuda.stream(self.compute_stream):
            self.compute_stream.wait_event(slot["h2d"])
            ops = [dv[a:z] for a, z in views]
            if hi is not None:
                ops.insert(2, self._dummy(planes[2].shape))
            if hi in K.HI_UNITS:
                ops.append(self._dummy(planes[3].shape))
            slot["k0"].record(self.compute_stream)
            flags = self.flags(
                ops, None if bmask is None else dv[at, :len(bmask)], mode, M)
            slot["k1"].record(self.compute_stream)
            if slot["flags"] is None or slot["flags"].shape != flags.shape \
                    or slot["flags"].dtype != flags.dtype:
                slot["flags"] = torch.empty(flags.shape, dtype=flags.dtype,
                                            pin_memory=True)
            slot["flags"].copy_(flags, non_blocking=True)
            slot["done"].record(self.compute_stream)
        return slot, staged, 4 * nrow * width

    def result(self, ticket, metrics):
        slot = ticket[0]
        t0 = time.perf_counter()
        slot["done"].synchronize()
        if metrics is not None:
            metrics.device_wait_seconds += time.perf_counter() - t0
        return (slot["flags"].numpy().copy(),
                slot["h2d0"].elapsed_time(slot["h2d"]) / 1e3,
                slot["k0"].elapsed_time(slot["k1"]) / 1e3)


class BatchExecutor:
    """Runs packed batches on one device ("cuda", "cuda:N" or "cpu")
    through one ladder of the scan kernel ("fixed", "wnaf" or "static"),
    on one upload mode of UPLOADS."""

    # process-wide: (ladder, width, M) -> (kernel0 seconds, decision) of
    # "auto", so a later scan of the same shape starts from them
    _auto_memo: "OrderedDict" = OrderedDict()

    def __init__(self, device, block_rows: int = 256, upload: str = "full",
                 ladder: str = "fixed"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available")
        if ladder not in K.LADDERS:
            raise ValueError(f"ladder must be one of {K.LADDERS}, got "
                             f"{ladder!r}")
        if upload not in UPLOADS:
            raise ValueError(f"upload must be one of {UPLOADS}, got "
                             f"{upload!r}")
        self.block_rows = block_rows
        self.upload = upload
        self.ladder = ladder

    def _query(self, spend, labels):
        def t(a):
            return torch.from_numpy(
                np.ascontiguousarray(a).view(np.int32)).to(self.device)
        return t(spend), t(labels), K.comb_table(self.device)

    def run(self, batches, sched, spend, labels,
            metrics: Optional[ScanMetrics] = None) -> List[tuple]:
        """batches: iterable of ingest.PackedBatch (a generator packs lazily).
        sched: ingest.ScanSchedule; spend (2, 8) and labels (L, 2, 8)
        uint32 numpy. Returns per-batch (flags bool (B,), source_rows
        int64 (B,))."""
        t_run = time.perf_counter()
        digits, static = sched.operands(self.ladder)
        cuda = self.device.type == "cuda"
        if cuda:
            # the ladder's kernel is built (a per-key nvcc run for
            # "static") before the first batch is packed: a failed build
            # raises here, and nothing falls back to another ladder
            K.KERNELS[self.ladder].library(static)
        dev = (_Cuda if cuda else _Cpu)(self, digits, static,
                                        *self._query(spend, labels))
        auto = _Auto() if self.upload == "auto" and dev.timed else None
        memo_key = None
        tags = {}
        results = []          # [flags bool (n,), source rows]
        queued = []           # flagged rows of cut batches (exact pass)
        inflight = deque()    # (ticket, batch index, batch, mode)
        used = ["full"]       # the last mode that was not "full"
        density = [0, 0]      # rows on a cut wire, of which flagged

        def mode_for(M):
            if auto is not None:
                want = auto.want
            else:
                want = "full" if self.upload == "auto" else self.upload
            if want not in CUTS:
                return want
            if (M, want) not in tags:
                tags[M, want] = cut_tag_for(M, want, warn=auto is None)
            return tags[M, want]

        def finish(entry):
            ticket, i, b, mode = entry
            flags, h2d_s, kern_s = dev.result(ticket, metrics)
            fl = K.flags_to_bool(flags, len(b.source_rows))
            if mode in CUTS:
                flagged = np.flatnonzero(fl)
                if len(flagged):
                    queued.append((len(results), i, flagged,
                                   b.tweak_blobs[flagged],
                                   b.outputs_hi[flagged],
                                   b.outputs_lo[flagged],
                                   b.outputs_valid[flagged]))
                fl = np.zeros_like(fl)          # the exact pass fills in
                density[0] += len(fl)
                density[1] += len(flagged)
            results.append([fl, b.source_rows])
            if metrics is not None and h2d_s is not None:
                metrics.h2d_seconds += h2d_s
            if auto is None:
                return
            auto.uploads.append((h2d_s, ticket[2]))
            if i == 0 and auto.kernel0 is None:
                auto.kernel0 = kern_s
            if density[0] >= self.block_rows \
                    and density[1] > VETO_SHARE * density[0]:
                # most rows flagged (a high-match table): the exact pass
                # would double the device's work; cuts off for this scan
                auto.veto = True
                if auto.want in CUTS:
                    auto.want = "full"
            M = b.outputs_hi.shape[1]
            rate = max(sent / max(dt, 1e-9)
                       for dt, sent in auto.uploads[-4:])
            width = _width(len(b.source_rows), self.block_rows)
            auto.want = auto_decide(
                auto.kernel0, rate, width, M, cut_tag_for(M, warn=False),
                auto.want, auto.veto, XY_KERNEL_SHARE[self.ladder])
            if metrics is not None:
                metrics.kernel0_seconds = auto.kernel0
                metrics.link_bytes_per_second = rate

        def drain(keep):
            while len(inflight) > keep:
                entry = inflight.popleft()
                try:
                    finish(entry)
                except Exception as e:
                    raise ExecutionError(entry[1], e) from e

        scan_width = 0
        for i, b in enumerate(batches):
            try:
                M = b.outputs_hi.shape[1]
                width = _width(len(b.source_rows), self.block_rows)
                scan_width = max(scan_width, width)
                if auto is not None and i == 0:
                    memo_key = (self.ladder, width, M)
                    memo = BatchExecutor._auto_memo.get(memo_key)
                    if memo is not None:
                        auto.kernel0, auto.want = memo
                mode = mode_for(M)
                if mode != "full":
                    used[0] = mode
                t0 = time.perf_counter()
                planes, bmask = _planes(b, self.block_rows, mode)
                if metrics is not None:
                    metrics.pack_seconds += time.perf_counter() - t0
                ticket = dev.submit(planes, bmask, mode, M)
                if metrics is not None:
                    metrics.upload_seconds += ticket[1]
                    metrics.upload_bytes += ticket[2]
                    metrics.batches += 1
                inflight.append((ticket, i, b, mode))
            except Exception as e:
                raise ExecutionError(i, e) from e
            drain(1)
        drain(0)
        if queued:
            self._reverify(dev, queued, results, scan_width, metrics)
        if auto is not None and memo_key is not None:
            memo = BatchExecutor._auto_memo
            memo[memo_key] = (auto.kernel0, auto.want)
            memo.move_to_end(memo_key)
            while len(memo) > AUTO_MEMO_MAX:
                memo.popitem(last=False)
        if metrics is not None:
            metrics.device_seconds += time.perf_counter() - t_run
            metrics.upload_mode = used[0]
            metrics.ladder = self.ladder
        return [tuple(r) for r in results]

    def _reverify(self, dev, queued, results, width, metrics):
        """The exact pass over the rows a cut flagged: repacked on the
        "full" wire, through the same ladder's kernel, at most `width`
        rows a launch (a block_rows multiple), and their exact flags
        written back into their batches' results. The reference runs the
        pass through the scan's compiled width and ships a cut's tail
        batch full until its program is warm; the port compiles nothing
        in a scan, so every batch ships the wire it asked for and the pass
        takes its own width: a difference in mechanism, not in result."""
        blobs, oh, ol, ov = (np.concatenate([q[k] for q in queued])
                             for k in range(3, 7))
        origin = np.concatenate([np.full(len(q[2]), q[1]) for q in queued])
        rows = len(origin)
        if metrics is not None:
            metrics.reverified_rows += rows
        exact = np.zeros(rows, bool)
        for a in range(0, rows, width):
            z = min(a + width, rows)
            try:
                b = PackedBatch(blobs[a:z], np.ones(z - a, bool), oh[a:z],
                                ol[a:z], ov[a:z],
                                np.arange(a, z, dtype=np.int64))
                planes, bmask = _planes(b, self.block_rows, "full")
                ticket = dev.submit(planes, bmask, "full", oh.shape[1])
                if metrics is not None:
                    metrics.upload_seconds += ticket[1]
                    metrics.upload_bytes += ticket[2]
                flags = dev.result(ticket, metrics)[0]
                exact[a:z] = K.flags_to_bool(flags, z - a)
            except Exception as e:
                raise ExecutionError(int(origin[a]), e) from e
        at = 0
        for slot, _, flagged, *_ in queued:
            results[slot][0][flagged] = exact[at:at + len(flagged)]
            at += len(flagged)
