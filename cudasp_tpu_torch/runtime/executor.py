"""Batch executor: packed batches through the scan kernel on one device
or a mesh (counterpart of cudasp_tpu/runtime/executor.py `_run_pallas`).

Upload modes (per row at 3 outputs, plus the blockmask row): "full64"
(the 64-byte point, 92 B: the kernel skips the square root), "full" (x
and the y parity bit, 60 B), and the prefilter cuts "hi32" (48 B), "hi16"
(40 B) and "hi8" (36 B), which ship only the top 32, 16 or 8 bits of each
output. A cut's flags are a superset of the exact flags: after the last
batch, the rows it flagged go through an exact second pass on the "full"
wire, and their exact flags replace the prefilter's. "auto" picks a mode
per batch by the reference's model (`auto_decide`); on the CPU it is
"full", as the reference's is under interpret mode.

A feeder thread (the counterpart of the reference's, cudasp_tpu/
runtime/executor.py:433-455 and :634-970) pulls the batches from the
ingest generator, picks each one's mode and packs it with the port's C
packer (io/native.py pack_wire: the planes and the block mask in one
pass) into a bounded queue of QUEUE_DEPTH; the caller's thread takes them
in order and keeps the H2D, the launch, the wait and the retry. The
feeder's put retries every PUT_TIMEOUT_S until the caller stops it; the
caller, on its way out, stops the feeder, drains the queue and joins it
(JOIN_TIMEOUT_S), and raises if it is still alive, so no scan leaves a
thread behind or a caller waiting on a dead one. Under "auto" the feeder
reads the mode when it packs, so the decision lags the batches in flight
by up to the queue's depth, as the reference's does.

On a CUDA device the feeder packs each batch straight into one of NSLOTS
pinned staging slots of the card (after waiting on the event of the H2D
that last read it: the only CUDA call it makes besides allocating the
pinned memory), and the batch goes up in ONE H2D copy on a copy stream;
the kernel runs on a compute stream ordered after that copy by an event,
and its flags come back D2H on the compute stream. The slots cover the
queue, the batch the feeder holds and the two in flight. A cut's dummy
planes never cross the wire: they are made on the device. Every H2D and
every kernel is timed with CUDA events on its own stream; "auto" reads
the link rate and the batch-0 kernel time from them.

A batch whose launch or result fails runs once more, re-packed from its
PackedBatch on the caller's thread, on a spare set of buffers and streams
(the pinned slot it used may already hold a later batch), and counts in
metrics.batch_retries; a second failure raises ExecutionError(i). A
sticky CUDA error (an illegal address) leaves the context unusable, so
its retry fails too and raises. A failure to pack batch i, or of the
exact pass over its rows, raises ExecutionError(i) at once. The steps of
a batch are named spans (runtime.trace.annotate): cudasp.pack,
cudasp.stage_h2d, cudasp.launch, cudasp.wait and cudasp.exact_pass.

With a mesh (parallel.mesh; the counterpart of the reference's
shard_map), the feeder packs each batch whole and the caller's thread
splits it into the mesh's contiguous lane shards: every entry stages its
shard into its own pinned slots and uploads it on its own copy stream, one
ops.kernels.scan_flags_sharded call launches the kernel once per entry on
that entry's compute stream, and each entry's flags come back on it. The
batch pads to block_rows x entries; flags pack per shard where the shard
width allows. "auto" models from the slowest entry's kernel and the
batch's bytes over the longest H2D. With rebalance=True, every batch goes
through the row exchange (parallel.exchange) first, on the "full" wire,
with its source rows as two more planes that come back with the flags.

On the CPU the same feeder and loop call the kernel's plain version.

backend="xla" (the counterpart of the reference's _run_xla,
cudasp_tpu/runtime/executor.py:230-283) runs the same loop over another
run, _XlaRun: every batch ships the "full64" wire (the literal 64-byte
point), staged and uploaded as above, and ops/pipeline.py computes its
flags in torch tensor ops on the compute stream; on a mesh each entry runs
the pipeline over its own lane shard on its own device, and the flags come
back in row order. At most two batches are in flight, a failed batch runs
once more and then raises ExecutionError(i), and the metrics count as on
the kernel's path. As on the reference's XLA backend, upload, ladder and
rebalance do nothing there: no cut, no exact pass, no "auto", no
exchange."""

from __future__ import annotations

import contextlib
import queue
import sys
import threading
import time
import warnings
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..io import native
from ..io.ingest import PackedBatch, split_outputs_i64
from ..ops import kernels as K
from ..ops import pipeline as PL
from .errors import ExecutionError
from .metrics import ScanMetrics
from .trace import annotate

CUTS = tuple(hi for hi in K.HI_ONLY if hi)          # hi32, hi16, hi8
UPLOADS = ("full", "full64") + CUTS + ("auto",)
BACKENDS = ("pallas", "xla")      # the scan kernel, or ops/pipeline.py
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
QUEUE_DEPTH = 3       # packed batches the feeder may hold ready
PUT_TIMEOUT_S = 0.2   # the feeder's put (and slot wait) retries this often
JOIN_TIMEOUT_S = 10.0
# pinned staging slots of a card: the queue, the batch the feeder holds
# and the two in flight
NSLOTS = QUEUE_DEPTH + 3


def wire_rows(mode: str, M: int) -> int:
    """uint32 words a row puts on the wire in `mode` at M outputs (the
    planes; the blockmask row comes on top)."""
    return native.plane_rows(mode, M)


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


def _width(n: int, pad_to: int) -> int:
    """Lane width of a batch of n rows: a multiple of pad_to."""
    return max(pad_to, -(-n // pad_to) * pad_to)


@dataclass
class _Packed:
    """One batch on one mode's wire: host holds the planes that cross the
    wire, then the block-mask row, (rows, width) int32; spans their rows;
    bmask the block mask (a view of its row) or None when every block is
    live; slot the card's pinned slot that holds host (None off the
    direct path); seconds the C packer's."""
    host: np.ndarray
    spans: list
    bmask: Optional[np.ndarray]
    slot: Optional[int] = None
    seconds: float = 0.0

    @property
    def width(self) -> int:
        return self.host.shape[1]

    def wire(self):
        return [self.host[a:z] for a, z in self.spans]


def _spans(mode: str, M: int):
    """Rows of each plane that crosses the wire in `mode`: the tweak
    words, then oh, ol, ovm (exact wires), oh, ovm (hi32) or the packed
    units (hi16 / hi8)."""
    tw = 16 if mode == "full64" else 8
    sizes = [tw, M, M, 1] if mode in ("full", "full64") else (
        [tw, M, 1] if mode == "hi32" else [tw, wire_rows(mode, M) - tw])
    at = np.cumsum([0] + sizes)
    return [(int(a), int(z)) for a, z in zip(at[:-1], at[1:])]


def pack_host(b: PackedBatch, block_rows: int, mode: str,
              pad_to: Optional[int] = None, out=None) -> _Packed:
    """PackedBatch -> _Packed on `mode`'s wire, by the C packer
    (io/native.py pack_wire), the lanes padded to a multiple of pad_to
    (block_rows x mesh entries; default block_rows), into out (a pinned
    slot's words) or a new array."""
    width = _width(len(b.source_rows), pad_to or block_rows)
    t0 = time.perf_counter()
    host = native.pack_wire(b.tweak_blobs, b.row_valid, b.outputs_hi,
                            b.outputs_lo, b.outputs_valid, mode, width,
                            block_rows, b.n_valid, out=out).view(np.int32)
    seconds = time.perf_counter() - t0
    bm = host[-1, :width // block_rows]
    return _Packed(host, _spans(mode, b.outputs_hi.shape[1]),
                   None if bm.all() else bm, seconds=seconds)


@dataclass
class _Auto:
    """upload="auto" over one scan: the mode it wants, the batch-0 kernel
    seconds, recent (H2D seconds, bytes), and the sticky density veto."""
    want: str = "full"
    kernel0: Optional[float] = None
    uploads: list = field(default_factory=list)
    veto: bool = False


@dataclass
class _Fault:
    """The feeder's failure on batch `index`."""
    index: int
    error: BaseException


def _src_planes(sources, width: int):
    """A batch's source rows, padded to `width` with -1, as the (1, width)
    int32 halves that travel with their rows through the exchange."""
    s = np.full(width, -1, np.int64)
    s[:len(sources)] = sources
    return [h[None] for h in split_outputs_i64(s)]


def _join_src(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi[0].astype(np.int64) << 32) | (lo[0].astype(np.int64)
                                            & 0xFFFFFFFF)


class _Cpu:
    """One CPU entry: planes become tensors as they are; no device times,
    so "auto" is "full" here."""

    timed = False
    ring = False          # no pinned slots: the feeder packs into arrays

    def __init__(self, device):
        self.device = device
        self.compute_stream = None

    def stage(self, wire, bmask):
        """(numpy planes, blockmask) -> ticket (slot, device planes,
        device blockmask, staging seconds, bytes up)."""
        return (None, [torch.from_numpy(np.ascontiguousarray(p))
                       for p in wire],
                None if bmask is None else torch.from_numpy(bmask), 0.0, 0)

    def dummy(self, shape):
        return torch.zeros(shape, dtype=torch.int32)

    def on(self):
        return contextlib.nullcontext()

    def mark(self, slot):
        pass

    def collect(self, slot, outs):
        return outs

    def wait(self, slot, outs, metrics):
        """(outputs as numpy, H2D seconds, kernel seconds): no device
        times here."""
        return [o.numpy() for o in outs], None, None


_EVENTS = ("h2d0", "h2d", "k0", "x1", "k1", "done")


class _Cuda:
    """Staging, H2D, kernel and D2H on one card (or one mesh entry of it)
    through NSLOTS pinned staging slots, each with its device buffer, D2H
    buffers and events (module docstring). Each entry has its own copy
    and compute streams, slots and dummies. A slot is taken from `free`
    (FIFO) to be packed or staged, and goes back once its H2D is issued;
    whoever writes a slot's host words first waits on the event of the H2D
    that last read them."""

    timed = True
    ring = True

    def __init__(self, device):
        self.device = device
        self.copy_stream = torch.cuda.Stream(device)
        self.compute_stream = torch.cuda.Stream(device)
        self.slots = [{ev: torch.cuda.Event(enable_timing=True)
                       for ev in _EVENTS} for _ in range(NSLOTS)]
        self.free = queue.Queue()
        for k in range(NSLOTS):
            self.free.put(k)
        self.dummies = {}

    def take(self, stop=None):
        """A free slot's index. With `stop` (the feeder), waits while
        every slot holds a batch not yet uploaded, and returns None once
        stop is set; without (the caller's thread, where every slot is
        free), raises when none is."""
        if stop is None:
            try:
                return self.free.get_nowait()
            except queue.Empty:
                raise RuntimeError("no free staging slot") from None
        while not stop.is_set():
            try:
                return self.free.get(timeout=PUT_TIMEOUT_S)
            except queue.Empty:
                continue
        return None

    def host_words(self, k, words) -> np.ndarray:
        """Slot k's pinned host words as numpy (grown to `words`), once
        the H2D that last read them is done."""
        slot = self.slots[k]
        slot["h2d"].synchronize()
        host = slot.get("host")
        if host is None or host.numel() < words:
            host = slot["host"] = torch.empty(words, dtype=torch.int32,
                                              pin_memory=True)
        return host.numpy()

    def dummy(self, shape):
        """A cut's dummy plane, made on the card (never uploaded)."""
        if shape not in self.dummies:
            self.dummies[shape] = torch.zeros(shape, dtype=torch.int32,
                                              device=self.device)
        return self.dummies[shape]

    def on(self):
        return torch.cuda.stream(self.compute_stream)

    def upload(self, k, pk: _Packed):
        """The H2D of packed batch pk from slot k, which goes back to the
        free slots -> ticket (slot, device planes, device blockmask,
        seconds to issue it, bytes up)."""
        slot = self.slots[k]
        try:
            t0 = time.perf_counter()
            rows, width = pk.host.shape
            words = rows * width
            dev = slot.get("dev")
            if dev is None or dev.numel() < words:
                # the old buffer, if any, stays alive with the batch that
                # holds it
                dev = slot["dev"] = torch.empty(words, dtype=torch.int32,
                                                device=self.device)
            dv = dev[:words].view(rows, width)
            with torch.cuda.stream(self.copy_stream):
                self.copy_stream.wait_event(slot["done"])
                slot["h2d0"].record(self.copy_stream)
                dv.view(-1).copy_(slot["host"][:words], non_blocking=True)
                slot["h2d"].record(self.copy_stream)
            self.compute_stream.wait_event(slot["h2d"])
            slot["k0"].record(self.compute_stream)
            slot["exchanged"] = False
            issued = time.perf_counter() - t0
        finally:
            self.free.put(k)
        return (slot, [dv[a:z] for a, z in pk.spans],
                None if pk.bmask is None else dv[rows - 1, :len(pk.bmask)],
                issued, 4 * words)

    def stage(self, wire, bmask):
        """(numpy planes, blockmask) copied into a free slot on the
        caller's thread, then uploaded -> ticket as upload's, the copy's
        seconds included."""
        width = wire[0].shape[1]
        nrow = sum(p.shape[0] for p in wire) + 1        # + blockmask
        k = self.take()
        try:
            host = self.host_words(k, nrow * width)[:nrow * width].reshape(
                nrow, width)
            t0 = time.perf_counter()
            at, spans = 0, []
            for p in wire:
                host[at:at + p.shape[0]] = p
                spans.append((at, at + p.shape[0]))
                at += p.shape[0]
            if bmask is not None:
                host[at, :len(bmask)] = bmask
            staged = time.perf_counter() - t0
        except BaseException:
            self.free.put(k)
            raise
        pk = _Packed(host, spans, None if bmask is None
                     else host[at, :len(bmask)])
        slot, ops, bm, issued, nbytes = self.upload(k, pk)
        return slot, ops, bm, staged + issued, nbytes

    def mark(self, slot):
        """The exchange ends here; the kernel starts."""
        slot["x1"].record(self.compute_stream)
        slot["exchanged"] = True

    def collect(self, slot, outs):
        """The batch's outputs come back D2H on the compute stream into
        pinned buffers of the slot."""
        with torch.cuda.stream(self.compute_stream):
            slot["k1"].record(self.compute_stream)
            if [(o.shape, o.dtype) for o in slot.get("out", [])] != [
                    (o.shape, o.dtype) for o in outs]:
                slot["out"] = [torch.empty(o.shape, dtype=o.dtype,
                                           pin_memory=True) for o in outs]
            for h, o in zip(slot["out"], outs):
                h.copy_(o, non_blocking=True)
            slot["done"].record(self.compute_stream)
        return slot["out"]

    def wait(self, slot, outs, metrics):
        t0 = time.perf_counter()
        slot["done"].synchronize()
        if metrics is not None:
            metrics.device_wait_seconds += time.perf_counter() - t0
        k0 = slot["x1"] if slot["exchanged"] else slot["k0"]
        return ([o.numpy().copy() for o in outs],
                slot["h2d0"].elapsed_time(slot["h2d"]) / 1e3,
                k0.elapsed_time(slot["k1"]) / 1e3)


def _exchange_span(slots) -> float:
    """Seconds of a batch's exchange, by CUDA events: on each device, from
    the last of its entries' inputs being ready (k0) to the last of them
    exchanged (x1); the longest over the devices. Events of one device
    compare across its streams, not across devices."""
    span = 0.0
    for dev in dict.fromkeys(d for d, _ in slots):
        evs = [slot for d, slot in slots if d == dev]
        ref = evs[0]["k0"]

        def last(name):
            return max((s[name] for s in evs),
                       key=lambda e: ref.elapsed_time(e))
        span = max(span, last("k0").elapsed_time(last("x1")) / 1e3)
    return span


def _with_dummies(entry, ops, mode, M):
    """A cut's wire planes plus its dummies, made on the entry's device,
    in the kernel's operand order: ol (M, 1) on hi32, (1, 1) on hi16 /
    hi8, where ovm is a (1, 1) dummy too."""
    if mode in CUTS:
        ops.insert(2, entry.dummy((1, 1) if mode in K.HI_UNITS else (M, 1)))
    if mode in K.HI_UNITS:
        ops.append(entry.dummy((1, 1)))
    return ops


class _Run:
    """Where a scan's batches run: one device, or each mesh entry over its
    lane shard. pack(b, mode, stop) -> _Packed (the feeder's half, or the
    caller's for a retry and the exact pass); submit(packed, mode, M,
    sources) -> ticket (handle, staging seconds, bytes up);
    result(ticket, metrics) -> (flags, source rows or None for the
    batch's own, H2D seconds, kernel seconds), the times None off the
    card; on a mesh the slowest entry's."""

    # one card: the feeder packs straight into its pinned slots
    direct = True

    def __init__(self, ex, entries, digits, static, query):
        self.ex, self.entries, self.static = ex, entries, static
        self.digits, self.query = digits, query
        self.timed = entries[0].timed

    def pack(self, b, mode, stop=None):
        """b on `mode`'s wire: into a free pinned slot of the card (None
        when `stop` is set while it waits for one), else into an array
        that the caller's thread stages."""
        e = self.entries[0]
        br, pad_to = self.ex.block_rows, self.ex.pad_to
        if not (self.direct and e.ring):
            return pack_host(b, br, mode, pad_to)
        k = e.take(stop)
        if k is None:
            return None
        try:
            words = (wire_rows(mode, b.outputs_hi.shape[1]) + 1) * _width(
                len(b.source_rows), pad_to)
            pk = pack_host(b, br, mode, pad_to, out=e.host_words(k, words))
        except BaseException:
            e.free.put(k)
            raise
        pk.slot = k
        return pk

    def _kw(self, mode, M, pack):
        return dict(block_rows=self.ex.block_rows,
                    wire="xy" if mode == "full64" else "x",
                    pack_flags=pack, ladder=self.ex.ladder,
                    static_sched=self.static,
                    hi_only=mode if mode in CUTS else None, nout=M)

    def submit(self, pk, mode, M, sources=None):
        """One launch (or plain-version call) on one upload mode. Flags
        come packed 32 a word where the lane width allows, else int8."""
        e = self.entries[0]
        with annotate("cudasp.stage_h2d"):
            if pk.slot is not None:
                slot, ops, bm, staged, nbytes = e.upload(pk.slot, pk)
            else:
                slot, ops, bm, staged, nbytes = e.stage(pk.wire(), pk.bmask)
        ops = _with_dummies(e, ops, mode, M)
        sp, lab, comb = self.query[e.device]
        with e.on(), annotate("cudasp.launch"):
            flags = K.scan_flags(*ops, self.digits, sp, lab, comb, bm,
                                 **self._kw(mode, M, pk.width % 32 == 0))
        return [(e, slot, e.collect(slot, [flags]))], staged, nbytes

    def result(self, ticket, metrics):
        with annotate("cudasp.wait"):
            res = [e.wait(slot, outs, metrics)
                   for e, slot, outs in ticket[0]]
        outs = [np.concatenate(parts, axis=1)
                for parts in zip(*(r[0] for r in res))]
        sources = _join_src(outs[1], outs[2]) if len(outs) == 3 else None
        if not self.timed:
            return outs[0], sources, None, None
        if sources is not None and metrics is not None:
            metrics.exchange_seconds += _exchange_span(
                [(e.device, slot) for e, slot, _ in ticket[0]])
        return (outs[0], sources, max(r[1] for r in res),
                max(r[2] for r in res))


class _MeshRun(_Run):
    """Each batch split into the mesh's lane shards: every entry stages
    and uploads its own shard on its own streams, one scan_flags_sharded
    call launches the kernel on each, and the flags come back per entry.
    With rebalance, the exchange (parallel.exchange) first evens out the
    live rows, and the source rows travel with them."""

    direct = False

    def submit(self, pk, mode, M, sources=None):
        from ..parallel import exchange as X
        from ..parallel.mesh import lane_ranges

        mesh = self.ex.mesh
        n = mesh.size
        B = pk.width
        nbl = B // self.ex.block_rows // n
        wire, bmask = pk.wire(), pk.bmask
        if sources is not None:
            # the exchange makes its own block masks on the device
            wire += _src_planes(sources, B)
            bmask = None
        ticket, staged, nbytes, ops, bms = [], 0.0, 0, [], []
        with annotate("cudasp.stage_h2d"):
            for k, (e, (a, z)) in enumerate(zip(
                    self.entries, lane_ranges(n, B))):
                slot, o, bm, s, b = e.stage(
                    [p[:, a:z] for p in wire],
                    None if bmask is None
                    else bmask[k * nbl:(k + 1) * nbl])
                ticket.append((e, slot))
                staged, nbytes = staged + s, nbytes + b
                ops.append(_with_dummies(e, o, mode, M))
                bms.append(bm)
        lanes = [list(x) for x in zip(*ops)]
        streams = [e.compute_stream for e in self.entries]
        sp, lab, comb = ({d: q[j] for d, q in self.query.items()}
                         for j in range(3))
        if sources is not None:
            tw, oh, ol, ovm, shi, slo = lanes
            (tw, oh, ol, shi, slo, ovm), _, bms = X.rebalance(
                mesh, tw, oh, ol, shi, slo, ovm,
                block_rows=self.ex.block_rows, streams=streams)
            for e, slot in ticket:
                e.mark(slot)
            lanes, extra = [tw, oh, ol, ovm], [shi, slo]
            pack = False
        else:
            extra, pack = [], (B // n) % 32 == 0
        with annotate("cudasp.launch"):
            flags = K.scan_flags_sharded(
                mesh, *lanes, self.digits, sp, lab, comb,
                None if bms[0] is None else bms, streams=streams,
                **self._kw(mode, M, pack))
        ticket = [(e, slot, e.collect(slot, [f] + [x[k] for x in extra]))
                  for k, ((e, slot), f) in enumerate(zip(ticket, flags))]
        return ticket, staged, nbytes


class _XlaRun(_Run):
    """backend="xla": each batch's "full64" planes staged and uploaded per
    mesh entry (one entry off a mesh), and ops/pipeline.py over each
    entry's lane shard on that entry's compute stream; (1, B) int8
    flags."""

    direct = False

    def submit(self, pk, mode, M, sources=None):
        from ..parallel.mesh import lane_ranges

        fn = PL.scan_batch_fused if self.ex.fused else PL.scan_batch
        planes = pk.wire()
        ticket, staged, nbytes = [], 0.0, 0
        for e, (a, z) in zip(self.entries, lane_ranges(
                len(self.entries), pk.width)):
            with annotate("cudasp.stage_h2d"):
                slot, ops, _, s, b = e.stage([p[:, a:z] for p in planes],
                                             None)
            staged, nbytes = staged + s, nbytes + b
            sx, sy, lx, ly = self.query[e.device]
            with e.on(), annotate("cudasp.launch"), \
                    torch.inference_mode():
                hit = fn(*PL.from_planes(*ops), self.digits, sx, sy, lx,
                         ly, nlabels=lx.shape[0])
                flags = hit.to(torch.int8)[None]
            ticket.append((e, slot, e.collect(slot, [flags])))
        return ticket, staged, nbytes


class BatchExecutor:
    """Runs packed batches on one device ("cuda", "cuda:N" or "cpu"), or on
    a mesh (parallel.mesh.Mesh: each entry over its lane shard), through
    one ladder of the scan kernel ("fixed", "wnaf" or "static"), on one
    upload mode of UPLOADS; or, with backend="xla", through ops/pipeline.py
    on the "full64" wire (module docstring; fused picks
    scan_batch_fused). rebalance (mesh only, kernel only) sends every
    batch through the row exchange first, on the "full" wire, as the
    reference does."""

    # process-wide: (ladder, width, M[, mesh]) -> (kernel0 seconds,
    # decision) of "auto", so a later scan of the same shape starts from
    # them; concurrent scans read and write it under _memo_lock only
    _auto_memo: "OrderedDict" = OrderedDict()
    _memo_lock = threading.Lock()

    def __init__(self, device, block_rows: int = 256, upload: str = "full",
                 ladder: str = "fixed", mesh=None, rebalance: bool = False,
                 backend: str = "pallas", fused: bool = False):
        self.mesh = mesh
        self.device = torch.device(device if mesh is None
                                   else mesh.devices[0])
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available")
        if ladder not in K.LADDERS:
            raise ValueError(f"ladder must be one of {K.LADDERS}, got "
                             f"{ladder!r}")
        if upload not in UPLOADS:
            raise ValueError(f"upload must be one of {UPLOADS}, got "
                             f"{upload!r}")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        self.block_rows = block_rows
        self.fused = fused
        self.xla = backend == "xla"
        self.upload = "full64" if self.xla else upload
        self.ladder = ladder
        self.rebalance = bool(rebalance and mesh is not None
                              and not self.xla)
        # sharded batches split their lanes evenly
        self.pad_to = block_rows * (1 if mesh is None else mesh.size)

    def _query(self, spend, labels):
        """{device: (spend, labels, comb)} for each device the scan uses;
        on backend "xla", {device: pipeline.query_limbs(spend, labels)}."""
        devs = (self.mesh.distinct if self.mesh is not None
                else (self.device,))

        def t(a, d):
            return torch.from_numpy(
                np.ascontiguousarray(a).view(np.int32)).to(d)
        if self.xla:
            return {d: PL.query_limbs(t(spend, d), t(labels, d))
                    for d in devs}
        return {d: (t(spend, d), t(labels, d), K.comb_table(d))
                for d in devs}

    def _run_on(self, digits, static, spend, labels):
        devs = (self.mesh.devices if self.mesh is not None
                else (self.device,))
        entry = _Cuda if self.device.type == "cuda" else _Cpu
        run = (_XlaRun if self.xla else
               _Run if self.mesh is None else _MeshRun)
        return run(self, [entry(d) for d in devs], digits, static,
                   self._query(spend, labels))

    def run(self, batches, sched, spend, labels,
            metrics: Optional[ScanMetrics] = None) -> List[tuple]:
        """batches: iterable of ingest.PackedBatch (a generator packs lazily
        on the feeder thread). sched: ingest.ScanSchedule; spend (2, 8)
        and labels (L, 2, 8) uint32 numpy. Returns per-batch (flags bool
        (B,), source_rows int64 (B,))."""
        t_run = time.perf_counter()
        digits, static = ((sched.glv, None) if self.xla
                          else sched.operands(self.ladder))
        cuda = self.device.type == "cuda"
        if cuda and not self.xla:
            # the ladder's kernel is built (a per-key nvcc run for
            # "static") before the first batch is packed: a failed build
            # raises here, and nothing falls back to another ladder
            K.KERNELS[self.ladder].library(static)
        # the C packer is built (g++) before the feeder starts, too
        native.library()
        dev = self._run_on(digits, static, spend, labels)
        auto = (_Auto() if self.upload == "auto" and dev.timed
                and not self.rebalance else None)
        memo_key = []         # the feeder's batch-0 shape under "auto"
        tags = {}
        results = []          # [flags bool (n,), source rows]
        queued = []           # flagged rows of cut batches (exact pass)
        # (ticket, batch index, batch, mode, the submit's fault or None)
        inflight = deque()
        spare = []            # the retries' run, made at the first one
        used = ["full"]       # the last mode that was not "full"
        density = [0, 0]      # rows on a cut wire, of which flagged

        def mode_for(M):
            if self.rebalance:
                return "full"       # the exchange's wire, as the reference
            if auto is not None:
                want = auto.want
            else:
                want = "full" if self.upload == "auto" else self.upload
            if want not in CUTS:
                return want
            if (M, want) not in tags:
                tags[M, want] = cut_tag_for(M, want, warn=auto is None)
            return tags[M, want]

        def submit(run, b, pk, mode, M):
            ticket = run.submit(pk, mode, M,
                                b.source_rows if self.rebalance else None)
            if metrics is not None:
                metrics.upload_seconds += ticket[1]
                metrics.upload_bytes += ticket[2]
            return ticket

        def outcome(ticket, i, b, mode, fault):
            """(ticket, dev.result) of batch i; a failed submit or result
            runs once more, re-packed from b on the caller's thread, on
            the spare run, which only ever holds that one batch."""
            if fault is None:
                try:
                    return ticket, dev.result(ticket, metrics)
                except Exception as e:
                    fault = e
            if metrics is not None:
                metrics.batch_retries += 1
            try:
                if not spare:
                    spare.append(self._run_on(digits, static, spend, labels))
                M = b.outputs_hi.shape[1]
                ticket = submit(spare[0], b, spare[0].pack(b, mode), mode, M)
                return ticket, spare[0].result(ticket, metrics)
            except Exception:
                raise ExecutionError(i, fault) from fault

        def finish(entry):
            ticket, i, b, mode, fault = entry
            ticket, (flags, sources, h2d_s, kern_s) = outcome(
                ticket, i, b, mode, fault)
            if sources is None:
                sources = b.source_rows
            fl = K.flags_to_bool(flags, len(sources))
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
            results.append([fl, sources])
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
            width = _width(len(b.source_rows), self.pad_to)
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
                except ExecutionError:
                    raise
                except Exception as e:
                    raise ExecutionError(entry[1], e) from e

        q = queue.Queue(maxsize=QUEUE_DEPTH)
        stop = threading.Event()

        def put(item) -> bool:
            """A bounded put that gives up once the caller has stopped the
            feeder (a plain put could block for ever on a full queue)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=PUT_TIMEOUT_S)
                    return True
                except queue.Full:
                    continue
            return False

        def feeder():
            i = -1
            try:
                it = iter(batches)
                while not stop.is_set():
                    i += 1
                    t0 = time.perf_counter()
                    with annotate("cudasp.pack"):
                        b = next(it, None)
                        if b is None:
                            break
                        pulled = time.perf_counter() - t0
                        M = b.outputs_hi.shape[1]
                        if auto is not None and i == 0:
                            memo_key.append((self.ladder, _width(
                                len(b.source_rows), self.pad_to), M) + (
                                () if self.mesh is None else (self.mesh,)))
                            with BatchExecutor._memo_lock:
                                memo = BatchExecutor._auto_memo.get(
                                    memo_key[0])
                            if memo is not None:
                                auto.kernel0, auto.want = memo
                        mode = mode_for(M)
                        if mode != "full":
                            used[0] = mode
                        pk = dev.pack(b, mode, stop)
                    if pk is None:
                        return
                    if metrics is not None:
                        metrics.pack_seconds += pulled + pk.seconds
                    if not put((i, b, pk, mode, M)):
                        return
            except Exception as e:
                put(_Fault(i, e))
                return
            put(None)

        th = threading.Thread(target=feeder, name="cudasp-feeder",
                              daemon=True)
        th.start()
        scan_width = 0
        try:
            while True:
                try:
                    item = q.get(timeout=PUT_TIMEOUT_S)
                except queue.Empty:
                    if th.is_alive():
                        continue
                    raise RuntimeError("the feeder thread died without "
                                       "a result") from None
                if item is None:
                    break
                if isinstance(item, _Fault):
                    raise ExecutionError(item.index, item.error) \
                        from item.error
                i, b, pk, mode, M = item
                scan_width = max(scan_width, pk.width)
                if metrics is not None:
                    metrics.batches += 1
                    if self.rebalance:
                        metrics.exchange_bytes += 4 * pk.width * (
                            wire_rows(mode, M) + 2)
                try:
                    ticket, fault = submit(dev, b, pk, mode, M), None
                except Exception as e:
                    ticket, fault = None, e
                inflight.append((ticket, i, b, mode, fault))
                # a failed submit retries now, before a later batch
                # launches
                drain(1 if fault is None else 0)
            drain(0)
            if queued:
                with annotate("cudasp.exact_pass"):
                    self._reverify(dev, queued, results, scan_width,
                                   metrics)
        finally:
            stop.set()
            # the feeder leaves a full queue within one put timeout once
            # it is drained; the join must not hide a thread that stays
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            th.join(timeout=JOIN_TIMEOUT_S)
            if th.is_alive() and sys.exc_info()[0] is None:
                raise RuntimeError("the feeder thread did not stop")
        if auto is not None and memo_key:
            with BatchExecutor._memo_lock:
                memo = BatchExecutor._auto_memo
                memo[memo_key[0]] = (auto.kernel0, auto.want)
                memo.move_to_end(memo_key[0])
                while len(memo) > AUTO_MEMO_MAX:
                    memo.popitem(last=False)
        if metrics is not None:
            metrics.device_seconds += time.perf_counter() - t_run
            metrics.upload_mode = used[0]
            metrics.ladder = "" if self.xla else self.ladder
            metrics.n_devices = 1 if self.mesh is None else self.mesh.size
            metrics.warm_variants = K.loaded_libraries()
        return [tuple(r) for r in results]

    def _reverify(self, dev, queued, results, width, metrics):
        """The exact pass over the rows a cut flagged: repacked on the
        "full" wire, through the same ladder's kernel (on a mesh, the
        sharded kernel), at most `width` rows a launch (a multiple of
        block_rows x mesh entries), and their exact flags written back
        into their batches' results. The reference runs the pass through
        the scan's compiled width and ships a cut's tail batch full until
        its program is warm; the port compiles nothing in a scan, so every
        batch ships the wire it asked for and the pass takes its own
        width: a difference in mechanism, not in result."""
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
                ticket = dev.submit(dev.pack(b, "full"), "full",
                                    oh.shape[1])
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
