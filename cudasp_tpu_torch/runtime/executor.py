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

On a CUDA device each batch's wire planes are staged into a pinned host
buffer and go up in ONE H2D copy on a copy stream; the kernel runs on a
compute stream ordered after that copy by an event, and its flags come
back D2H on the compute stream. A cut's dummy planes never cross the
wire: they are made on the device. Two buffer sets alternate, so batch
i+1 packs on the host and uploads while batch i computes. Every H2D and
every kernel is timed with CUDA events on its own stream; "auto" reads
the link rate and the batch-0 kernel time from them. Everything is one
Python loop of streams and events: no background threads, so a failure
cannot leave the caller waiting on a dead feeder.

A batch whose launch or result fails runs once more, re-staged from its
PackedBatch on a spare set of buffers and streams (the pinned slot it
used may already hold a later batch), and counts in
metrics.batch_retries; a second failure raises ExecutionError(i). A
sticky CUDA error (an illegal address) leaves the context unusable, so
its retry fails too and raises. A failure to pack batch i, or of the
exact pass over its rows, raises ExecutionError(i) at once. The steps of
a batch are named spans (runtime.trace.annotate): cudasp.pack,
cudasp.stage_h2d, cudasp.launch, cudasp.wait and cudasp.exact_pass.

With a mesh (parallel.mesh; the counterpart of the reference's
shard_map), each batch is split into the mesh's contiguous lane shards:
every entry stages and uploads its shard on its own copy stream, one
ops.kernels.scan_flags_sharded call launches the kernel once per entry on
that entry's compute stream, and each entry's flags come back on it. The
batch pads to block_rows x entries; flags pack per shard where the shard
width allows. "auto" models from the slowest entry's kernel and the
batch's bytes over the longest H2D. With rebalance=True, every batch goes
through the row exchange (parallel.exchange) first, on the "full" wire,
with its source rows as two more planes that come back with the flags.

On the CPU the same loop calls the kernel's plain version.

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
import time
import warnings
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

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


def _planes(b: PackedBatch, block_rows: int, mode: str,
            pad_to: Optional[int] = None):
    """PackedBatch -> (plane arrays as int32 views, blockmask or None), the
    lanes padded to a multiple of pad_to (block_rows x mesh entries;
    default block_rows)."""
    planes = K.pack_batch_arrays(
        b.tweak_blobs, b.row_valid, b.outputs_hi, b.outputs_lo,
        b.outputs_valid, block_rows=pad_to or block_rows,
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


class _Cuda:
    """Staging, H2D, kernel and D2H on one card (or one mesh entry of it),
    two buffer sets alternating (module docstring). Each entry has its own
    copy and compute streams, pinned buffers and dummies."""

    timed = True

    def __init__(self, device):
        self.device = device
        self.copy_stream = torch.cuda.Stream(device)
        self.compute_stream = torch.cuda.Stream(device)
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
                                   device=self.device),
                "out": [],
                **{ev: torch.cuda.Event(**timed)
                   for ev in ("h2d0", "h2d", "k0", "x1", "k1", "done")},
            }
        return slot

    def dummy(self, shape):
        """A cut's dummy plane, made on the card (never uploaded)."""
        if shape not in self.dummies:
            self.dummies[shape] = torch.zeros(shape, dtype=torch.int32,
                                              device=self.device)
        return self.dummies[shape]

    def on(self):
        return torch.cuda.stream(self.compute_stream)

    def stage(self, wire, bmask):
        width = wire[0].shape[1]
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
        self.compute_stream.wait_event(slot["h2d"])
        slot["k0"].record(self.compute_stream)
        slot["exchanged"] = False
        return (slot, [dv[a:z] for a, z in views],
                None if bmask is None else dv[at, :len(bmask)], staged,
                4 * nrow * width)

    def mark(self, slot):
        """The exchange ends here; the kernel starts."""
        slot["x1"].record(self.compute_stream)
        slot["exchanged"] = True

    def collect(self, slot, outs):
        """The batch's outputs come back D2H on the compute stream into
        pinned buffers of the slot."""
        with torch.cuda.stream(self.compute_stream):
            slot["k1"].record(self.compute_stream)
            if [(o.shape, o.dtype) for o in slot["out"]] != [
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


def _with_dummies(entry, ops, planes, mode):
    """A cut's wire planes plus its dummies, made on the entry's device,
    in the kernel's operand order."""
    if mode in CUTS:
        ops.insert(2, entry.dummy(planes[2].shape))
    if mode in K.HI_UNITS:
        ops.append(entry.dummy(planes[3].shape))
    return ops


class _Run:
    """Where a scan's batches run: one device, or each mesh entry over its
    lane shard. submit(planes, bmask, mode, M, sources) -> ticket (handle,
    staging seconds, bytes up); result(ticket, metrics) -> (flags, source
    rows or None for the batch's own, H2D seconds, kernel seconds), the
    times None off the card; on a mesh the slowest entry's."""

    def __init__(self, ex, entries, digits, static, query):
        self.ex, self.entries, self.static = ex, entries, static
        self.digits, self.query = digits, query
        self.timed = entries[0].timed

    def _kw(self, mode, M, pack):
        return dict(block_rows=self.ex.block_rows,
                    wire="xy" if mode == "full64" else "x",
                    pack_flags=pack, ladder=self.ex.ladder,
                    static_sched=self.static,
                    hi_only=mode if mode in CUTS else None, nout=M)

    def submit(self, planes, bmask, mode, M, sources=None):
        """One launch (or plain-version call) on one upload mode. Flags
        come packed 32 a word where the lane width allows, else int8."""
        e = self.entries[0]
        with annotate("cudasp.stage_h2d"):
            slot, ops, bm, staged, nbytes = e.stage(
                wire_planes(planes, mode), bmask)
        ops = _with_dummies(e, ops, planes, mode)
        sp, lab, comb = self.query[e.device]
        with e.on(), annotate("cudasp.launch"):
            flags = K.scan_flags(*ops, self.digits, sp, lab, comb, bm,
                                 **self._kw(mode, M,
                                            planes[0].shape[1] % 32 == 0))
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

    def submit(self, planes, bmask, mode, M, sources=None):
        from ..parallel import exchange as X
        from ..parallel.mesh import lane_ranges

        mesh = self.ex.mesh
        n = mesh.size
        B = planes[0].shape[1]
        nbl = B // self.ex.block_rows // n
        wire = wire_planes(planes, mode)
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
                ops.append(_with_dummies(e, o, planes, mode))
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

    def submit(self, planes, bmask, mode, M, sources=None):
        from ..parallel.mesh import lane_ranges

        fn = PL.scan_batch_fused if self.ex.fused else PL.scan_batch
        ticket, staged, nbytes = [], 0.0, 0
        for e, (a, z) in zip(self.entries, lane_ranges(
                len(self.entries), planes[0].shape[1])):
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
    # them
    _auto_memo: "OrderedDict" = OrderedDict()

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
        """batches: iterable of ingest.PackedBatch (a generator packs lazily).
        sched: ingest.ScanSchedule; spend (2, 8) and labels (L, 2, 8)
        uint32 numpy. Returns per-batch (flags bool (B,), source_rows
        int64 (B,))."""
        t_run = time.perf_counter()
        digits, static = ((sched.glv, None) if self.xla
                          else sched.operands(self.ladder))
        cuda = self.device.type == "cuda"
        if cuda and not self.xla:
            # the ladder's kernel is built (a per-key nvcc run for
            # "static") before the first batch is packed: a failed build
            # raises here, and nothing falls back to another ladder
            K.KERNELS[self.ladder].library(static)
        dev = self._run_on(digits, static, spend, labels)
        auto = (_Auto() if self.upload == "auto" and dev.timed
                and not self.rebalance else None)
        memo_key = None
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

        def submit(run, b, planes, bmask, mode, M):
            ticket = run.submit(planes, bmask, mode, M,
                                b.source_rows if self.rebalance else None)
            if metrics is not None:
                metrics.upload_seconds += ticket[1]
                metrics.upload_bytes += ticket[2]
            return ticket

        def outcome(ticket, i, b, mode, fault):
            """(ticket, dev.result) of batch i; a failed submit or result
            runs once more, re-packed from b, on the spare run, which only
            ever holds that one batch."""
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
                planes, bmask = _planes(b, self.block_rows, mode,
                                        self.pad_to)
                ticket = submit(spare[0], b, planes, bmask, mode, M)
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

        scan_width = 0
        for i, b in enumerate(batches):
            try:
                M = b.outputs_hi.shape[1]
                width = _width(len(b.source_rows), self.pad_to)
                scan_width = max(scan_width, width)
                if auto is not None and i == 0:
                    memo_key = (self.ladder, width, M) + (
                        () if self.mesh is None else (self.mesh,))
                    memo = BatchExecutor._auto_memo.get(memo_key)
                    if memo is not None:
                        auto.kernel0, auto.want = memo
                mode = mode_for(M)
                if mode != "full":
                    used[0] = mode
                t0 = time.perf_counter()
                with annotate("cudasp.pack"):
                    planes, bmask = _planes(b, self.block_rows, mode,
                                            self.pad_to)
                if metrics is not None:
                    metrics.pack_seconds += time.perf_counter() - t0
                    metrics.batches += 1
                    if self.rebalance:
                        metrics.exchange_bytes += 4 * width * (
                            sum(p.shape[0] for p in planes) + 2)
            except Exception as e:
                raise ExecutionError(i, e) from e
            try:
                ticket, fault = submit(dev, b, planes, bmask, mode, M), None
            except Exception as e:
                ticket, fault = None, e
            inflight.append((ticket, i, b, mode, fault))
            # a failed submit retries now, before a later batch launches
            drain(1 if fault is None else 0)
        drain(0)
        if queued:
            with annotate("cudasp.exact_pass"):
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
                planes, bmask = _planes(b, self.block_rows, "full",
                                        self.pad_to)
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
