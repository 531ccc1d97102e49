"""Batch executor: packed batches through the scan kernel on one device
(counterpart of cudasp_tpu/runtime/executor.py `_run_pallas`, single GPU).

On a CUDA device each batch's planes are staged into a pinned host buffer
and go up in ONE H2D copy on a copy stream; the kernel runs on a compute
stream ordered after that copy by an event, and its packed flags come back
D2H on the compute stream. Two buffer sets alternate, so batch i+1 packs on
the host and uploads while batch i computes. Everything is one Python loop
of streams and events: no background threads, so a failure cannot leave
the caller waiting on a dead feeder. Any failure of batch i raises
ExecutionError(i).

On the CPU the same loop calls the kernel's plain version."""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..ops import kernels as K
from .errors import ExecutionError
from .metrics import ScanMetrics


def _planes(b, block_rows, wire):
    """PackedBatch -> (plane arrays as int32 views, blockmask or None)."""
    planes = K.pack_batch_arrays(b.tweak_blobs, b.row_valid, b.outputs_hi,
                                 b.outputs_lo, b.outputs_valid,
                                 block_rows=block_rows, wire=wire)
    width = planes[0].shape[1]
    bmask = K.live_blockmask(b.n_valid, width // block_rows, block_rows)
    return [p.view(np.int32) for p in planes], bmask


class BatchExecutor:
    """Runs packed batches on one device ("cuda", "cuda:N" or "cpu")
    through one ladder of the scan kernel ("fixed", "wnaf" or "static")."""

    def __init__(self, device, block_rows: int = 256, wire: str = "x",
                 ladder: str = "fixed"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available")
        if ladder not in K.LADDERS:
            raise ValueError(f"ladder must be one of {K.LADDERS}, got "
                             f"{ladder!r}")
        self.block_rows = block_rows
        self.wire = wire
        self.ladder = ladder

    def run(self, batches, sched, spend, labels,
            metrics: Optional[ScanMetrics] = None) -> List[tuple]:
        """batches: iterable of ingest.PackedBatch (a generator packs lazily).
        sched: ingest.ScanSchedule; spend (2, 8) and labels (L, 2, 8)
        uint32 numpy. Returns per-batch (flags bool (B,), source_rows
        int64 (B,))."""
        t0 = time.perf_counter()
        digits, static = sched.operands(self.ladder)
        if self.device.type == "cuda":
            # the ladder's kernel is built (a per-key nvcc run for
            # "static") before the first batch is packed: a failed build
            # raises here, and nothing falls back to another ladder
            K.KERNELS[self.ladder].library(static)
            out = self._run_cuda(batches, digits, static, spend, labels,
                                 metrics)
        else:
            out = self._run_cpu(batches, digits, static, spend, labels,
                                metrics)
        if metrics is not None:
            metrics.device_seconds += time.perf_counter() - t0
            metrics.upload_mode = "full64" if self.wire == "xy" else "full"
            metrics.ladder = self.ladder
        return out

    def _query(self, spend, labels):
        def t(a):
            return torch.from_numpy(
                np.ascontiguousarray(a).view(np.int32)).to(self.device)
        return t(spend), t(labels), K.comb_table(self.device)

    def _run_cpu(self, batches, d, static, spend, labels, metrics):
        sp, lab, comb = self._query(spend, labels)
        results = []
        for i, b in enumerate(batches):
            try:
                t0 = time.perf_counter()
                planes, bmask = _planes(b, self.block_rows, self.wire)
                if metrics is not None:
                    metrics.pack_seconds += time.perf_counter() - t0
                flags = K.scan_flags(
                    *(torch.from_numpy(p) for p in planes), d, sp, lab, comb,
                    None if bmask is None else torch.from_numpy(bmask),
                    block_rows=self.block_rows, wire=self.wire,
                    pack_flags=True, ladder=self.ladder,
                    static_sched=static)
                results.append((K.flags_to_bool(flags.numpy(),
                                                len(b.source_rows)),
                                b.source_rows))
            except Exception as e:
                raise ExecutionError(i, e) from e
            if metrics is not None:
                metrics.batches += 1
        return results

    def _run_cuda(self, batches, d, static, spend, labels, metrics):
        dev = self.device
        sp, lab, comb = self._query(spend, labels)
        copy_stream = torch.cuda.Stream(dev)
        compute_stream = torch.cuda.Stream(dev)
        slots = []               # two alternating buffer sets, made lazily
        pending = []             # (slot, batch index, n rows, source rows)
        results = []

        def finish(slot, i, n, sources):
            t0 = time.perf_counter()
            slot["done"].synchronize()
            if metrics is not None:
                metrics.device_wait_seconds += time.perf_counter() - t0
            results.append((K.flags_to_bool(slot["flags"].numpy(), n),
                            sources))

        for i, b in enumerate(batches):
            try:
                t0 = time.perf_counter()
                planes, bmask = _planes(b, self.block_rows, self.wire)
                t1 = time.perf_counter()
                width = planes[0].shape[1]
                nrow = sum(p.shape[0] for p in planes) + 1   # + blockmask
                if not slots or slots[0]["host"].shape != (nrow, width):
                    slots = [self._slot(nrow, width) for _ in range(2)]
                slot = slots[i % 2]
                # the H2D that last read this staging buffer must be done
                slot["h2d"].synchronize()
                host = slot["host"].numpy()
                at = 0
                views = []
                for p in planes:
                    host[at:at + p.shape[0]] = p
                    views.append((at, at + p.shape[0]))
                    at += p.shape[0]
                if bmask is not None:
                    host[at, :len(bmask)] = bmask
                t2 = time.perf_counter()
                with torch.cuda.stream(copy_stream):
                    copy_stream.wait_event(slot["done"])
                    slot["dev"].copy_(slot["host"], non_blocking=True)
                    slot["h2d"].record(copy_stream)
                with torch.cuda.stream(compute_stream):
                    compute_stream.wait_event(slot["h2d"])
                    dv = slot["dev"]
                    flags = K.scan_flags(
                        *(dv[a:z] for a, z in views), d, sp, lab, comb,
                        None if bmask is None else dv[at, :len(bmask)],
                        block_rows=self.block_rows, wire=self.wire,
                        pack_flags=True, ladder=self.ladder,
                        static_sched=static)
                    slot["flags"].copy_(flags, non_blocking=True)
                    slot["done"].record(compute_stream)
                if metrics is not None:
                    metrics.pack_seconds += t1 - t0
                    metrics.upload_seconds += t2 - t1
                    metrics.upload_bytes += 4 * nrow * width
                    metrics.batches += 1
                if pending:
                    finish(*pending.pop())
                pending.append((slot, i, len(b.source_rows), b.source_rows))
            except Exception as e:
                raise ExecutionError(i, e) from e
        if pending:
            slot, i, n, sources = pending.pop()
            try:
                finish(slot, i, n, sources)
            except Exception as e:
                raise ExecutionError(i, e) from e
        return results

    def _slot(self, nrow, width):
        dev = self.device
        return {
            "host": torch.empty((nrow, width), dtype=torch.int32,
                                pin_memory=True),
            "dev": torch.empty((nrow, width), dtype=torch.int32, device=dev),
            "flags": torch.empty((1, width // 32), dtype=torch.int32,
                                 pin_memory=True),
            "h2d": torch.cuda.Event(),
            "done": torch.cuda.Event(),
        }
