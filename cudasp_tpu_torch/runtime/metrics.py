"""Structured scan metrics (counterpart of cudasp_tpu/runtime/metrics.py).

The fields of the reference's line, plus the port's own: the launch
width, H2D by CUDA events, the exchange, the "auto" model's inputs.
Two of the reference's fields differ in meaning here:

- total_seconds is the wall time of the scan, from argument checks to the
  result. The reference adds its pack_seconds to a timer that already
  runs while its feeder thread packs, so its total counts packing twice;
  the port's feeder thread sums pack_seconds on its own, and the total
  counts that time once, in the wall clock.
- prewarm_failures is always 0: the port builds a kernel library before
  the first batch of a scan that needs it, on the calling thread, and has
  no prewarm thread whose failures the reference counts."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict


@dataclass
class ScanMetrics:
    rows_in: int = 0
    rows_scanned: int = 0          # virtual rows incl. overflow splits
    batches: int = 0
    matches: int = 0
    batch_size: int = 0            # the configured batch size
    launch_rows: int = 0           # rows a launch: the effective batch
    n_devices: int = 1
    # the last mode a batch shipped that was not "full" (a cut or
    # "full64"), else "full"; as the reference reports it
    upload_mode: str = ""
    reverified_rows: int = 0       # rows a cut flagged: the exact pass's
    ladder: str = ""               # "fixed", "wnaf" or "static"
    # Stage attribution. pack runs on the executor's feeder thread and
    # overlaps the device, so the stages do not sum to total_seconds; the
    # larger of pack + upload and device_wait names the bottleneck.
    pack_seconds: float = 0.0          # feeder: ingest + the C packer
    upload_bytes: int = 0              # H2D bytes (planes + blockmask)
    upload_seconds: float = 0.0        # caller: staging and H2D issue
    h2d_seconds: float = 0.0           # the H2D copies, by CUDA events
    device_wait_seconds: float = 0.0   # host blocked on batch results
    device_seconds: float = 0.0        # the executor's whole run
    # ScanConfig(rebalance=True): the row exchange, by CUDA events (on
    # each card, from the last entry's planes ready to the last entry
    # exchanged), and the plane bytes it moved
    exchange_seconds: float = 0.0
    exchange_bytes: int = 0
    total_seconds: float = 0.0
    # upload="auto" on a card: the batch-0 kernel seconds (CUDA events, or
    # the process's memo of that shape) and the best H2D rate of the last
    # four batches (bytes / event-timed seconds) the model last read
    kernel0_seconds: float = 0.0
    link_bytes_per_second: float = 0.0
    # always 0 (module docstring); the kernel libraries loaded in the
    # process at the scan's end
    prewarm_failures: int = 0
    warm_variants: int = 0
    # batches that failed once and were run again (a second failure
    # raises ExecutionError)
    batch_retries: int = 0

    @property
    def bottleneck(self) -> str:
        host = self.pack_seconds + self.upload_seconds
        if not (host or self.device_wait_seconds):
            return "unknown"
        return ("host(pack+upload)" if host > self.device_wait_seconds
                else "device")

    @property
    def rows_per_second(self) -> float:
        return self.rows_in / self.total_seconds if self.total_seconds else 0.0

    def as_dict(self) -> Dict:
        d = dict(self.__dict__)
        d["rows_per_second"] = self.rows_per_second
        d["bottleneck"] = self.bottleneck
        return d


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        return dt
