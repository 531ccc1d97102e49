"""Tracing and the metrics line (counterpart of
cudasp_tpu/runtime/trace.py).

Set ``CUDASP_PROFILE_DIR=/some/dir`` to write one torch.profiler Chrome
trace per scan into that directory (CPU activities, and the card's
kernels and copies where there is a card), or capture one by hand:

    with trace_scan("/tmp/trace"):
        scan(...)

Set ``CUDASP_METRICS=1`` to print one JSON line of ScanMetrics on stderr
after every scan().
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import sys
import time

import torch

log = logging.getLogger("cudasp_tpu_torch")


@contextlib.contextmanager
def trace_scan(trace_dir=None):
    """Profile the enclosed scan with torch.profiler and write its Chrome
    trace to trace_dir (default CUDASP_PROFILE_DIR) as
    scan-<pid>-<ns>.json, also when the scan raises. A no-op when neither
    is set."""
    trace_dir = trace_dir or os.environ.get("CUDASP_PROFILE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir,
                        f"scan-{os.getpid()}-{time.time_ns()}.json")
    t0 = time.perf_counter()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        log.info("scan trace (%.3fs) written to %s",
                 time.perf_counter() - t0, path)


@functools.lru_cache(maxsize=1)
def _nvtx() -> bool:
    return torch.cuda.is_available()


@contextlib.contextmanager
def annotate(name: str):
    """A named span: a record_function event in a captured trace, and an
    NVTX range where there is a card."""
    with torch.profiler.record_function(name):
        if not _nvtx():
            yield
            return
        with torch.cuda.nvtx.range(name):
            yield


def emit_metrics(metrics, stream=None) -> None:
    """One {"event": "scan_metrics", ...} JSON line on `stream` (default
    stderr)."""
    if metrics is None:
        return
    print(json.dumps({"event": "scan_metrics", **metrics.as_dict()}),
          file=stream or sys.stderr)
