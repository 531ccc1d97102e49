"""Per-device defaults of the scan's launch shape (counterpart of
cudasp_tpu/runtime/tuning.py).

Two knobs: block_rows (rows per block-skip tile of the kernel's
blockmask) and tile (rows per launch: the batch width the executor caps a
scan's batches at). The TPU's scoped-VMEM budget has no counterpart on the
card. Resolution order per knob, as in the reference:

  1. an explicit ScanConfig value            (the caller wins; api.py)
  2. CUDASP_BLOCK_ROWS / CUDASP_TILE         (operator override)
  3. an autotuned row, build/cudasp_tpu_torch/tuning_<kind>.json,
     written by `python -m cudasp_tpu_torch.tools.autotune`
  4. the built-in table below, keyed by substrings of
     torch.cuda.get_device_name(device) ("cpu" for the CPU), else the
     fallback row
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass

import torch

from ..ops.kernels import _BUILD_ROOT

TUNING_DIR = _BUILD_ROOT          # build/cudasp_tpu_torch, beside the builds


@dataclass(frozen=True)
class DeviceDefaults:
    block_rows: int = 256
    tile: int = 262_144
    measured: bool = False          # True: from a sweep on this kind


# The launch shape kept by a sweep on an NVIDIA H100 80GB HBM3 (PERF.md
# section 6): 262,144 rows a launch, the blockmask at 256 rows
H100 = DeviceDefaults(256, 262_144, measured=True)
# the plain version on the CPU: 1,024 rows a call keeps the tests' tensors
# small
CPU = DeviceDefaults(256, 1024)
# substring of the device name -> row; first hit wins
_TABLE = (("h100", H100), ("cpu", CPU))
_FALLBACK = DeviceDefaults()


def device_kind(device=None) -> str:
    """The table's key for `device` (default "cuda"): "cpu", or the card's
    name ("unknown", the fallback row's, where torch cannot read it, as in
    the reference). Raises on a CUDA device when there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu'")
    try:
        return torch.cuda.get_device_name(dev)
    except (AssertionError, RuntimeError):  # a torch built without CUDA
        return "unknown"


def tuned_path(kind: str) -> str:
    return os.path.join(TUNING_DIR, "tuning_" + re.sub(
        r"[^a-z0-9]+", "_", kind.lower()).strip("_") + ".json")


def _autotuned(kind: str):
    path = tuned_path(kind)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    return DeviceDefaults(int(d["block_rows"]), int(d["tile"]),
                          measured=True)


def save_autotuned(kind: str, block_rows: int, tile: int) -> str:
    """Write the autotuned row of `kind`; returns the file's path."""
    os.makedirs(TUNING_DIR, exist_ok=True)
    path = tuned_path(kind)
    with open(path, "w") as f:
        json.dump({"device_kind": kind, "block_rows": int(block_rows),
                   "tile": int(tile)}, f)
    return path


def lookup(kind: str) -> DeviceDefaults:
    """The row of a device kind: autotuned, else the table's, else the
    fallback (no environment variables)."""
    tuned = _autotuned(kind)
    if tuned is not None:
        return tuned
    lk = kind.lower()
    for sub, row in _TABLE:
        if sub in lk:
            return row
    return _FALLBACK


def defaults(device=None) -> DeviceDefaults:
    """The resolved row of `device`: lookup(device_kind(device)) with
    CUDASP_BLOCK_ROWS and CUDASP_TILE over it."""
    row = lookup(device_kind(device))
    br = os.environ.get("CUDASP_BLOCK_ROWS")
    tile = os.environ.get("CUDASP_TILE")
    return DeviceDefaults(int(br) if br else row.block_rows,
                          int(tile) if tile else row.tile, row.measured)


def block_rows_default(device=None) -> int:
    return defaults(device).block_rows


def tile_default(device=None) -> int:
    return defaults(device).tile
