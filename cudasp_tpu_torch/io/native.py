"""The port's host packer: csrc/pack.cpp, built with g++ at first use and
bound with ctypes (counterpart of cudasp_tpu/io/native.py and its
csrc/ingest.cpp, in the port's own formats).

  pack_wire      one batch's rows -> the planes of one upload mode and the
                 block mask, in one pass, into a caller's buffer (the
                 executor's pinned staging slot on the card's path)
  pack_points    (n, 64) point blobs -> x and y as (8, n) uint32 words
  count_chunks   chunks a row takes at max_outputs values a chunk
  pack_outputs   ragged (CSR) outputs -> padded hi / lo / valid planes of
                 a virtual-row expansion

The library goes to build/cudasp_tpu_torch/host/<sha256 of the source and
the g++ flags>/libcudasp_pack.so: written under a temporary name and
renamed into place, so several processes may build it at once. A failed
build raises RuntimeError with g++'s log; nothing falls back to numpy
(ops/kernels.py pack_batch_arrays, the numpy packer, is the plain version
the tests hold this one to). ctypes releases the GIL for the length of a
call, so a feeder thread packs while the caller's Python runs."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "pack.cpp")
_BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "cudasp_tpu_torch", "host")
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall",
             "-Werror"]
GXX_TIMEOUT_S = 300
# upload modes in the order of csrc/pack.cpp's Mode
MODES = ("full", "full64", "hi32", "hi16", "hi8")
# hi16 / hi8: units a word and the output-count cap (ops/kernels.py
# HI_UNITS)
_UNITS = {"hi16": (2, 14), "hi8": (4, 6)}
# threads a pack_wire call splits its lanes over
PACK_THREADS = max(1, min(4, os.cpu_count() or 1))


class _State:
    """The loaded library, and the g++ builds this process ran (runs;
    seconds and log of the last)."""

    def __init__(self):
        self.lib = None
        self.runs = 0
        self.build_seconds = None
        self.build_log = ""
        self.lock = threading.Lock()


STATE = _State()


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_ROOT, h.hexdigest()[:16], "libcudasp_pack.so")


def gxx_build(src, so, flags, include=None):
    """Compile `src` with g++ and `flags` (-I include) into the shared
    library `so`: written under a temporary name, then renamed, so several
    processes may build it at once. Returns (seconds, log); raises
    RuntimeError with g++'s log when it fails, leaving no library."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {src} is built with g++")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [gxx, *flags, *(["-I", include] if include else []), "-o", tmp,
         src], capture_output=True, text=True, timeout=GXX_TIMEOUT_S)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                           f"{src}:\n{log}")
    os.replace(tmp, so)
    return time.perf_counter() - t0, log


def library() -> ctypes.CDLL:
    """The packer, built if missing and loaded once a process."""
    with STATE.lock:
        if STATE.lib is not None:
            return STATE.lib
        so = library_path()
        if not os.path.exists(so):
            STATE.build_seconds, STATE.build_log = gxx_build(_SRC, so,
                                                             GXX_FLAGS)
            STATE.runs += 1
        lib = ctypes.CDLL(so)
        vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.cudasp_pack_wire.argtypes = [vp] * 5 + [i64, i64, ci, ci, i64,
                                                    ci, i64, vp, ci]
        lib.cudasp_pack_wire.restype = ci
        lib.cudasp_pack_points.argtypes = [vp, i64, vp, vp]
        lib.cudasp_pack_points.restype = None
        lib.cudasp_pack_outputs.argtypes = [vp] * 4 + [i64, i64, vp, vp, vp]
        lib.cudasp_pack_outputs.restype = None
        lib.cudasp_count_chunks.argtypes = [vp, i64, i64, vp]
        lib.cudasp_count_chunks.restype = i64
        STATE.lib = lib
        return lib


def plane_rows(mode: str, M: int) -> int:
    """uint32 rows of a mode's planes at M outputs (the block-mask row
    comes on top): tweak words, then oh, ol and ovm on the exact wires,
    oh and ovm on hi32, the packed units on hi16 / hi8."""
    tw = 16 if mode == "full64" else 8
    if mode in ("full", "full64"):
        return tw + 2 * M + 1
    if mode == "hi32":
        return tw + M + 1
    per = _UNITS[mode][0]
    return tw + (M + per) // per


def _c(a, dtype):
    return np.ascontiguousarray(a, dtype)


def pack_wire(tweak_blobs, row_valid, outputs_hi, outputs_lo, outputs_valid,
              mode: str, width: int, block_rows: int, n_live: int,
              out=None, rows=None, threads: int = PACK_THREADS):
    """Rows [a, b) (`rows`, default all) of one packed batch -> the planes
    of `mode` and the block mask, as (plane_rows(mode, M) + 1, width)
    uint32 in `out` (a C-contiguous uint32 or int32 array of at least that
    many words, which it returns reshaped; a new array when None). Lane l
    holds row a + l, lanes past b - a are zero; the last row's word i is 1
    when block i starts before n_live. Bit-equal to pack_batch_arrays
    with hi_only=mode for the cuts and wire "xy" for full64."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    blobs = _c(tweak_blobs, np.uint8)
    n = blobs.shape[0]
    a, b = (0, n) if rows is None else rows
    M = int(np.shape(outputs_hi)[1])
    cap = _UNITS[mode][1] if mode in _UNITS else 30
    if not 0 < M <= cap:
        raise ValueError(f"{mode} packing supports 1..{cap} outputs, got {M}")
    if not 0 <= a <= b <= n or width < b - a or width % block_rows:
        raise ValueError(f"rows [{a}, {b}) of {n} do not fit {width} lanes "
                         f"of {block_rows}-row blocks")
    if blobs.shape[1] != 64:
        raise ValueError("expected (n, 64) tweak blobs")
    words = (plane_rows(mode, M) + 1) * width
    if out is None:
        out = np.empty(words, np.uint32)
    if out.dtype not in (np.uint32, np.int32) or not out.flags.c_contiguous \
            or out.size < words:
        raise ValueError(f"out must be a C-contiguous 32-bit array of at "
                         f"least {words} words")
    rv = _c(row_valid, np.bool_).view(np.uint8)
    hi = _c(outputs_hi, np.int32)
    lo = _c(outputs_lo, np.int32)
    ov = _c(outputs_valid, np.bool_).view(np.uint8)
    if hi.shape != (n, M) or lo.shape != (n, M) or ov.shape != (n, M) \
            or rv.shape != (n,):
        raise ValueError("row_valid (n,) and outputs (n, M) must match the "
                         "tweak blobs' n rows")
    rc = library().cudasp_pack_wire(
        blobs.ctypes.data, rv.ctypes.data, hi.ctypes.data, lo.ctypes.data,
        ov.ctypes.data, a, b, M, MODES.index(mode), width, block_rows,
        n_live, out.ctypes.data, max(1, int(threads)))
    if rc != 0:
        raise ValueError(f"cudasp_pack_wire refused its arguments ({rc})")
    flat = out.reshape(-1)[:words]
    return flat.reshape(words // width, width)


def pack_points(tweak_blobs):
    """(n, 64) uint8 point blobs -> (x, y), each (8, n) uint32 words."""
    blobs = _c(tweak_blobs, np.uint8)
    if blobs.ndim != 2 or blobs.shape[1] != 64:
        raise ValueError("expected (n, 64) byte array")
    n = blobs.shape[0]
    x = np.empty((8, n), np.uint32)
    y = np.empty((8, n), np.uint32)
    library().cudasp_pack_points(blobs.ctypes.data, n, x.ctypes.data,
                                 y.ctypes.data)
    return x, y


def count_chunks(offsets, max_outputs: int):
    """(chunks a row (n,) int64, their total) at max_outputs values a
    chunk, from CSR offsets (n + 1,)."""
    offs = _c(offsets, np.int64)
    n = offs.shape[0] - 1
    nch = np.empty(max(n, 0), np.int64)
    total = library().cudasp_count_chunks(offs.ctypes.data, n,
                                          int(max_outputs), nch.ctypes.data)
    return nch, int(total)


def pack_outputs(flat, offsets, src, chunk, max_outputs: int):
    """Virtual rows (source row src[v], chunk chunk[v]) of CSR outputs ->
    (hi (nv, M) int32, lo (nv, M) int32, valid (nv, M) bool)."""
    flat = _c(flat, np.int64)
    offs = _c(offsets, np.int64)
    src = _c(src, np.int64)
    chunk = _c(chunk, np.int64)
    nv, M = src.shape[0], int(max_outputs)
    if M < 1 or chunk.shape != src.shape or (len(offs) and (
            offs[0] < 0 or offs[-1] > flat.size
            or (np.diff(offs) < 0).any())) or (nv and (
            src.min() < 0 or src.max() >= len(offs) - 1
            or chunk.min() < 0)):
        raise ValueError("pack_outputs: offsets must be non-decreasing "
                         "within the values, src rows of them and chunks "
                         "non-negative")
    hi = np.empty((nv, M), np.int32)
    lo = np.empty((nv, M), np.int32)
    valid = np.empty((nv, M), np.uint8)
    library().cudasp_pack_outputs(
        flat.ctypes.data, offs.ctypes.data, src.ctypes.data,
        chunk.ctypes.data, nv, M, hi.ctypes.data, lo.ctypes.data,
        valid.ctypes.data)
    return hi, lo, valid.view(np.bool_)
