"""The fused scan: batch packing, the CUDA kernel's wrapper and build, and
the kernel's plain-torch version.

Counterpart of cudasp_tpu/ops/kernels.py: `scan_flags` plays the role of
`_scan_pallas_call` (ladder="fixed", wires "x" and "xy", block skip,
int8 or 32-per-uint32 packed flags). For CUDA tensors it launches the
hand-written kernel in csrc/scan.cu (built with nvcc for sm_90a at first
use, bound with ctypes); for CPU tensors it runs `scan_plain`, which
follows the stage split of cudasp_tpu/ops/pipeline.py. It never falls
back from one to the other.

Operands (B = lane width, a multiple of block_rows):
  tweak_words (8 or 16, B) int32  LE x words (then y words on wire "xy")
  outputs_hi/lo (M, B) int32      upper-64 match words
  outputs_mask (1, B) int32       bit j < M: output j valid; bit 30: y
                                  parity (wire "x"); bit 31: row valid
  digits (2, 34) int32            host array: glv_odd_sched of the scan key
  spend (2, 8) int32              x words, y words
  labels (L, 2, 8) int32
  comb (32, 256, 2, 8) int32      comb_table_np
  blockmask (B // block_rows,) int32 or None: 0 = tile has no live row
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from . import curve as C
from . import field as F
from . import sha256 as H
from .scalar import GLV_BETA, ODD_WINDOWS, comb_table_np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
_BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "build", "cudasp_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_TIMEOUT_S = 600
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"


# ---------------------------------------------------------------------------
# Host-side packing (byte-identical to cudasp_tpu/ops/kernels.py:896-1011)
# ---------------------------------------------------------------------------


def live_blockmask(n_live: int, n_blocks: int, block_rows: int):
    """Block-skip mask for a valid-prefix batch: block i is live iff it
    starts before the live-row count. None when every block is live."""
    mask = (np.arange(n_blocks, dtype=np.int32) * block_rows
            < n_live).astype(np.int32)
    return None if mask.all() else mask


def pack_batch_arrays(tweak_blobs, row_valid, outputs_hi, outputs_lo,
                      outputs_valid, block_rows: int = 256,
                      wire: str = "x"):
    """One packed batch -> the kernel's planes (numpy uint32):
    (tweak_words (8|16, Bp), oh (M, Bp), ol (M, Bp), ovm (1, Bp)), with
    Bp the row count padded up to a block_rows multiple."""
    if wire not in ("x", "xy"):
        raise ValueError(f"wire must be 'x' or 'xy', got {wire!r}")
    B = int(tweak_blobs.shape[0])
    M = int(outputs_hi.shape[1])
    if M > 30:
        raise ValueError("outputs plane width > 30 collides with the "
                         "parity/row_valid bits of the validity bitmask")
    Bp = max(block_rows, ((B + block_rows - 1) // block_rows) * block_rows)
    pad = Bp - B

    def padB(a):
        if pad == 0:
            return a
        widths = [(0, 0)] * a.ndim
        widths[-1] = (0, pad)
        return np.pad(a, widths)

    blobs = np.ascontiguousarray(tweak_blobs, np.uint8)
    nw = 64 if wire == "xy" else 32
    words = np.ascontiguousarray(
        np.ascontiguousarray(blobs[:, :nw]).view(np.uint32).T)
    ovm = np.zeros(B, np.uint32)
    ov = np.asarray(outputs_valid)
    for j in range(M):
        ovm |= ov[:, j].astype(np.uint32) << np.uint32(j)
    ovm |= (blobs[:, 32] & np.uint8(1)).astype(np.uint32) << np.uint32(30)
    ovm |= np.asarray(row_valid).astype(np.uint32) << np.uint32(31)
    oh = np.ascontiguousarray(np.asarray(outputs_hi).T).view(np.uint32)
    ol = np.ascontiguousarray(np.asarray(outputs_lo).T).view(np.uint32)
    return padB(words), padB(oh), padB(ol), padB(ovm[None, :])


def comb_table(device) -> torch.Tensor:
    """The comb table as a (32, 256, 2, 8) int32 tensor on `device`."""
    return torch.from_numpy(comb_table_np().view(np.int32)).to(device)


def flags_to_bool(flags: np.ndarray, n: int) -> np.ndarray:
    """Decode a flags array to (n,) bool: int32 means 32 flags per word,
    bit i of word w = row 32w + i; int8 is one flag per row."""
    if flags.dtype == np.int32:
        bits = (flags[0].view(np.uint32)[:, None]
                >> np.arange(32, dtype=np.uint32)) & 1
        return bits.astype(bool).reshape(-1)[:n]
    return flags[0, :n] != 0


def pack_flag_words(flags: torch.Tensor) -> torch.Tensor:
    """(1, B) 0/1 -> (1, B/32) int32 holding 32 flags per word."""
    bits = flags.reshape(-1, 32).to(torch.int64) << torch.arange(
        32, device=flags.device)
    words = bits.sum(-1)
    return (words - ((words >> 31) << 32)).to(torch.int32)[None]


# ---------------------------------------------------------------------------
# Plain-torch version, in the stages of cudasp_tpu/ops/pipeline.py
# ---------------------------------------------------------------------------


def _u32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & 0xFFFFFFFF


def stage_ecdh(tweak_words, ovm, digits, wire):
    """Tweak words -> scan key x tweak point (Jacobian, (B, 16) each)."""
    x = F.words_to_fe(tweak_words[:8].T)
    if wire == "xy":
        y = F.words_to_fe(tweak_words[8:16].T)
    else:
        want_odd = (_u32(ovm[0]) >> 30) & 1
        y0 = F.sqrt_candidate(F.add(F.mul(F.sqr(x), x), F.const(7, x)))
        y = F.select(F.parity(y0) == want_odd, y0, F.neg(y0))
    one = F.one_like(x)
    # affine odd multiples (2m+1) P by a Co-Z chain and one inversion
    d2x, d2y, d2z = C.dbl(x, y, one)
    t = F.sqr(d2z)
    ox, oy = F.mul(x, t), F.mul(y, F.mul(t, d2z))
    dx, dy, z = d2x, d2y, d2z
    chain = []
    for _ in range(7):
        nx, ny, dx, dy, z = C.zaddu(dx, dy, ox, oy, z)
        chain.append((nx, ny, z))
        ox, oy = nx, ny
    zinv = F.inv_many([c[2] for c in chain])
    tx, ty = [x], [y]
    for (cx, cy, _), zi in zip(chain, zinv):
        zi2 = F.sqr(zi)
        tx.append(F.mul(cx, zi2))
        ty.append(F.mul(cy, F.mul(zi, zi2)))
    beta = F.const(GLV_BETA, x)
    tabx = (tx, [F.mul(beta, v) for v in tx])
    taby = (ty, [F.neg(v) for v in ty])

    def pick(h, i):
        code = int(digits[h][i])
        return tabx[h][code & 7], taby[code >> 3][code & 7]

    px, py = pick(0, 0)
    px, py, pz = C.madd(px, py, one, *pick(1, 0))
    for i in range(1, ODD_WINDOWS):
        for _ in range(4):
            px, py, pz = C.dbl(px, py, pz)
        for h in range(2):
            px, py, pz = C.madd(px, py, pz, *pick(h, i))
    for h in range(2):
        if digits[h][ODD_WINDOWS]:
            cy = taby[int(digits[h][ODD_WINDOWS + 1])][0]
            px, py, pz = C.madd(px, py, pz, tabx[h][0], cy)
    return px, py, pz


def stage_serialize_hash(ex, ey, ez):
    """ecdh point -> (B, 8) int64 hash words (big-endian). A zero z
    inverts to zero, as on the card."""
    zi = F.inv(ez)
    zi2 = F.sqr(zi)
    xc = F.canonical(F.mul(ex, zi2))
    par = F.parity(F.mul(ey, F.mul(zi, zi2)))
    return H.tagged_hash(F.fe_to_words(xc).flip(-1), par)


def stage_output_final(hw, spend, comb):
    """hash words -> t x G + spend (Jacobian). The raw hash bytes index the
    comb, with no mod-n step."""
    combfe = F.words_to_fe(comb)                        # (32, 256, 2, 16)
    ox = oy = oz = torch.zeros(hw.shape[:-1] + (F.NL,), dtype=torch.int64,
                               device=hw.device)
    oinf = torch.ones(hw.shape[:-1], dtype=torch.bool, device=hw.device)
    one = F.one_like(ox)
    for i in range(32):
        byte = (hw[..., i // 4] >> (8 * (3 - i % 4))) & 0xFF
        q = combfe[i][byte]                             # (B, 2, 16)
        qx, qy = q[..., 0, :], q[..., 1, :]
        ax, ay, az = C.madd(ox, oy, oz, qx, qy)
        qinf = byte == 0
        ox = F.select(qinf, ox, F.select(oinf, qx, ax))
        oy = F.select(qinf, oy, F.select(oinf, qy, ay))
        oz = F.select(qinf, oz, F.select(oinf, one, az))
        oinf = oinf & qinf
    sf = F.words_to_fe(spend)
    return C.madd_complete_lite(ox, oy, oz, oinf, sf[0], sf[1])


def stage_match(fx, fy, fz, oh, ol, ovm, labels):
    """Candidates final, final + label_j -> (B,) bool flags (row valid,
    some valid output's upper 64 bits equal to a live candidate's)."""
    cands = [(fx, fz)]
    lf = F.words_to_fe(labels)
    for j in range(lf.shape[0]):
        cx, _, cz = C.madd(fx, fy, fz, lf[j, 0], lf[j, 1])
        cands.append((cx, cz))
    m = _u32(ovm[0])
    ov = torch.stack([((m >> j) & 1) != 0 for j in range(oh.shape[0])], -1)
    ohu, olu = _u32(oh).T, _u32(ol).T                   # (B, M)
    hit = torch.zeros_like(m, dtype=torch.bool)
    for (cx, cz), zi in zip(cands, F.inv_many([c[1] for c in cands])):
        w = F.fe_to_words(F.canonical(F.mul(cx, F.sqr(zi))))
        eq = (w[..., 7:8] == ohu) & (w[..., 6:7] == olu) & ov
        hit = hit | (eq.any(-1) & ~F.is_zero(cz))
    return hit & (((m >> 31) & 1) != 0)


def scan_plain(tweak_words, outputs_hi, outputs_lo, outputs_mask, digits,
               spend, labels, comb, blockmask=None, *, wire="x",
               block_rows=256):
    """The kernel's function in plain torch: (1, B) int8 flags."""
    d = np.asarray(torch.as_tensor(digits).cpu(), np.int32)
    ex, ey, ez = stage_ecdh(tweak_words, outputs_mask, d, wire)
    hw = stage_serialize_hash(ex, ey, ez)
    fx, fy, fz = stage_output_final(hw, spend, comb)
    hit = stage_match(fx, fy, fz, outputs_hi, outputs_lo, outputs_mask,
                      labels)
    if blockmask is not None:
        live = torch.as_tensor(blockmask, device=hit.device) != 0
        hit = hit & live.repeat_interleave(block_rows)[:hit.shape[0]]
    return hit.to(torch.int8)[None]


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_SOURCES = ("scan.cu", "secp256k1.cuh")


class ScanKernel:
    """csrc/scan.cu, built at first use with nvcc into
    build/cudasp_tpu_torch/<source hash>/ and reused while the hash
    matches. `launches` counts kernel launches; `build_seconds` is the
    nvcc time of this process's build (None when a build was reused)."""

    def __init__(self):
        self.launches = 0
        self.build_seconds = None
        self.build_log = ""
        self._lib = None

    def _digest(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for name in _SOURCES:
            with open(os.path.join(_CSRC, name), "rb") as f:
                h.update(f.read())
        return h.hexdigest()[:16]

    def library(self):
        if self._lib is not None:
            return self._lib
        out_dir = os.path.join(_BUILD_ROOT, self._digest())
        so = os.path.join(out_dir, "libcudasp_scan.so")
        if not os.path.exists(so):
            nvcc = shutil.which("nvcc") or NVCC_DEFAULT
            if not os.path.exists(nvcc):
                raise RuntimeError("nvcc not found: the scan kernel is "
                                   "built with the CUDA toolkit's nvcc")
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp,
                 os.path.join(_CSRC, "scan.cu")],
                capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
            self.build_seconds = time.perf_counter() - t0
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{self.build_log}")
            with open(os.path.join(out_dir, "nvcc.log"), "w") as f:
                f.write(self.build_log)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        fn = lib.cudasp_scan_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 2)
        self._lib = lib
        return lib

    def launch(self, tweak_words, outputs_hi, outputs_lo, outputs_mask,
               digits, spend, labels, comb, blockmask, *, wire, block_rows,
               pack_flags):
        B = tweak_words.shape[1]
        M = outputs_hi.shape[0]
        dev = tweak_words.device
        d = np.ascontiguousarray(np.asarray(
            torch.as_tensor(digits).cpu(), np.int32))
        if d.shape != (2, ODD_WINDOWS + 2):
            raise ValueError(f"digits must be (2, 34), got {d.shape}")
        tensors = {"tweak_words": tweak_words, "outputs_hi": outputs_hi,
                   "outputs_lo": outputs_lo, "outputs_mask": outputs_mask,
                   "spend": spend, "labels": labels, "comb": comb}
        if blockmask is not None:
            tensors["blockmask"] = blockmask
        for name, t in tensors.items():
            if t.device != dev or t.dtype != torch.int32 \
                    or not t.is_contiguous():
                raise ValueError(f"{name}: need a contiguous int32 tensor on "
                                 f"{dev}, got {t.dtype} on {t.device}")
        if blockmask is not None and blockmask.shape != (B // block_rows,):
            raise ValueError("blockmask must be (B // block_rows,)")
        if pack_flags and B % 32:
            raise ValueError("packed flags need B % 32 == 0")
        flags = (torch.empty((1, B // 32), dtype=torch.int32, device=dev)
                 if pack_flags else
                 torch.empty((1, B), dtype=torch.int8, device=dev))
        lib = self.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.cudasp_scan_launch(
                tweak_words.data_ptr(), outputs_hi.data_ptr(),
                outputs_lo.data_ptr(), outputs_mask.data_ptr(),
                d.ctypes.data, spend.data_ptr(),
                labels.data_ptr() if labels.numel() else None,
                labels.shape[0], comb.data_ptr(),
                blockmask.data_ptr() if blockmask is not None else None,
                block_rows, B, M, 1 if wire == "xy" else 0,
                1 if pack_flags else 0, flags.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"scan kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return flags


scan_kernel = ScanKernel()


def scan_flags(tweak_words, outputs_hi, outputs_lo, outputs_mask, digits,
               spend, labels, comb, blockmask=None, *, block_rows=256,
               wire="x", pack_flags=False):
    """Match flags of one batch: (1, B) int8, or (1, B/32) int32 with 32
    flags per word when pack_flags. CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    TW = 16 if wire == "xy" else 8
    B = tweak_words.shape[1]
    if tweak_words.shape[0] != TW or B % block_rows:
        raise ValueError(f"tweak_words must be ({TW}, B) with B a multiple "
                         f"of block_rows={block_rows}")
    M = outputs_hi.shape[0]
    if not 0 < M <= 30 or outputs_lo.shape != (M, B) \
            or outputs_mask.shape != (1, B):
        raise ValueError("outputs planes must be (M, B), M in 1..30, and "
                         "the mask (1, B)")
    if tweak_words.device.type == "cuda":
        return scan_kernel.launch(
            tweak_words, outputs_hi, outputs_lo, outputs_mask, digits,
            spend, labels, comb, blockmask, wire=wire,
            block_rows=block_rows, pack_flags=pack_flags)
    if tweak_words.device.type != "cpu":
        raise ValueError(f"unsupported device {tweak_words.device}")
    flags = scan_plain(tweak_words, outputs_hi, outputs_lo, outputs_mask,
                       digits, spend, labels, comb, blockmask, wire=wire,
                       block_rows=block_rows)
    return pack_flag_words(flags) if pack_flags else flags
