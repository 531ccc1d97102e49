"""The fused scan: batch packing, the CUDA kernel's wrapper and build, and
the kernel's plain-torch version.

Counterpart of cudasp_tpu/ops/kernels.py: `scan_flags` plays the role of
`_scan_pallas_call` (ladders "fixed", "wnaf" and "static", wires "x" and
"xy", the hi32 / hi16 / hi8 prefilter cuts of the match planes, block
skip, int8 or 32-per-uint32 packed flags). For CUDA tensors
it launches the hand-written kernel (csrc/scan.cuh; built with nvcc for
sm_90a at first use, bound with ctypes): csrc/scan.cu for the ladders that
read the key's schedule as data, a generated translation unit per scan
key for "static". For CPU tensors it runs `scan_plain`, which follows the
stage split of cudasp_tpu/ops/pipeline.py. It never falls back from one
to the other.

Operands (B = lane width, a multiple of block_rows):
  tweak_words (8 or 16, B) int32  LE x words (then y words on wire "xy")
  outputs_hi/lo (M, B) int32      upper-64 match words
  outputs_mask (1, B) int32       bit j < M: output j valid; bit 30: y
                                  parity (wire "x"); bit 31: row valid
                                  (a cut wire packs these three planes
                                  differently: pack_batch_arrays)
  digits                          host array: glv_odd_sched (2, 34) int32
                                  for "fixed", glv_wnaf_steps (2, 54) int32
                                  for "wnaf"; unused by "static"
  static_sched                    glv_wnaf_static of the key ("static")
  spend (2, 8) int32              x words, y words
  labels (L, 2, 8) int32
  comb (32, 256, 2, 8) int32      comb_table_np
  blockmask (B // block_rows,) int32 or None: 0 = tile has no live row
"""

from __future__ import annotations

import ctypes
import hashlib
import operator
import os
import re
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from . import curve as C
from . import field as F
from . import sha256 as H
from .scalar import GLV_BETA, ODD_WINDOWS, WNAF_STEPS, comb_table_np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
_BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "build", "cudasp_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_TIMEOUT_S = 600
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"
LADDERS = ("fixed", "wnaf", "static")
# the stages csrc/secp256k1.cuh's SP_ABLATE swaps for stand-ins, bit i for
# stage i (the JAX package's CUDASP_ABLATE names)
ABLATE_STAGES = ("sqrt", "table", "ladder", "serialize", "hash", "comb",
                 "match")
DIGITS_SHAPES = {"fixed": (2, ODD_WINDOWS + 2), "wnaf": (2, WNAF_STEPS)}


# ---------------------------------------------------------------------------
# Host-side packing (byte-identical to cudasp_tpu/ops/kernels.py:896-1011)
# ---------------------------------------------------------------------------


def live_blockmask(n_live: int, n_blocks: int, block_rows: int):
    """Block-skip mask for a valid-prefix batch: block i is live iff it
    starts before the live-row count. None when every block is live."""
    mask = (np.arange(n_blocks, dtype=np.int32) * block_rows
            < n_live).astype(np.int32)
    return None if mask.all() else mask


# the wires of the match planes (None: exact) and the kernel's `hi`
# argument for each
HI_CODES = {None: 0, "hi32": 1, "hi16": 2, "hi8": 3}
HI_ONLY = tuple(HI_CODES)
# per packed cut: match bits compared, units per uint32 word, output-count
# cap (the hi16 / hi8 validity unit takes bits 14/15 or 6/7)
HI_UNITS = {"hi16": (16, 2, 14), "hi8": (8, 4, 6)}


def hi_plane_rows(hi_only, M: int) -> int:
    """Rows of the oh plane on a wire: M, or the packed units of M top-16
    or top-8 match values plus the validity unit."""
    if hi_only in HI_UNITS:
        per = HI_UNITS[hi_only][1]
        return (M + per) // per
    return M


def pack_batch_arrays(tweak_blobs, row_valid, outputs_hi, outputs_lo,
                      outputs_valid, block_rows: int = 256,
                      wire: str = "x", hi_only=None):
    """One packed batch -> the kernel's planes (numpy uint32):
    (tweak_words (8|16, Bp), oh, ol, ovm), with Bp the row count padded up
    to a block_rows multiple. Exact wires: oh/ol (M, Bp), ovm (1, Bp).
    hi_only (the JAX package's hi_only=True is "hi32") cuts the match
    planes to a prefilter whose flags are a superset of the exact flags:
      "hi32": ol is a (M, 1) dummy;
      "hi16": oh is the top 16 bits of each value, two units a word (unit
              u at row u // 2, shift 16 (u % 2)), then a validity unit
              (bits 0..M-1 valid, 14 parity, 15 row valid); ol and ovm
              are (1, 1) dummies; M <= 14;
      "hi8":  the same with top-8 units, four a word, parity at bit 6 and
              row valid at bit 7; M <= 6.
    The dummies never cross the wire."""
    if wire not in ("x", "xy"):
        raise ValueError(f"wire must be 'x' or 'xy', got {wire!r}")
    if hi_only not in HI_ONLY:
        raise ValueError(f"hi_only must be one of {HI_ONLY}, got "
                         f"{hi_only!r}")
    if wire == "xy" and hi_only:
        raise ValueError("wire='xy' (full64) is an exact wire; it does not "
                         "combine with a hi_only cut")
    B = int(tweak_blobs.shape[0])
    M = int(outputs_hi.shape[1])
    if M > 30:
        raise ValueError("outputs plane width > 30 collides with the "
                         "parity/row_valid bits of the validity bitmask")
    if hi_only in HI_UNITS and M > HI_UNITS[hi_only][2]:
        raise ValueError(f"{hi_only} packing supports at most "
                         f"{HI_UNITS[hi_only][2]} outputs, got {M}")
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
    if hi_only in HI_UNITS:
        bits, per, cap = HI_UNITS[hi_only]
        units = list(oh >> np.uint32(32 - bits))
        units.append((ovm & np.uint32((1 << M) - 1))
                     | (((ovm >> np.uint32(30)) & np.uint32(1))
                        << np.uint32(cap))
                     | ((ovm >> np.uint32(31)) << np.uint32(cap + 1)))
        packed = np.zeros((hi_plane_rows(hi_only, M), B), np.uint32)
        for j, u in enumerate(units):
            packed[j // per] |= u << np.uint32(bits * (j % per))
        dummy = np.zeros((1, 1), np.uint32)
        return padB(words), padB(packed), dummy, dummy.copy()
    ol = (np.zeros((M, 1), np.uint32) if hi_only else
          padB(np.ascontiguousarray(np.asarray(outputs_lo).T)
               .view(np.uint32)))
    return padB(words), padB(oh), ol, padB(ovm[None, :])


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


def odd_chain(x, y):
    """The odd multiples 3P..15P of the affine point (x, y) by a Co-Z
    chain from 2P, as csrc/secp256k1.cuh's build_table forms them:
    ([(x, y, z)] Jacobian, their z inverted by one batched inversion)."""
    d2x, d2y, d2z = C.dbl(x, y, F.one_like(x))
    t = F.sqr(d2z)
    ox, oy = F.mul(x, t), F.mul(y, F.mul(t, d2z))
    dx, dy, z = d2x, d2y, d2z
    chain = []
    for _ in range(7):
        nx, ny, dx, dy, z = C.zaddu(dx, dy, ox, oy, z)
        chain.append((nx, ny, z))
        ox, oy = nx, ny
    return chain, F.inv_many([c[2] for c in chain])


def stage_ecdh(tweak_words, ovm, digits, wire, ladder="fixed",
               static_sched=None):
    """Tweak words -> scan key x tweak point (Jacobian, (B, 16) each), by
    the ladder's schedule: `digits` for "fixed" and "wnaf", static_sched
    for "static"."""
    x = F.words_to_fe(tweak_words[:8].T)
    if wire == "xy":
        y = F.words_to_fe(tweak_words[8:16].T)
    else:
        want_odd = (_u32(ovm[0]) >> 30) & 1
        y0 = F.sqrt_candidate(F.add(F.mul(F.sqr(x), x), F.const(7, x)))
        y = F.select(F.parity(y0) == want_odd, y0, F.neg(y0))
    one = F.one_like(x)
    # affine odd multiples (2m+1) P
    chain, zinv = odd_chain(x, y)
    tx, ty = [x], [y]
    for (cx, cy, _), zi in zip(chain, zinv):
        zi2 = F.sqr(zi)
        tx.append(F.mul(cx, zi2))
        ty.append(F.mul(cy, F.mul(zi, zi2)))
    beta = F.const(GLV_BETA, x)
    tabx = (tx, [F.mul(beta, v) for v in tx])
    taby = (ty, [F.neg(v) for v in ty])

    def pick(h, code):
        code = int(code)
        return tabx[h][code & 7], taby[(code >> 3) & 1][code & 7]

    if ladder != "fixed":
        # wNAF steps (nd, code): nd doublings, then a live add (bit 5) of
        # the entry named by the code, GLV half in bit 4. Step 0 is the
        # init add; the static schedule is the same steps, trimmed.
        steps = (static_sched if ladder == "static"
                 else list(zip(digits[0], digits[1])))
        code0 = int(steps[0][1])
        px, py = pick((code0 >> 4) & 1, code0)
        pz = one
        for nd, code in steps[1:]:
            for _ in range(int(nd)):
                px, py, pz = C.dbl(px, py, pz)
            if int(code) >> 5:
                px, py, pz = C.madd(px, py, pz,
                                    *pick((int(code) >> 4) & 1, code))
        return px, py, pz
    px, py = pick(0, digits[0][0])
    px, py, pz = C.madd(px, py, one, *pick(1, digits[1][0]))
    for i in range(1, ODD_WINDOWS):
        for _ in range(4):
            px, py, pz = C.dbl(px, py, pz)
        for h in range(2):
            px, py, pz = C.madd(px, py, pz, *pick(h, digits[h][i]))
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
    return H.tagged_hash(F.limbs_to_words_be(xc), par)


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


def _hi_unit(oh, j, hi_only):
    """(B,) unit j of a packed hi16 / hi8 plane (int64)."""
    bits, per, _ = HI_UNITS[hi_only]
    return (_u32(oh[j // per]) >> (bits * (j % per))) & ((1 << bits) - 1)


def row_validity(oh, ovm, nout, hi_only=None):
    """The (1, B) validity words (bits 0..M-1 output valid, 30 y parity,
    31 row valid): the ovm plane's, or on hi16 / hi8, whose ovm is a
    dummy, rebuilt from the unit packed after the nout match units."""
    if hi_only not in HI_UNITS:
        return ovm
    cap = HI_UNITS[hi_only][2]
    u = _hi_unit(oh, nout, hi_only)
    return ((u & ((1 << nout) - 1)) | (((u >> cap) & 1) << 30)
            | ((u >> (cap + 1)) << 31))[None]


def stage_match(fx, fy, fz, oh, ol, ovm, labels, hi_only=None, nout=None):
    """Candidates final, final + label_j -> (B,) bool flags (row valid,
    some valid output's upper 64 bits equal to a live candidate's). On a
    cut wire only the top 32 / 16 / 8 bits of the upper word are compared
    (ol is not read): a superset of the exact flags. ovm is the validity
    word (row_validity); nout the real output count (hi16 / hi8)."""
    cands = [(fx, fz)]
    lf = F.words_to_fe(labels)
    for j in range(lf.shape[0]):
        cx, _, cz = C.madd(fx, fy, fz, lf[j, 0], lf[j, 1])
        cands.append((cx, cz))
    M = oh.shape[0] if nout is None else nout
    m = _u32(ovm[0])
    ov = torch.stack([((m >> j) & 1) != 0 for j in range(M)], -1)
    if hi_only in HI_UNITS:
        ohu = torch.stack([_hi_unit(oh, j, hi_only) for j in range(M)], -1)
    else:
        ohu = _u32(oh).T                                # (B, M)
    hit = torch.zeros_like(m, dtype=torch.bool)
    for (cx, cz), zi in zip(cands, F.inv_many([c[1] for c in cands])):
        w = F.fe_to_words(F.canonical(F.mul(cx, F.sqr(zi))))
        top = w[..., 7:8]
        if hi_only in HI_UNITS:
            top = top >> (32 - HI_UNITS[hi_only][0])
        eq = (top == ohu) & ov
        if hi_only is None:
            eq = eq & (w[..., 6:7] == _u32(ol).T)
        hit = hit | (eq.any(-1) & ~F.is_zero(cz))
    return hit & (((m >> 31) & 1) != 0)


def scan_plain(tweak_words, outputs_hi, outputs_lo, outputs_mask, digits,
               spend, labels, comb, blockmask=None, *, wire="x",
               block_rows=256, ladder="fixed", static_sched=None,
               hi_only=None, nout=None):
    """The kernel's function in plain torch: (1, B) int8 flags."""
    d = (None if digits is None
         else np.asarray(torch.as_tensor(digits).cpu(), np.int32))
    ovm = row_validity(outputs_hi, outputs_mask, nout, hi_only)
    ex, ey, ez = stage_ecdh(tweak_words, ovm, d, wire, ladder, static_sched)
    hw = stage_serialize_hash(ex, ey, ez)
    fx, fy, fz = stage_output_final(hw, spend, comb)
    hit = stage_match(fx, fy, fz, outputs_hi, outputs_lo, ovm, labels,
                      hi_only, nout)
    if blockmask is not None:
        live = torch.as_tensor(blockmask, device=hit.device) != 0
        hit = hit & live.repeat_interleave(block_rows)[:hit.shape[0]]
    return hit.to(torch.int8)[None]


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_SOURCES = ("scan.cu", "scan.cuh", "secp256k1.cuh")
_HEADERS = ("scan.cuh", "secp256k1.cuh")
_LADDER_IDS = {"fixed": 0, "wnaf": 1}
STATIC_GENERATOR_VERSION = 2

_STATIC_TU = """\
// Generated by cudasp_tpu_torch/ops/kernels.py (static ladder generator
// v{version}, schedule digest {digest}): the scan kernel with one scan
// key's wNAF schedule compiled in. The schedule re-encodes the scan key,
// so this file and the library built from it are secret.
#include "scan.cuh"

struct KeyLadder {{
    SP_HD SP_INLINE sp::jac operator()(const sp::OddTable& t) const {{
        return sp::ladder_static(t, sp::Steps<
{steps}>());
    }}
}};

#ifdef __CUDACC__
extern "C" int cudasp_scan_static_launch(
    const uint32_t* tw, const uint32_t* oh, const uint32_t* ol,
    const uint32_t* ovm, const uint32_t* spend, const uint32_t* labels,
    int nlabels, const uint32_t* comb, const int32_t* blockmask,
    int block_rows, int B, int M, int wire_xy, int hi, int packed,
    void* flags, void* stream) {{
    return sp::launch_scan(KeyLadder(), tw, oh, ol, ovm, spend, labels,
                           nlabels, comb, blockmask, block_rows, B, M,
                           wire_xy, hi, packed, flags, stream);
}}
#endif
"""


def check_static_sched(static_sched) -> tuple:
    """A glv_wnaf_static schedule as a tuple of (nd, code) int pairs, or
    ValueError. It becomes C++ template arguments, so it is held to what
    the generator can emit: at most WNAF_STEPS steps, step 0 a live add
    with no doubling, nd in 0..255, code in 0..63."""
    try:
        steps = tuple((operator.index(nd), operator.index(code))
                      for nd, code in static_sched)
    except (TypeError, ValueError) as e:
        raise ValueError("static_sched must be (nd, code) integer pairs "
                         "(scalar.glv_wnaf_static)") from e
    if not 0 < len(steps) <= WNAF_STEPS or steps[0][0] != 0 \
            or not steps[0][1] >> 5 \
            or any(not (0 <= nd < 256 and 0 <= code < 64)
                   for nd, code in steps):
        raise ValueError("static_sched is not a glv_wnaf_static schedule")
    return steps


def ablate_flags(mask: int) -> list:
    """The nvcc (or g++) flags of an SP_ABLATE build; none for 0."""
    return [f"-DSP_ABLATE={int(mask)}"] if mask else []


def _hash_sources(h, names):
    for name in names:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    return h


def static_digest(static_sched) -> str:
    """Names a per-key library: sha256 over the headers, the nvcc flags,
    the generator version and the schedule. It is the only form in which
    the schedule appears in logs and paths."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(f"generator {STATIC_GENERATOR_VERSION}".encode())
    h.update(repr(check_static_sched(static_sched)).encode())
    return _hash_sources(h, _HEADERS).hexdigest()[:16]


def static_source(static_sched) -> str:
    """The translation unit of one key's static kernel (scan.cuh's kernel
    with the key's steps as template arguments). Secret, like the key."""
    steps = check_static_sched(static_sched)
    cells = [f"sp::Step<{nd}, {code}>" for nd, code in steps]
    lines = [", ".join(cells[i:i + 4]) for i in range(0, len(cells), 4)]
    return _STATIC_TU.format(version=STATIC_GENERATOR_VERSION,
                             digest=static_digest(steps),
                             steps=",\n".join("            " + ln
                                               for ln in lines))


def _private_dir(path):
    os.makedirs(path, mode=0o700, exist_ok=True)
    os.chmod(path, 0o700)


def _redact(log: str) -> str:
    """A static build's log without the lines that quote its steps."""
    return "\n".join(ln for ln in log.splitlines()
                     if "Step<" not in ln and "StepIL" not in ln)


def _build_tag() -> str:
    return f"{os.getpid()}.{threading.get_ident()}"


def find_nvcc() -> str:
    """The CUDA toolkit's nvcc (on PATH, else NVCC_DEFAULT), or
    RuntimeError: a kernel is never replaced by its plain version."""
    nvcc = shutil.which("nvcc") or NVCC_DEFAULT
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the kernels are built with the "
                           "CUDA toolkit's nvcc")
    return nvcc


def nvcc_build(nvcc, src, so, *, generated=False, flags=()):
    """Compile `src` with NVCC_FLAGS and `flags` (-I csrc) into the shared
    library `so`: written under a temporary name, then renamed, with
    nvcc's log in nvcc.log beside it. A generated source (a per-key unit)
    is deleted once nvcc has read it and its log is redacted. Returns
    (seconds, log); raises RuntimeError with the log when nvcc fails,
    leaving no library."""
    tmp = f"{so}.{_build_tag()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, *flags, "-I", _CSRC, "-o", tmp, src],
            capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
    finally:
        if generated:
            os.remove(src)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if generated:
        log = _redact(log)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    with open(os.path.join(os.path.dirname(so), "nvcc.log"), "w") as f:
        f.write(log)
    os.replace(tmp, so)
    return seconds, log


def library_digest(sources, flags=()) -> str:
    """The build directory's name of a library: sha256 of the nvcc flags,
    the extra `flags` and csrc/`sources`."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + list(flags)).encode())
    return _hash_sources(h, sources).hexdigest()[:16]


def source_library(src, sources, so_name, flags=()):
    """The library nvcc builds from csrc/`src` (with the extra nvcc
    `flags`) into build/cudasp_tpu_torch/<library_digest>/`so_name`,
    built there if it is missing, loaded with ctypes. Returns (library,
    (seconds, log) of the nvcc build, or None when the library was found
    built)."""
    out_dir = os.path.join(_BUILD_ROOT, library_digest(sources, flags))
    so = os.path.join(out_dir, so_name)
    build = None
    if not os.path.exists(so):
        nvcc = find_nvcc()
        os.makedirs(out_dir, exist_ok=True)
        build = nvcc_build(nvcc, os.path.join(_CSRC, src), so, flags=flags)
    return ctypes.CDLL(so), build


# What ptxas and cuobjdump report of the built libraries, by function:
# (mangled-name key, and a part the name must also hold, short name)
_INSTANTIATION = (("scan_kernel", "FixedLadder", "fixed"),
                  ("scan_kernel", "WnafLadder", "wnaf"),
                  ("scan_kernel", "KeyLadder", "static"),
                  ("bench_kernel", "FieldMul", "bench field mul"),
                  ("bench_kernel", "FieldSqr", "bench field sqr"),
                  ("6fe_inv", "", "fe_inv"), ("7fe_sqrt", "", "fe_sqrt"),
                  ("11pt_dbl_call", "", "pt_dbl_call"),
                  ("12pt_madd_call", "", "pt_madd_call"))
SASS_KINDS = ("IMAD", "IMAD.WIDE", "IMAD.HI", "IMAD.X", "IMAD.MOV", "IADD3",
              "LDL", "STL", "CALL", "all")


def label(mangled):
    """A short name for a kernel or device function of the scan or probe
    libraries, or None."""
    for key, sub, name in _INSTANTIATION:
        if key in mangled and sub in mangled:
            return name
    return None


def ptxas_info(log):
    """{short name: {"registers", "stack", "spill_stores", "spill_loads"}}
    from an nvcc -Xptxas -v log, for the functions label() names."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)",
                      ln)
        if m:
            cur = label(m.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out.setdefault(cur, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
            cur = None
    return out


def cuobjdump(nvcc):
    """The toolkit's cuobjdump beside nvcc; raises if it is missing."""
    path = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc),
                                                     "cuobjdump")
    if not os.path.exists(path):
        raise RuntimeError(f"cuobjdump not found beside {nvcc}")
    return path


def sass_counts(so, nvcc):
    """{short name: {kind: count} for the SASS_KINDS} from cuobjdump -sass
    of the library `so`, for the functions label() names (a device
    function that stays a call is its own function there)."""
    text = subprocess.run([cuobjdump(nvcc), "-sass", so], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = label(m.group(1))
            if cur is not None:
                out[cur] = dict.fromkeys(SASS_KINDS, 0)
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     ln)
        if cur is None or m is None:
            continue
        op = m.group(1)
        c = out[cur]
        c["all"] += 1
        base = op.split(".")[0]
        if base in ("IMAD", "IADD3", "LDL", "STL", "CALL"):
            c[base] += 1
        if base == "IMAD":
            for variant in ("WIDE", "HI", "MOV"):
                if f".{variant}" in op:
                    c[f"IMAD.{variant}"] += 1
            if op.endswith(".X") or ".X." in op:
                c["IMAD.X"] += 1
    return out


class ScanKernel:
    """One ladder of the scan kernel, built at first use with nvcc and
    bound with ctypes. "fixed" and "wnaf" are two instantiations in one
    library, csrc/scan.cu, built into build/cudasp_tpu_torch/<source
    hash>/. "static" builds one library per scan key from a generated
    translation unit into build/cudasp_tpu_torch/static/<digest>/, mode
    0o700 because the library encodes the scan key; the generated source
    is written 0o600 and deleted once nvcc has read it. A library on disk
    is reused while its hash matches; a loaded one is kept for the life
    of the object, so a second scan with the same key builds nothing.

    ablate: the SP_ABLATE stage mask (ABLATE_STAGES) of a build variant
    for tools/ablate_probe.py (fixed ladder only), whose flags are
    garbage; 0, the default, is the scan kernel. A library loads only
    into the object of its own mask (scan.cuh's cudasp_scan_ablate), so
    the kernels of KERNELS never run an ablated build.

    launches: kernel launches of this ladder; hi_launches: those of them
    on a cut wire (hi32 / hi16 / hi8). nvcc_runs, build_seconds,
    build_log: this object's nvcc builds (the last one's seconds and
    ptxas log; None and "" while every library was found built)."""

    def __init__(self, ladder: str, ablate: int = 0):
        if ladder not in LADDERS:
            raise ValueError(f"ladder must be one of {LADDERS}")
        if ablate and (ladder != "fixed" or not 0 < ablate < 1 << len(
                ABLATE_STAGES)):
            raise ValueError(f"ablate must be a mask of {ABLATE_STAGES} "
                             f"bits on the fixed ladder (an ablated build "
                             f"holds that ladder only)")
        self.ablate = ablate
        self.ladder = ladder
        self.launches = 0
        self.hi_launches = 0
        self.nvcc_runs = 0
        self.build_seconds = None
        self.build_log = ""
        self._libs = {}
        self._lock = threading.Lock()

    def library(self, static_sched=None):
        steps = None
        if self.ladder == "static":
            if static_sched is None:
                raise ValueError("ladder='static' needs static_sched")
            steps = check_static_sched(static_sched)
        with self._lock:
            lib = self._libs.get(steps)
        if lib is not None:
            return lib
        if steps is None:
            lib, build = source_library(
                "scan.cu", _SOURCES, "libcudasp_scan.so",
                ablate_flags(self.ablate))
            lib.cudasp_scan_ablate.restype = ctypes.c_int
            built = lib.cudasp_scan_ablate()
            if built != self.ablate:
                raise RuntimeError(f"{lib._name} was built with "
                                   f"SP_ABLATE={built}; this kernel "
                                   f"loads SP_ABLATE={self.ablate} only")
        else:
            lib, build = self._static_library(steps)
        if build is not None:
            with self._lock:
                self.nvcc_runs += 1
                self.build_seconds, self.build_log = build
        vp, ci = ctypes.c_void_p, ctypes.c_int
        tail = [vp, vp, ci, vp, vp] + [ci] * 6 + [vp, vp]
        if steps is None:
            fn = lib.cudasp_scan_launch
            fn.argtypes = [vp] * 4 + [ci, vp] + tail
        else:
            fn = lib.cudasp_scan_static_launch
            fn.argtypes = [vp] * 4 + tail
        fn.restype = ci
        with self._lock:
            return self._libs.setdefault(steps, lib)

    @staticmethod
    def _static_library(steps):
        """One key's library, built from a generated unit if missing, as
        source_library returns it."""
        out_dir = os.path.join(_BUILD_ROOT, "static", static_digest(steps))
        so = os.path.join(out_dir, "libcudasp_scan_static.so")
        build = None
        if not os.path.exists(so):
            nvcc = find_nvcc()
            _private_dir(os.path.dirname(out_dir))
            _private_dir(out_dir)
            src = os.path.join(out_dir, f"key.{_build_tag()}.cu")
            fd = os.open(src, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
            with os.fdopen(fd, "w") as f:
                f.write(static_source(steps))
            build = nvcc_build(nvcc, src, so, generated=True)
        return ctypes.CDLL(so), build

    def launch(self, tweak_words, outputs_hi, outputs_lo, outputs_mask,
               digits, static_sched, spend, labels, comb, blockmask, *,
               wire, block_rows, pack_flags, hi_only, nout):
        """digits: the checked host schedule (None for "static"); nout:
        the real output count. Shapes are checked by scan_flags."""
        B = tweak_words.shape[1]
        dev = tweak_words.device
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
        lib = self.library(static_sched)
        # a cut wire's dummy planes go to the kernel as null pointers
        rows = (tweak_words.data_ptr(), outputs_hi.data_ptr(),
                None if hi_only else outputs_lo.data_ptr(),
                None if hi_only in HI_UNITS else outputs_mask.data_ptr())
        with torch.cuda.device(dev):
            tail = (spend.data_ptr(),
                    labels.data_ptr() if labels.numel() else None,
                    labels.shape[0], comb.data_ptr(),
                    blockmask.data_ptr() if blockmask is not None else None,
                    block_rows, B, nout, 1 if wire == "xy" else 0,
                    HI_CODES[hi_only], 1 if pack_flags else 0,
                    flags.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
            if self.ladder == "static":
                rc = lib.cudasp_scan_static_launch(*rows, *tail)
            else:
                rc = lib.cudasp_scan_launch(*rows, _LADDER_IDS[self.ladder],
                                            digits.ctypes.data, *tail)
        if rc != 0:
            raise RuntimeError(f"scan kernel ({self.ladder}) launch failed: "
                               f"CUDA error {rc}")
        self.launches += 1
        if hi_only:
            self.hi_launches += 1
        return flags


KERNELS = {ladder: ScanKernel(ladder) for ladder in LADDERS}
# the ablated build variants (tools/ablate_probe.py) by mask; never a
# scan's kernel
ABLATED = {}
_ablated_lock = threading.Lock()


def ablated_kernel(mask: int) -> ScanKernel:
    """The fixed ladder's scan kernel built with -DSP_ABLATE=mask (a mask
    of ABLATE_STAGES bits): one object a mask, built at its first
    library() call."""
    with _ablated_lock:
        if mask not in ABLATED:
            ABLATED[mask] = ScanKernel("fixed", ablate=mask)
        return ABLATED[mask]


def loaded_libraries() -> int:
    """The scan-kernel libraries loaded in the process: csrc/scan.cu
    (the fixed and wnaf ladders) once, and one per static key."""
    return len({lib._name for kern in KERNELS.values()
                for lib in list(kern._libs.values())})


def scan_flags(tweak_words, outputs_hi, outputs_lo, outputs_mask, digits,
               spend, labels, comb, blockmask=None, *, block_rows=256,
               wire="x", pack_flags=False, ladder="fixed",
               static_sched=None, hi_only=None, nout=None, ablate=0):
    """Match flags of one batch: (1, B) int8, or (1, B/32) int32 with 32
    flags per word when pack_flags. ladder: "fixed" or "wnaf" (digits is
    the key's schedule for that ladder) or "static" (static_sched is).
    hi_only: None (exact) or a cut wire as pack_batch_arrays packs it,
    whose flags are a superset of the exact flags; nout is the real output
    count, needed by hi16 / hi8. CUDA tensors launch the kernel; CPU
    tensors take the plain version. ablate (fixed ladder, CUDA tensors
    only): launch the SP_ABLATE build variant of that mask instead
    (ablated_kernel), whose flags are garbage: a timing instrument."""
    if ablate and (ladder != "fixed"
                   or tweak_words.device.type != "cuda"):
        raise ValueError("an ablated build runs on the fixed ladder on a "
                         "card; it has no plain version")
    if ladder not in LADDERS:
        raise ValueError(f"ladder must be one of {LADDERS}, got {ladder!r}")
    if ladder == "static":
        if static_sched is None:
            raise ValueError("ladder='static' needs static_sched "
                             "(scalar.glv_wnaf_static of the scan key)")
        static_sched = check_static_sched(static_sched)
        d = None
    else:
        d = np.ascontiguousarray(np.asarray(torch.as_tensor(digits).cpu(),
                                            np.int32))
        if d.shape != DIGITS_SHAPES[ladder]:
            raise ValueError(f"digits for ladder {ladder!r} must be "
                             f"{DIGITS_SHAPES[ladder]}, got {d.shape}")
    if hi_only not in HI_ONLY:
        raise ValueError(f"hi_only must be one of {HI_ONLY}, got "
                         f"{hi_only!r}")
    if wire == "xy" and hi_only:
        raise ValueError("wire='xy' does not combine with a hi_only cut")
    TW = 16 if wire == "xy" else 8
    B = tweak_words.shape[1]
    if tweak_words.shape[0] != TW or B % block_rows:
        raise ValueError(f"tweak_words must be ({TW}, B) with B a multiple "
                         f"of block_rows={block_rows}")
    if nout is None:
        if hi_only in HI_UNITS:
            raise ValueError(f"hi_only={hi_only!r} needs nout, the real "
                             f"output count")
        nout = outputs_hi.shape[0]
    M = int(nout)
    cap = HI_UNITS[hi_only][2] if hi_only in HI_UNITS else 30
    hi = (hi_plane_rows(hi_only, M), B)
    lo = {None: (M, B), "hi32": (M, 1)}.get(hi_only, (1, 1))
    mask = (1, 1) if hi_only in HI_UNITS else (1, B)
    if not 0 < M <= cap or outputs_hi.shape != hi \
            or outputs_lo.shape != lo or outputs_mask.shape != mask:
        raise ValueError(
            f"wire {hi_only or 'exact'} with M in 1..{cap} outputs: oh must "
            f"be {hi}, ol {lo} and the mask {mask}; got M={M}, "
            f"{tuple(outputs_hi.shape)}, {tuple(outputs_lo.shape)}, "
            f"{tuple(outputs_mask.shape)}")
    if tweak_words.device.type == "cuda":
        kern = ablated_kernel(ablate) if ablate else KERNELS[ladder]
        return kern.launch(
            tweak_words, outputs_hi, outputs_lo, outputs_mask, d,
            static_sched, spend, labels, comb, blockmask, wire=wire,
            block_rows=block_rows, pack_flags=pack_flags, hi_only=hi_only,
            nout=M)
    if tweak_words.device.type != "cpu":
        raise ValueError(f"unsupported device {tweak_words.device}")
    flags = scan_plain(tweak_words, outputs_hi, outputs_lo, outputs_mask,
                       d, spend, labels, comb, blockmask, wire=wire,
                       block_rows=block_rows, ladder=ladder,
                       static_sched=static_sched, hi_only=hi_only, nout=M)
    return pack_flag_words(flags) if pack_flags else flags


# ---------------------------------------------------------------------------
# The sharded scan: one launch per mesh entry
# ---------------------------------------------------------------------------


class ShardedLaunches:
    """launches: the kernel launches that scan_flags_sharded made, one per
    mesh entry of each call on CUDA tensors (each also counts in its
    ladder's ScanKernel)."""

    def __init__(self):
        self.launches = 0


SHARDED = ShardedLaunches()


def scan_flags_sharded(mesh, tweak_words, outputs_hi, outputs_lo,
                       outputs_mask, digits, spend, labels, comb,
                       blockmask=None, *, block_rows=256, wire="x",
                       pack_flags=False, ladder="fixed", static_sched=None,
                       hi_only=None, nout=None, streams=None):
    """scan_flags over a mesh (counterpart of scan_pallas_sharded,
    cudasp_tpu/ops/kernels.py:866-893, whose shard_map body is the same
    kernel): the batch's B lanes split into mesh.size contiguous shards,
    and each entry runs the scan kernel over its own shard, on its own
    device and stream (parallel.mesh.Fanout); CPU entries run the plain
    version, except on a shard whose block mask is all 0, whose flags are
    0. B must be a multiple of mesh.size x block_rows.

    The lane operands (tweak_words, outputs_hi, outputs_lo, outputs_mask)
    come whole, (K, B), and are split here, or as lists of per-entry
    shards already on their devices. A cut's width-1 dummies are
    replicated, not split: outputs_lo on every cut, outputs_mask on hi16 /
    hi8. spend, labels and comb are replicated, one copy per distinct
    device (or given as {device: tensor}). blockmask, (B // block_rows,),
    splits in (entry, local block) order, or comes as per-entry lists.
    pack_flags packs each shard's flags, so it needs (B / mesh.size) % 32
    == 0.

    Returns the flags in lane order: one tensor, (1, B) int8 or (1, B/32)
    int32, on tweak_words' device when the lane operands came whole; the
    per-entry flags when they came sharded."""
    from ..parallel.mesh import BatchShardings, Fanout, is_sharded

    ndev = mesh.size
    sh = BatchShardings(mesh)
    whole = not is_sharded(tweak_words)
    B = (tweak_words.shape[1] if whole
         else sum(t.shape[1] for t in tweak_words))
    if B % (ndev * block_rows):
        raise ValueError(f"batch width {B} not a multiple of {ndev} devices "
                         f"x {block_rows} block rows")
    L = B // ndev
    if pack_flags and L % 32:
        raise ValueError(f"packed flags need a shard width that is a "
                         f"multiple of 32, got {L}")

    def split(x, lanes):
        if lanes or is_sharded(x):
            parts = sh.lanes(x)
        else:
            reps = sh.replicated(x)
            parts = [reps[d] for d in mesh.devices]
        for p, d in zip(parts, mesh.devices):
            if p.device != d:
                raise ValueError(f"a shard on {p.device} for the mesh "
                                 f"entry {d}")
        return parts

    tw = split(tweak_words, True)
    if any(t.shape[1] != L for t in tw):
        raise ValueError(f"shards of {[t.shape[1] for t in tw]} lanes; "
                         f"each entry takes {L}")
    oh = split(outputs_hi, True)
    ol = split(outputs_lo, not hi_only)
    ovm = split(outputs_mask, hi_only not in HI_UNITS)
    bm = ([None] * ndev if blockmask is None else split(blockmask, True))
    sp, lab, cb = (sh.replicated(x) for x in (spend, labels, comb))
    fan = Fanout(mesh, streams)
    flags = []
    for k, dev in enumerate(mesh.devices):
        if dev.type == "cpu" and bm[k] is not None and not bm[k].any():
            # a shard of padding: the plain version is skipped (its flags
            # are 0); on the card the kernel launches with its mask
            flags.append(torch.zeros((1, L // 32), dtype=torch.int32)
                         if pack_flags else
                         torch.zeros((1, L), dtype=torch.int8))
            continue
        with fan.on(k):
            flags.append(scan_flags(
                tw[k], oh[k], ol[k], ovm[k], digits, sp[dev], lab[dev],
                cb[dev], bm[k], block_rows=block_rows, wire=wire,
                pack_flags=pack_flags, ladder=ladder,
                static_sched=static_sched, hi_only=hi_only, nout=nout))
        if dev.type == "cuda":
            SHARDED.launches += 1
    fan.join([[f] for f in flags])
    if whole:
        return torch.cat([f.to(tweak_words.device) for f in flags], dim=1)
    return flags
