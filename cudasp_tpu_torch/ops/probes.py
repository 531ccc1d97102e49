"""The probe kernels: an ALU throughput loop, a field / curve op
micro-benchmark and the scan kernel's stages one at a time, each a
hand-written CUDA kernel (csrc/probe.cu, bodies in csrc/probe.cuh) with
its plain-torch version beside it.

Counterparts of the Pallas kernels of the JAX package's tools:

  alu    tools/alu_probe.py::_kernel            -> alu_kernel
  bench  tools/microbench.py::_bench_kernel     -> bench_kernel
  stage  tools/stage_profile.py::run_stage.make.kern -> stage_kernel

`alu`, `bench` and `stage` launch the kernel for CUDA tensors (csrc/
probe.cu, built with nvcc for sm_90a into build/cudasp_tpu_torch/<source
hash>/libcudasp_probe.so at first use, bound with ctypes) and run the
plain version for CPU tensors. They never fall back from one to the
other: a failed build or launch raises.

Operands, one lane per thread:
  alu      x (rows, bt) int32, values below 2^13 -> (rows, bt) int32
  bench    x, y (8, B) int32: 8 int32 values a lane for the raw cases
           (below 2^13), the 8 little-endian words of a field element for
           the field and curve cases -> (8, B) int32, the canonical field
           value (or the raw words) of a + b
  stage    x, y (8, B) int32 words of field elements, comb the
           (32, 256, 2, 8) int32 comb table -> (8, B) int32 canonical
           words of the chained a
The tools (cudasp_tpu_torch/tools/) feed canonical field elements; the
JAX tools' 13-bit limbs, which may exceed p, have no counterpart on the
card, so a comparison is of canonical values, never of limb layouts.
"""

from __future__ import annotations

import ctypes
import threading
import time

import numpy as np
import torch

from . import curve as C
from . import field as F
from . import kernels as K
from .scalar import GLV_BETA

MASK13 = 0x1FFF
NSTREAMS = 8
ALU_OPS = ("int32 mul", "int32 add", "int32 mul+add", "int32 shift",
           "f32 fma")
# name, raw (8 int32 lanes a lane) or field, ops an iteration
BENCH_CASES = (("int32 mul x4ilp", True, 4), ("int32 add x4ilp", True, 4),
               ("int32 shr x4ilp", True, 4), ("f32 fma x4ilp", True, 4),
               ("raw int32 madd (8,B)", True, 1), ("f32 fma (8,B)", True, 1),
               ("field add", False, 1), ("field mul", False, 1),
               ("field sqr", False, 1), ("ec dbl (3M+4S)", False, 1),
               ("ec madd (8M+3S)", False, 1),
               ("field inv (Fermat)", False, 1))
BENCH_NAMES = tuple(c[0] for c in BENCH_CASES)
# the field ops of probe.cu's field_kernel, one a lane, raw
FIELD_OPS = ("mul", "sqr", "add", "sub")
STAGES = ("decompress", "ladder window", "table+inv", "serial+hash",
          "comb32", "comb32 smem", "match2")

_SOURCES = ("probe.cu", "probe.cuh", "secp256k1.cuh")


# ---------------------------------------------------------------------------
# Plain-torch versions
# ---------------------------------------------------------------------------


def _fma_once(a, b, c):
    """a * b + c rounded once to float32, as one FFMA on the card: exact
    in float64 for the probes' operands (integers below 2^14)."""
    return (a.double() * b.double() + c.double()).float().to(torch.int32)


_ALU_PLAIN = (lambda a, b: a * b, lambda a, b: a + b,
              lambda a, b: a * b + b, lambda a, b: a >> 3,
              lambda a, b: _fma_once(a, b, b))


def alu_plain(x, op: int, iters: int):
    """tools/alu_probe.py::_kernel on int32 lanes: 8 streams x + i, each
    s = op(s, x) & 0x1FFF per iteration, summed."""
    f = _ALU_PLAIN[op]
    s = [x + i for i in range(NSTREAMS)]
    for _ in range(iters):
        s = [f(v, x) & MASK13 for v in s]
    out = s[0]
    for v in s[1:]:
        out = out + v
    return out


def _ilp4(op):
    def body(a, b):
        return (op(a, b) + op(a + 1, b) + op(a + 2, b) + op(a + 3, b)) \
            & MASK13
    return body


_RAW_PLAIN = (
    _ilp4(lambda a, b: (a * b) & MASK13),
    _ilp4(lambda a, b: (a + b) & MASK13),
    _ilp4(lambda a, b: (a >> 3) + b),
    _ilp4(lambda a, b: (a.float() * b.float()).to(torch.int32) & MASK13),
    lambda a, b: (a * b + b) & MASK13,
    lambda a, b: _fma_once(a, b, b) & MASK13,
)


def _dbl_body(a, b):
    x, y, z = C.dbl(a, b, F.one_like(a))
    return x, F.add(y, z)


def _madd_body(a, b):
    x, y, z = C.madd(a, b, F.one_like(a), b, a)
    return x, F.add(y, z)


_FIELD_PLAIN = (
    lambda a, b: (F.add(a, b), b),
    lambda a, b: (F.mul(a, b), b),
    lambda a, b: (F.sqr(a), b),
    _dbl_body,
    _madd_body,
    lambda a, b: (F.inv(a), b),
)


def planes_to_fe(planes):
    """(8, B) int32 word planes -> (B, 16) plain limbs."""
    return F.words_to_fe(planes.T)


def fe_to_planes(a):
    """(B, 16) plain limbs -> (8, B) int32 canonical words."""
    w = F.fe_to_words(F.canonical(a))
    return (w - ((w >> 31) << 32)).to(torch.int32).T.contiguous()


def bench_plain(x, y, case: int, iters: int):
    """tools/microbench.py::_bench_kernel for one BENCH_CASES body:
    (a, b) = body(a, b) per iteration, out = a + b (word-wise for the
    raw cases, the canonical field sum for the others)."""
    if BENCH_CASES[case][1]:
        a, b = x, y
        for _ in range(iters):
            a = _RAW_PLAIN[case](a, b)
        return a + b
    a, b = planes_to_fe(x), planes_to_fe(y)
    for _ in range(iters):
        a, b = _FIELD_PLAIN[case - len(_RAW_PLAIN)](a, b)
    return fe_to_planes(F.add(a, b))


def _bits(words, pos: int, n: int):
    """Bits pos..pos+n-1 of canonical (..., 8) int64 words."""
    k, s = divmod(pos, 32)
    v = words[..., k] >> s
    if s + n > 32 and k + 1 < 8:
        v = v | (words[..., k + 1] << (32 - s))
    return v & ((1 << n) - 1)


def _decompress(a, b, comb):
    y0 = F.sqrt_candidate(F.add(F.mul(F.sqr(a), a), F.const(7, a)))
    return F.select(F.parity(y0) == 1, y0, F.neg(y0))


def _window(a, b, comb):
    px, py, pz = a, b, F.one_like(a)
    for _ in range(4):
        px, py, pz = C.dbl(px, py, pz)
    px, py, pz = C.madd(px, py, pz, a, b)
    px, py, pz = C.madd(px, py, pz, b, a)
    return F.add(px, F.add(py, pz))


def _table(a, b, comb):
    # build_table: beta x + the affine x of 3P..15P
    chain, zinv = K.odd_chain(a, b)
    acc = F.mul(F.const(GLV_BETA, a), a)
    for (cx, _, _), zi in zip(chain, zinv):
        acc = F.add(acc, F.mul(cx, F.sqr(zi)))
    return acc


def _serial(a, b, comb):
    # the scan's serialize + hash of (a, b, z = b); the first 20 hash
    # bytes as the field element sum byte_i 2^(13 i)
    hw = K.stage_serialize_hash(a, b, b)
    limbs = [torch.zeros_like(hw[..., 0]) for _ in range(F.NL)]
    for i in range(20):
        byte = (hw[..., i // 4] >> (8 * (3 - i % 4))) & 0xFF
        j, s = divmod(13 * i, F.LB)
        limbs[j] = limbs[j] | ((byte << s) & F.M16)
        if s + 8 > F.LB:
            limbs[j + 1] = limbs[j + 1] | (byte >> (F.LB - s))
    return torch.stack(limbs, -1)


def _comb(a, b, comb):
    words = F.fe_to_words(F.canonical(a))
    byte = [_bits(words, 13 * (i % 20), 8) for i in range(32)]
    combfe = F.words_to_fe(comb)                        # (32, 256, 2, 16)
    px, py, pz = a, b, F.one_like(a)
    for i in range(32):
        q = combfe[i][byte[i]]
        px, py, pz = C.madd(px, py, pz, q[..., 0, :], q[..., 1, :])
    return F.add(px, F.add(py, pz))


def _match2(a, b, comb):
    one = F.one_like(a)
    f = C.madd(a, b, one, b, a)
    c = C.madd(*f, a, b)
    hit = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    for x, _, z in (f, c):
        w = F.fe_to_words(F.canonical(F.mul(x, F.sqr(F.inv(z)))))
        hit = hit | ((w[..., 7] == w[..., 6]) & (w[..., 5] == w[..., 4]))
    return F.select(hit, a, b)


# the two comb stages compute the same function: they differ on the card
# only in where the bytes wait
_STAGE_PLAIN = (_decompress, _window, _table, _serial, _comb, _comb,
                _match2)


def stage_plain(x, y, stage: int, iters: int, comb):
    """tools/stage_profile.py's kern for one STAGES body: a =
    stage(a, b) per iteration, out = canonical a."""
    a, b = planes_to_fe(x), planes_to_fe(y)
    for _ in range(iters):
        a = _STAGE_PLAIN[stage](a, b, comb)
    return fe_to_planes(a)


# ---------------------------------------------------------------------------
# The CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------


class ProbeLibrary:
    """csrc/probe.cu, built at first use with nvcc into
    build/cudasp_tpu_torch/<source hash>/libcudasp_probe.so and bound with
    ctypes; a library on disk is reused while its hash matches.

    launches: {kernel name: launches} of alu_kernel, bench_kernel and
    stage_kernel, one added where each launches and nowhere else;
    field_launches: those of field_kernel, the field ops' check entry.
    nvcc_runs, build_seconds, build_log: this object's nvcc builds."""

    KERNEL_NAMES = ("alu_kernel", "bench_kernel", "stage_kernel")

    def __init__(self):
        self.launches = dict.fromkeys(self.KERNEL_NAMES, 0)
        self.field_launches = 0
        self.nvcc_runs = 0
        self.build_seconds = None
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def library(self):
        with self._lock:
            if self._lib is not None:
                return self._lib
            lib, build = K.source_library("probe.cu", _SOURCES,
                                          "libcudasp_probe.so")
            if build is not None:
                self.nvcc_runs += 1
                self.build_seconds, self.build_log = build
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.cudasp_probe_alu.argtypes = [ci, vp, vp, ci, ci, vp]
            lib.cudasp_probe_bench.argtypes = [ci, vp, vp, vp, ci, ci, vp]
            lib.cudasp_probe_stage.argtypes = [ci] + [vp] * 4 + [ci, ci, vp]
            lib.cudasp_probe_field.argtypes = [ci, vp, vp, vp, ci, vp]
            for fn in (lib.cudasp_probe_alu, lib.cudasp_probe_bench,
                       lib.cudasp_probe_stage, lib.cudasp_probe_field):
                fn.restype = ci
            self._lib = lib
            return lib

    def launch(self, kernel: str, fn: str, case: int, tensors, iters: int,
               n: int, device):
        """One launch of `kernel` through entry point `fn` on the current
        stream of `device`; raises on a launch error."""
        lib = self.library()
        with torch.cuda.device(device):
            rc = getattr(lib, fn)(case, *(t.data_ptr() for t in tensors),
                                  iters, n,
                                  torch.cuda.current_stream(device)
                                  .cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{kernel} (case {case}) launch failed: CUDA "
                               f"error {rc}")
        self.launches[kernel] += 1


PROBES = ProbeLibrary()


def _check(name, t, device, shape=None):
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous int32 tensor on "
                         f"{device}, got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _case(index, names, what):
    if not isinstance(index, int) or not 0 <= index < len(names):
        raise ValueError(f"{what} must be an index into {names}")
    return index


def _iters(iters):
    if not isinstance(iters, int) or iters < 0:
        raise ValueError("iters must be a non-negative int")
    return iters


def _on_cuda(x):
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cuda"


def alu(x, op: int, iters: int):
    """The ALU probe: ALU_OPS[op] over the int32 lanes of x, `iters`
    times. CUDA tensors launch alu_kernel; CPU tensors run alu_plain."""
    op, iters = _case(op, ALU_OPS, "op"), _iters(iters)
    _check("x", x, x.device)
    if not _on_cuda(x):
        return alu_plain(x, op, iters)
    out = torch.empty_like(x)
    PROBES.launch("alu_kernel", "cudasp_probe_alu", op, (x, out), iters,
                  x.numel(), x.device)
    return out


def bench(x, y, case: int, iters: int):
    """One micro-benchmark body, BENCH_CASES[case], on (8, B) planes.
    CUDA tensors launch bench_kernel; CPU tensors run bench_plain."""
    case, iters = _case(case, BENCH_NAMES, "case"), _iters(iters)
    _check("x", x, x.device)
    if x.dim() != 2 or x.shape[0] != 8:
        raise ValueError("x must be (8, B)")
    _check("y", y, x.device, x.shape)
    if not _on_cuda(x):
        return bench_plain(x, y, case, iters)
    out = torch.empty_like(x)
    PROBES.launch("bench_kernel", "cudasp_probe_bench", case, (x, y, out),
                  iters, x.shape[1], x.device)
    return out


def stage(x, y, index: int, iters: int, comb):
    """One scan stage, STAGES[index], chained `iters` times on (8, B)
    planes of field elements. CUDA tensors launch stage_kernel; CPU
    tensors run stage_plain."""
    index, iters = _case(index, STAGES, "stage"), _iters(iters)
    _check("x", x, x.device)
    if x.dim() != 2 or x.shape[0] != 8:
        raise ValueError("x must be (8, B)")
    _check("y", y, x.device, x.shape)
    _check("comb", comb, x.device, (32, 256, 2, 8))
    if not _on_cuda(x):
        return stage_plain(x, y, index, iters, comb)
    out = torch.empty_like(x)
    PROBES.launch("stage_kernel", "cudasp_probe_stage", index,
                  (x, y, comb, out), iters, x.shape[1], x.device)
    return out


def field_plain(x, y, op: int):
    """FIELD_OPS[op] of the (8, B) planes x and y, canonical."""
    a, b = planes_to_fe(x), planes_to_fe(y)
    ops = (F.mul, lambda u, _: F.sqr(u), F.add, F.sub)
    return fe_to_planes(ops[op](a, b))


def field_op(x, y, op: int):
    """FIELD_OPS[op] of the (8, B) planes x and y, one lane a row. CUDA
    tensors launch field_kernel, which returns the op's words as the
    card's code leaves them (below 2^256, not canonical); CPU tensors run
    field_plain (canonical: the same values mod p)."""
    op = _case(op, FIELD_OPS, "op")
    _check("x", x, x.device)
    if x.dim() != 2 or x.shape[0] != 8:
        raise ValueError("x must be (8, B)")
    _check("y", y, x.device, x.shape)
    if not _on_cuda(x):
        return field_plain(x, y, op)
    out = torch.empty_like(x)
    lib = PROBES.library()
    with torch.cuda.device(x.device):
        rc = lib.cudasp_probe_field(op, x.data_ptr(), y.data_ptr(),
                                    out.data_ptr(), x.shape[1],
                                    torch.cuda.current_stream(x.device)
                                    .cuda_stream)
    if rc != 0:
        raise RuntimeError(f"field_kernel ({FIELD_OPS[op]}) launch failed: "
                           f"CUDA error {rc}")
    PROBES.field_launches += 1
    return out


# ---------------------------------------------------------------------------
# Shared by the tools: inputs and timing
# ---------------------------------------------------------------------------


def field_planes(rng, n: int) -> np.ndarray:
    """(8, n) uint32 words of random field elements below
    2^256 - 2^224 < p, from a numpy Generator."""
    w = rng.integers(0, 2**32, size=(8, n), dtype=np.uint64).astype(np.uint32)
    w[7] = np.minimum(w[7], np.uint32(0xFFFFFFFE))
    return w


def raw_planes(rng, shape, low: int = 0) -> np.ndarray:
    """int32 values in [low, 0x1FFF), as the JAX tools draw them."""
    return rng.integers(low, MASK13, size=shape).astype(np.int32)


def to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(
        device)


def resolve_device(name: str) -> torch.device:
    """The tools' --device: "cuda" needs a GPU and raises without one;
    "cpu" runs the plain versions."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probes run on a GPU (pass "
                           "--device cpu for the plain versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


def best_ms(fn, device, reps: int) -> float:
    """Best of `reps` timed calls after one warm-up, in ms: CUDA events
    around each launch on a GPU, the host clock on the CPU."""
    fn()
    best = float("inf")
    if device.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        for _ in range(reps):
            ev[0].record()
            fn()
            ev[1].record()
            ev[1].synchronize()
            best = min(best, ev[0].elapsed_time(ev[1]))
        return best
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def device_name(device) -> str:
    if device.type == "cuda":
        return (f"{torch.cuda.get_device_name(device)} (count "
                f"{torch.cuda.device_count()})")
    return "cpu (plain versions)"
