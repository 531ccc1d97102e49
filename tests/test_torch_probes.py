"""The port's probe kernels (ops/probes.py, csrc/probe.cu) against the JAX
package's probe tools: the plain version of each ALU op, micro-benchmark
case and scan stage gives what the JAX tool's Pallas kernel (in interpret
mode, as the JAX package's own CPU tests run its kernels) or stage body
gives on the same integers; the card's own probe code, csrc/probe.cuh
built with g++, equals the plain version on every case; the three tools
run end to end on the CPU when asked and raise without a GPU otherwise;
a failed build raises and nothing falls back.

Inputs come from seeded numpy draws and go to both sides as the same
integers: F.int_to_limbs for the JAX package (13-bit limbs), int_to_words
for the port (32-bit words). The raw int32 cases are compared bit for
bit; field and curve values as canonical integers mod p, never as limb
layouts. The f32 fma rule: the port rounds a * b + b once (one FFMA on
the card; float64 then one rounding in the plain version and the host
build, exact for these integers below 2^14), and XLA on the CPU computes
the JAX body with one rounding as well, so these are bit for bit too;
test_f32_fma_rounds_once shows that two roundings would differ on this
data, so the comparison can tell them apart."""

import ctypes
import functools
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cudasp_tpu.ops import field as JF
from cudasp_tpu.ops import kernels as JK
from cudasp_tpu.ops import scalar as JS
from cudasp_tpu.oracle import ec as JO

from cudasp_tpu_torch.ops import field as TF
from cudasp_tpu_torch.ops import kernels as TK
from cudasp_tpu_torch.ops import probes as P
from cudasp_tpu_torch.tools import alu_probe, microbench, stage_profile

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "cudasp_tpu_torch" / "csrc"
LANES = 64
MASK = JF.MASK


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the machine
    (measured: 5x slower for these files), and these tensors are small."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tool(name):
    """The JAX package's tools/<name>.py, imported from its file."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _field_ints(seed, n=LANES):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % JF.P_INT
            for _ in range(n)]


def _on_curve(seed, n=LANES):
    rng = np.random.default_rng(seed)
    pts = [JO.ec_mul((JO.GX, JO.GY), int(k))
           for k in rng.integers(1, 2**62, size=n)]
    return [p[0] for p in pts], [p[1] for p in pts]


def _jax_planes(ints):
    return np.stack([JF.int_to_limbs(v) for v in ints], 1)


def _port_planes(ints):
    return torch.from_numpy(np.stack([TF.int_to_words(v) for v in ints], 1)
                            .view(np.int32))


def _jax_values(limbs):
    return [JF.limbs_to_int(limbs[:, k]) % JF.P_INT
            for k in range(limbs.shape[1])]


def _port_values(planes):
    w = np.asarray(planes).view(np.uint32)
    return [TF.words_to_int(w[:, k]) for k in range(w.shape[1])]


# ---------------------------------------------------------------------------
# ALU ops: tools/alu_probe.py::_kernel, interpret mode, 8 x 128, 5 iters
# ---------------------------------------------------------------------------

# tools/alu_probe.py:79-86
JAX_ALU_OPS = (
    lambda a, b: a * b,
    lambda a, b: a + b,
    lambda a, b: a * b + b,
    lambda a, b: a >> 3,
    lambda a, b: (a.astype(jnp.float32) * b.astype(jnp.float32)
                  + b.astype(jnp.float32)).astype(jnp.int32),
)


@pytest.mark.parametrize("op", range(len(P.ALU_OPS)), ids=P.ALU_OPS)
def test_alu_plain_equals_jax_kernel(op):
    alu = _tool("alu_probe")
    x = P.raw_planes(np.random.default_rng(op), (8, 128), low=1)
    fn = jax.jit(pl.pallas_call(
        functools.partial(alu._kernel, JAX_ALU_OPS[op], 5, P.NSTREAMS),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
        interpret=True))
    ref = np.asarray(fn(x))
    ours = P.alu(torch.from_numpy(x), op, 5).numpy()
    np.testing.assert_array_equal(ours, ref)


def test_f32_fma_rounds_once():
    """One step of the f32 fma on the ALU data: the plain version (one
    rounding) equals XLA's, and a product rounded before the add would
    differ on this data."""
    x = P.raw_planes(np.random.default_rng(4), (8, 128), low=1)
    xf = x.astype(np.float32)
    twice = (xf * xf + xf).astype(np.int32)
    xla = np.asarray(jax.jit(JAX_ALU_OPS[4])(x, x))
    ours = P._fma_once(*(torch.from_numpy(x),) * 3).numpy()
    np.testing.assert_array_equal(ours, xla)
    assert (ours != twice).sum() > 0


# ---------------------------------------------------------------------------
# Micro-benchmark cases: tools/microbench.py::_bench_kernel, interpret mode
# ---------------------------------------------------------------------------


def _ilp4(op):
    def body(a, b):
        return (op(a, b) + op(a + 1, b) + op(a + 2, b) + op(a + 3, b)) \
            & MASK, b
    return body


def _f32(a):
    return a.astype(jnp.float32)


def _xyz_to_ab(x, y, z):
    return x, JF.add(y, z)


# the bodies of tools/microbench.py:85-142, in BENCH_CASES order
JAX_BENCH = (
    _ilp4(lambda a, b: (a * b) & MASK),
    _ilp4(lambda a, b: (a + b) & MASK),
    _ilp4(lambda a, b: (a >> 3) + b),
    _ilp4(lambda a, b: (_f32(a) * _f32(b)).astype(jnp.int32) & MASK),
    lambda a, b: ((a * b + b) & MASK, b),
    lambda a, b: ((_f32(a) * _f32(b) + _f32(b)).astype(jnp.int32) & MASK,
                  b),
    lambda a, b: (JF.add(a, b), b),
    lambda a, b: (JF.mul(a, b), b),
    lambda a, b: (JF.sqr(a), b),
    lambda a, b: _xyz_to_ab(*JK._dbl(a, b, JF.one_like(a))),
    lambda a, b: _xyz_to_ab(*JK._madd_core(a, b, JF.one_like(a), b, a)),
    lambda a, b: (JF.inv(a), b),
)


@pytest.mark.parametrize("case", range(len(P.BENCH_CASES)),
                         ids=P.BENCH_NAMES)
def test_bench_plain_equals_jax_kernel(case):
    bench = _tool("microbench")
    raw = P.BENCH_CASES[case][1]
    if raw:
        rng = np.random.default_rng(10 + case)
        jx, jy = (P.raw_planes(rng, (8, LANES)) for _ in range(2))
        tx, ty = torch.from_numpy(jx), torch.from_numpy(jy)
    else:
        ints = [_field_ints(20 + case), _field_ints(40 + case)]
        jx, jy = (_jax_planes(v) for v in ints)
        tx, ty = (_port_planes(v) for v in ints)
    for iters in ((1,) if P.BENCH_NAMES[case].startswith("field inv")
                  else (1, 3)):
        fn = jax.jit(pl.pallas_call(
            functools.partial(bench._bench_kernel, JAX_BENCH[case], iters),
            out_shape=jax.ShapeDtypeStruct(jx.shape, jnp.int32),
            interpret=True))
        ref = np.asarray(fn(jx, jy))
        ours = P.bench(tx, ty, case, iters).numpy()
        if raw:
            np.testing.assert_array_equal(ours, ref)
        else:
            assert _port_values(ours) == _jax_values(ref), iters


# ---------------------------------------------------------------------------
# Stages: the bodies of tools/stage_profile.py, rebuilt from F / K
# ---------------------------------------------------------------------------


def _decompress(a, b):                          # stage_profile.py:95-98
    seven = JF.literal_planes(JF.int_to_limbs(7), a.shape[1])
    y0 = JK._canon2d(JF.sqrt_candidate(JF.add(JF.mul(JF.sqr(a), a), seven)))
    return JK._sel((y0[0:1] & 1) == 1, y0, JF.neg(y0))


def _window(a, b):                              # :103-110
    px, py, pz = a, b, JF.one_like(a)
    for _ in range(4):
        px, py, pz = JK._dbl(px, py, pz)
    px, py, pz = JK._madd_core(px, py, pz, a, b)
    px, py, pz = JK._madd_core(px, py, pz, b, a)
    return JF.add(px, JF.add(py, pz))


def _table(a, b):                               # :116-132
    one = JF.one_like(a)
    beta = JF.literal_planes(JF.int_to_limbs(JS.GLV_BETA), a.shape[1])
    d2x, d2y, d2z = JK._dbl(a, b, one)
    qzz = JF.sqr(d2z)
    qzc = JF.mul(d2z, qzz)
    chain = [JK._madd_core(d2x, d2y, d2z, a, b)]
    for _ in range(6):
        c = chain[-1]
        chain.append(JK._jadd_shared_core(c[0], c[1], c[2], d2x, d2y, d2z,
                                          qzz, qzc))
    zinvs = JK._inv_chain_raw([c[2] for c in chain])
    acc = JF.mul(beta, a)
    for m in range(1, 8):
        acc = JF.add(acc, JF.mul(chain[m - 1][0], JF.sqr(zinvs[m - 1])))
    return acc


def _serial(a, b):                              # :137-145
    zi = JK._inv_chain_raw([b])[0]
    zi2 = JF.sqr(zi)
    x_aff = JK._canon2d(JF.mul(a, zi2))
    y_aff = JK._canon2d(JF.mul(b, JF.mul(zi, zi2)))
    parity = (y_aff[0:1] & 1).astype(jnp.uint32)
    hw = JK._tagged_hash_2d(JK._words_be_2d(x_aff), parity)
    return JK._bytes_from_words_2d(hw)[: JF.NLIMBS]


def _comb_scratch(a, b, comb_ref, sbytes):      # :170-186
    iota = jax.lax.broadcasted_iota(jnp.int32, (256, a.shape[1]), 0)
    sbytes[:] = jnp.concatenate([a, a[:12]], axis=0) & 255
    px, py, pz = a, b, JF.one_like(a)

    def win(i, carry):
        px, py, pz = carry
        byte = sbytes[pl.ds(i, 1), :]
        onehot = (iota == byte).astype(jnp.float32)
        sel = jax.lax.dot_general(
            comb_ref[i], onehot, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)
        return JK._madd_core(px, py, pz, sel[: JF.NLIMBS], sel[JF.NLIMBS:])

    px, py, pz = jax.lax.fori_loop(0, 32, win, (px, py, pz))
    return JF.add(px, JF.add(py, pz))


def _match(a, b):                               # :225-236
    one = JF.one_like(a)
    fx, fy, fz = JK._madd_core(a, b, one, b, a)
    cx, cy, cz = JK._madd_core(fx, fy, fz, a, b)
    zinvs = JK._inv_chain_raw([fz, cz])
    hit = jnp.zeros((1, a.shape[1]), jnp.bool_)
    for (x, z), zi in zip(((fx, fz), (cx, cz)), zinvs):
        w = JK._words_be_2d(JK._canon2d(JF.mul(x, JF.sqr(zi))))
        hit = hit | ((w[0:1] == w[1:2]) & (w[2:3] == w[3:4]))
    return JK._sel(hit, a, b)


def _run_interpret(body, n, x, y, extra=(), scratch=()):
    """run_stage's kern (stage_profile.py:53-64) in interpret mode."""
    def kern(x_ref, y_ref, *rest):
        out_ref = rest[len(extra)]
        scr = rest[len(extra) + 1:]
        b = y_ref[:]
        out_ref[:] = jax.lax.fori_loop(
            0, n, lambda i, a: body(a, b, *rest[:len(extra)], *scr),
            x_ref[:])

    return np.asarray(jax.jit(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
        scratch_shapes=list(scratch), interpret=True))(x, y, *extra))


@functools.lru_cache(maxsize=None)
def _jit_loop(body):
    """The same loop under jax.jit with the repeat count traced: one
    compile for every count."""
    return jax.jit(lambda x, y, n: jax.lax.fori_loop(
        0, n, lambda i, a: body(a, y), x))


# stage index -> (JAX body, iteration counts, how it runs). The three
# bodies with an inversion (table, serial, match2) compile for 20-50 s in
# interpret mode here, so they run under jax.jit + fori_loop on the CPU
# (the same XLA ops; only the Pallas wrapper is left out); table runs on
# on-curve points at one iteration: its co-Z chain and the JAX package's
# shared-z chain agree only on the curve, and chaining leaves it.
STAGE_CASES = {
    "decompress": (_decompress, (1, 3), "interpret"),
    "ladder window": (_window, (1, 3), "interpret"),
    "table+inv": (_table, (1,), "jit"),
    "serial+hash": (_serial, (1, 3), "jit"),
    "comb32": (_comb_scratch, (1,), "interpret"),
    "match2": (_match, (1, 3), "jit"),
}


@pytest.mark.parametrize("name", list(STAGE_CASES))
def test_stage_plain_equals_jax_body(name):
    """Both comb stages of the port (bytes in registers or staged in
    shared memory) hold to the JAX tool's kernel-faithful "comb32
    scratch" body: its bytes are fixed up front from the input, as the
    port's are, where the plain "comb32" body reads the running
    accumulator's lazy limb, which has no counterpart in the port."""
    body, counts, how = STAGE_CASES[name]
    ints = _on_curve(50) if name == "table+inv" else [_field_ints(51),
                                                      _field_ints(52)]
    jx, jy = (_jax_planes(v) for v in ints)
    tx, ty = (_port_planes(v) for v in ints)
    comb = TK.comb_table("cpu")
    ports = ["comb32", "comb32 smem"] if name == "comb32" else [name]
    for iters in counts:
        if name == "comb32":
            ref = _run_interpret(
                body, iters, jx, jy,
                extra=(np.asarray(JS.comb_table(), np.float32),),
                scratch=(pltpu.VMEM((32, LANES), jnp.int32),))
        elif how == "interpret":
            ref = _run_interpret(body, iters, jx, jy)
        else:
            ref = np.asarray(_jit_loop(body)(jx, jy, iters))
        for port in ports:
            ours = P.stage(tx, ty, P.STAGES.index(port), iters, comb)
            assert _port_values(ours) == _jax_values(ref), (port, iters)


# ---------------------------------------------------------------------------
# The card's probe code on the host: probe.cuh under g++
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the probes' host check"
    so = tmp_path_factory.mktemp("probehost") / "libprobehost.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
                    "-Werror", "-I", str(CSRC), "-o", str(so),
                    str(CSRC / "probe_host.cpp")], check=True,
                   capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sp_probe_alu.argtypes = [ci, vp, vp, ci, ci]
    lib.sp_probe_bench.argtypes = [ci, vp, vp, vp, ci, ci]
    lib.sp_probe_stage.argtypes = [ci, vp, vp, vp, vp, ci, ci]
    return lib


def _ptr(t):
    return t.data_ptr()


def test_host_build_alu_equals_plain(host_lib):
    x = torch.from_numpy(P.raw_planes(np.random.default_rng(60),
                                      (1, LANES), low=1))
    for op in range(len(P.ALU_OPS)):
        for iters in (1, 2, 3):
            out = torch.empty_like(x)
            assert host_lib.sp_probe_alu(op, _ptr(x), _ptr(out), iters,
                                         LANES) == 0
            assert torch.equal(out, P.alu(x, op, iters)), (op, iters)
    assert host_lib.sp_probe_alu(len(P.ALU_OPS), _ptr(x), _ptr(x), 1,
                                 LANES) == 1


def test_host_build_bench_equals_plain(host_lib):
    rng = np.random.default_rng(61)
    raw = [torch.from_numpy(P.raw_planes(rng, (8, LANES))) for _ in "xy"]
    fld = [P.to_device(P.field_planes(rng, LANES), "cpu") for _ in "xy"]
    for case, (name, is_raw, _) in enumerate(P.BENCH_CASES):
        x, y = raw if is_raw else fld
        for iters in ((1,) if name.startswith("field inv") else (1, 2, 3)):
            out = torch.empty_like(x)
            assert host_lib.sp_probe_bench(case, _ptr(x), _ptr(y), _ptr(out),
                                           iters, LANES) == 0
            assert torch.equal(out, P.bench(x, y, case, iters)), (name,
                                                                  iters)


def test_host_build_stages_equal_plain(host_lib):
    rng = np.random.default_rng(62)
    x, y = (P.to_device(P.field_planes(rng, LANES), "cpu") for _ in "xy")
    comb = TK.comb_table("cpu")
    for index, name in enumerate(P.STAGES):
        for iters in (1, 2, 3):
            out = torch.empty_like(x)
            assert host_lib.sp_probe_stage(index, _ptr(x), _ptr(y),
                                           _ptr(comb), _ptr(out), iters,
                                           LANES) == 0
            assert torch.equal(out, P.stage(x, y, index, iters, comb)), (
                name, iters)


# ---------------------------------------------------------------------------
# Entry points, devices and builds
# ---------------------------------------------------------------------------


def _lines(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines()
            if not ln.startswith(("#", " "))]


def test_tools_run_on_cpu_when_asked(capsys):
    """Each tool prints one line a case, in the JAX tool's format (name
    padded to its width), and returns its numbers."""
    cpu = ["--device", "cpu"]
    res = alu_probe.main(cpu + ["--rows", "2", "--bt", "32", "--iters",
                                "2"])
    assert list(res) == list(P.ALU_OPS)
    assert [ln[:21] for ln in _lines(capsys)] == [f"{n:20s} "
                                                  for n in P.ALU_OPS]
    res = microbench.main(cpu + ["--bt", "32", "--iters", "1"])
    assert list(res) == list(P.BENCH_NAMES)
    assert [ln[:25] for ln in _lines(capsys)] == [f"{n:24s} "
                                                  for n in P.BENCH_NAMES]
    res = stage_profile.main(cpu + ["--bt", "32", "--iters", "1"])
    assert list(res) == list(P.STAGES) + ["FULL", "budget"]
    assert res["FULL"]["rows"] == 32 and res["budget"]["share"] > 0
    lines = _lines(capsys)
    assert [ln[:15] for ln in lines] == [
        f"{n:14s} " for n in P.STAGES + ("FULL kernel",)] + ["budget: decompr"]


def test_tools_default_to_cuda_and_raise_without_gpu():
    assert not torch.cuda.is_available()
    for tool in (alu_probe, microbench, stage_profile):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main([])


def test_wrappers_check_operands():
    x = torch.zeros((8, 4), dtype=torch.int32)
    comb = TK.comb_table("cpu")
    with pytest.raises(ValueError, match="op"):
        P.alu(x, len(P.ALU_OPS), 1)
    with pytest.raises(ValueError, match="case"):
        P.bench(x, x, -1, 1)
    with pytest.raises(ValueError, match="int32"):
        P.bench(x, x.long(), 0, 1)
    with pytest.raises(ValueError, match="stage"):
        P.stage(x, x, len(P.STAGES), 1, comb)
    with pytest.raises(ValueError, match="iters"):
        P.stage(x, x, 0, -1, comb)
    with pytest.raises(ValueError, match="comb"):
        P.stage(x, x, 0, 1, comb[:2])


FAILING_NVCC = "#!{python}\nimport sys\nsys.exit('probe.cu(1): error')\n"


def test_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(TK, "_BUILD_ROOT", str(tmp_path / "build"))
    x = torch.zeros((1, 32), dtype=torch.int32)
    cuda = torch.device("cuda")
    # nvcc missing
    monkeypatch.setattr(TK.shutil, "which", lambda _: None)
    monkeypatch.setattr(TK, "NVCC_DEFAULT", str(tmp_path / "no-nvcc"))
    lib = P.ProbeLibrary()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lib.launch("alu_kernel", "cudasp_probe_alu", 0, (x, x), 1, 32, cuda)
    # nvcc present and failing: the error carries its log, no library
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAILING_NVCC.replace("{python}", sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setattr(TK, "NVCC_DEFAULT", str(nvcc))
    with pytest.raises(RuntimeError, match="nvcc failed") as err:
        lib.library()
    assert "probe.cu(1): error" in str(err.value)
    built = [p.name for p in (tmp_path / "build").rglob("*")
             if p.is_file()]
    assert not any(n.endswith(".so") for n in built), built
    assert lib.launches == dict.fromkeys(lib.KERNEL_NAMES, 0)
    assert lib.nvcc_runs == 0
