"""The port's C packer (cudasp_tpu_torch/csrc/pack.cpp, io/native.py)
against the numpy packers: pack_wire is bit-equal to the port's
pack_batch_arrays and to the JAX package's on every upload mode and
output count, on ragged widths, NULL and padding rows, with 1 thread and
with several; pack_points is the LE word view of the blobs;
count_chunks and pack_outputs equal the JAX package's own C library
(csrc/ingest.cpp, built here by g++ into a temporary directory) and its
iter_packed."""

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from cudasp_tpu.io import ingest as JI
from cudasp_tpu.ops import kernels as JK

import cudasp_tpu_torch as ct
from cudasp_tpu_torch.io import ingest as TI
from cudasp_tpu_torch.io import native as N
from cudasp_tpu_torch.ops import kernels as TK
from cudasp_tpu_torch.runtime import executor as TX

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_HI = {"hi32": True, "hi16": "hi16", "hi8": "hi8"}
CAPS = {"full": 30, "full64": 30, "hi32": 30, "hi16": 14, "hi8": 6}


def _batch(seed, B, M):
    """Random rows: a tenth NULL (row_valid False), the last 5 padding
    (zero blobs and outputs, as iter_packed pads), ragged outputs."""
    rng = np.random.default_rng(seed)
    blobs = rng.integers(0, 256, size=(B, 64), dtype=np.uint8)
    valid = rng.random(B) < 0.9
    hi = rng.integers(-2**31, 2**31, size=(B, M)).astype(np.int32)
    lo = rng.integers(-2**31, 2**31, size=(B, M)).astype(np.int32)
    ov = rng.random((B, M)) < 0.7
    for a in (blobs, hi, lo, ov):
        a[-5:] = 0
    valid[-5:] = False
    return blobs, valid, hi, lo, ov


def _numpy_wire(args, mode, block_rows, jax=False):
    """The numpy packers' planes of `mode` in wire order (a cut's dummies
    stay behind), stacked."""
    wire = "xy" if mode == "full64" else "x"
    cut = mode if mode.startswith("hi") else None
    if jax:
        planes = JK.pack_batch_arrays(*args, block_rows,
                                      hi_only=JAX_HI.get(cut, False),
                                      wire=wire)
    else:
        planes = TK.pack_batch_arrays(*args, block_rows=block_rows,
                                      wire=wire, hi_only=cut)
    keep = {None: (0, 1, 2, 3), "hi32": (0, 1, 3)}.get(cut, (0, 1))
    return np.concatenate([planes[k] for k in keep])


@pytest.mark.parametrize("mode", N.MODES)
def test_pack_wire_equals_both_numpy_packers(mode):
    """Every output count up to the mode's cap, a width that is not a
    block multiple, NULL and padding rows: the planes are bit-equal to
    both numpy packers, the block-mask row to live_blockmask."""
    B, br = 77, 32
    for M in range(1, CAPS[mode] + 1):
        args = _batch(M, B, M)
        ref = _numpy_wire(args, mode, br)
        np.testing.assert_array_equal(ref, _numpy_wire(args, mode, br,
                                                       jax=True))
        width = ref.shape[1]
        assert width == 96
        n_live = int(args[1].sum())
        out = N.pack_wire(*args, mode, width, br, n_live)
        assert out.dtype == np.uint32
        assert out.shape == (N.plane_rows(mode, M) + 1, width)
        assert out[:-1].tobytes() == ref.tobytes(), (mode, M)
        bm = TK.live_blockmask(n_live, width // br, br)
        want = np.zeros(width, np.uint32)
        want[:width // br] = 1 if bm is None else bm
        np.testing.assert_array_equal(out[-1], want)


@pytest.mark.parametrize("mode", N.MODES)
def test_pack_wire_threads_rows_and_a_caller_buffer(mode):
    """1 thread and several give the same words; rows [a, b) of a batch
    land in lanes 0..b-a-1 and the rest of the lanes are 0; the words go
    into a caller's int32 buffer (the pinned slot's view), padded to a
    mesh's block_rows x entries."""
    B, M, br = 5000, 3, 64
    args = _batch(11, B, M)
    width = 4 * br * -(-B // (4 * br))
    one = N.pack_wire(*args, mode, width, br, B, threads=1)
    for threads in (2, 3, 8):
        np.testing.assert_array_equal(
            one, N.pack_wire(*args, mode, width, br, B, threads=threads))
    buf = np.full(one.size + 17, -1, np.int32)
    got = N.pack_wire(*args, mode, width, br, B, out=buf, threads=4)
    assert got.base is buf or np.shares_memory(got, buf)
    np.testing.assert_array_equal(got.view(np.uint32), one)
    assert (buf[one.size:] == -1).all()
    a, b = 1000, 1300
    part = N.pack_wire(*args, mode, 512, br, b - a, rows=(a, b))
    sub = [x[a:b] for x in args]
    np.testing.assert_array_equal(part[:-1, :b - a], N.pack_wire(
        *sub, mode, 320, br, b - a)[:-1, :b - a])
    assert not part[:-1, b - a:].any()


def test_pack_wire_bits():
    """The validity word's bits: 0..M-1 outputs valid, 30 the y parity
    (byte 32 of the blob, odd), 31 the row valid; on hi16 / hi8 the unit
    after the M match units, with parity at bit 14 / 6 and row valid at
    15 / 7; the LE word view of the blobs (pack_points)."""
    B, M = 8, 3
    blobs = np.zeros((B, 64), np.uint8)
    blobs[:, 32] = np.arange(B)                 # y's low byte
    blobs[:, 0:4] = [1, 2, 3, 4]
    valid = np.array([1, 0] * 4, bool)
    ov = np.zeros((B, M), bool)
    ov[:, 1] = True
    hi = np.full((B, M), -1, np.int32)
    lo = np.zeros((B, M), np.int32)
    full = N.pack_wire(blobs, valid, hi, lo, ov, "full", 8, 8, B)
    ovm = full[8 + 2 * M]
    assert list(ovm & 7) == [2] * B
    assert list((ovm >> 30) & 1) == [i & 1 for i in range(B)]
    assert list(ovm >> 31) == [1, 0] * 4
    assert full[0, 0] == 0x04030201
    for mode, (bits, per, cap) in TK.HI_UNITS.items():
        w = N.pack_wire(blobs, valid, hi, lo, ov, mode, 8, 8, B)
        unit = (w[8 + M // per] >> (bits * (M % per))) & ((1 << bits) - 1)
        assert list(unit & 7) == [2] * B
        assert list((unit >> cap) & 1) == [i & 1 for i in range(B)]
        assert list(unit >> (cap + 1)) == [1, 0] * 4
        assert list(w[8] & ((1 << bits) - 1)) == [(1 << bits) - 1] * B
    x, y = N.pack_points(blobs)
    assert sys.byteorder == "little"
    np.testing.assert_array_equal(x, blobs[:, :32].view("<u4").T)
    np.testing.assert_array_equal(y, blobs[:, 32:].view("<u4").T)
    tx, ty = TI.point_blobs_to_limbs(blobs)
    np.testing.assert_array_equal(x, tx)
    np.testing.assert_array_equal(y, ty)
    jx, jy = JI.point_blobs_to_limbs(blobs)
    np.testing.assert_array_equal(x, ct.from_jax_limbs(jx))
    np.testing.assert_array_equal(y, ct.from_jax_limbs(jy))


def test_pack_wire_refuses_what_the_wire_cannot_carry():
    args = _batch(3, 40, 31)
    with pytest.raises(ValueError, match="1..30"):
        N.pack_wire(*args, "full", 64, 32, 40)
    for mode, cap in (("hi16", 14), ("hi8", 6)):
        args = _batch(3, 40, cap + 1)
        with pytest.raises(ValueError, match=f"1..{cap}"):
            N.pack_wire(*args, mode, 64, 32, 40)
    args = _batch(3, 40, 3)
    with pytest.raises(ValueError):
        N.pack_wire(*args, "full", 32, 32, 40)      # width < rows
    with pytest.raises(ValueError):
        N.pack_wire(*args, "full", 48, 32, 40)      # not a block multiple
    with pytest.raises(ValueError):
        N.pack_wire(*args, "full", 64, 32, 40, out=np.zeros(10, np.int32))
    with pytest.raises(ValueError):
        N.pack_wire(*args, "full32", 64, 32, 40)


def test_executor_pack_host_is_the_wire_of_each_mode():
    """The executor's pack_host: the wire planes of the port's numpy
    packer, in its spans, and the block mask of live_blockmask (None when
    every block is live)."""
    batches = list(TI.iter_packed(*_table(5, 100), 128, 3))
    assert len(batches) > 1
    for b in batches:
        args = (b.tweak_blobs, b.row_valid, b.outputs_hi, b.outputs_lo,
                b.outputs_valid)
        bm = TK.live_blockmask(b.n_valid, 4, 32)
        for mode in N.MODES:
            pk = TX.pack_host(b, 32, mode)
            assert np.concatenate(pk.wire()).view(np.uint32).tobytes() == \
                _numpy_wire(args, mode, 32).tobytes()
            assert (pk.bmask is None) == (bm is None)
            if bm is not None:
                np.testing.assert_array_equal(pk.bmask, bm)


def _table(seed, n, maxlen=9):
    """(blobs, flat, offsets) with 0..maxlen-1 outputs a row."""
    rng = np.random.default_rng(seed)
    blobs = rng.integers(0, 256, size=(n, 64), dtype=np.uint8)
    lens = rng.integers(0, maxlen, size=n)
    flat = rng.integers(-2**63, 2**63 - 1, size=int(lens.sum()),
                        dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return blobs, flat, offs


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's csrc/ingest.cpp, built by g++ into a temporary
    directory (never make in csrc/, which would write into the tree)."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the JAX package's ingest library"
    so = tmp_path_factory.mktemp("ingest") / "libcudasp_ingest.so"
    subprocess.run([gxx, "-O2", "-fPIC", "-std=c++17", "-shared", "-o",
                    str(so), os.path.join(ROOT, "csrc", "ingest.cpp")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.cudasp_count_chunks.argtypes = [vp, i64, i64, vp]
    lib.cudasp_count_chunks.restype = i64
    lib.cudasp_pack_outputs.argtypes = [vp] * 4 + [i64, i64, vp, vp, vp]
    lib.cudasp_pack_outputs.restype = None
    return lib


@pytest.mark.parametrize("max_outputs", [1, 3, 4, 30])
def test_count_chunks_and_pack_outputs_equal_jax_c_library(jax_lib,
                                                           max_outputs):
    blobs, flat, offs = _table(max_outputs, 300, maxlen=40)
    n = len(offs) - 1
    nch, total = N.count_chunks(offs, max_outputs)
    ref = np.empty(n, np.int64)
    ref_total = jax_lib.cudasp_count_chunks(offs.ctypes.data, n,
                                            max_outputs, ref.ctypes.data)
    assert total == ref_total
    np.testing.assert_array_equal(nch, ref)
    src = np.repeat(np.arange(n, dtype=np.int64), nch)
    cum = np.concatenate([[0], np.cumsum(nch)])
    chunk = np.arange(total, dtype=np.int64) - np.repeat(cum[:-1], nch)
    hi, lo, valid = N.pack_outputs(flat, offs, src, chunk, max_outputs)
    rhi, rlo = (np.empty((total, max_outputs), np.int32) for _ in range(2))
    rvalid = np.empty((total, max_outputs), np.uint8)
    jax_lib.cudasp_pack_outputs(
        flat.ctypes.data, offs.ctypes.data, src.ctypes.data,
        chunk.ctypes.data, total, max_outputs, rhi.ctypes.data,
        rlo.ctypes.data, rvalid.ctypes.data)
    np.testing.assert_array_equal(hi, rhi)
    np.testing.assert_array_equal(lo, rlo)
    np.testing.assert_array_equal(valid, rvalid.astype(bool))
    # against the JAX package's iter_packed (numpy): the same rows, the
    # same values in every valid slot
    jb = list(JI.iter_packed(blobs, flat, offs, total, max_outputs,
                             layout="kernel"))
    assert len(jb) == 1
    np.testing.assert_array_equal(valid, jb[0].outputs_valid)
    np.testing.assert_array_equal(hi[valid], jb[0].outputs_hi[valid])
    np.testing.assert_array_equal(lo[valid], jb[0].outputs_lo[valid])


def test_a_failed_build_raises_with_the_log(tmp_path, monkeypatch):
    bad = tmp_path / "pack.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(N, "_SRC", str(bad))
    monkeypatch.setattr(N, "_BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(N, "STATE", N._State())
    with pytest.raises(RuntimeError, match="g[+][+] failed") as err:
        N.library()
    assert "error" in str(err.value)
    assert not any(p.name.endswith(".so")
                   for p in (tmp_path / "build").rglob("*"))
