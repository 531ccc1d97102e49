"""The CUDA kernel's own arithmetic, checked on the host: csrc/secp256k1.cuh
built with g++ (host_check.cpp, no CUDA) into a temporary directory and
called through ctypes. scan_row() must give the golden flags on both
wires and the oracle's flags on random rows, with each of the three
ladders (the static one through the per-key translation unit that
ops/kernels.py generates, compiled into host_check.cpp); the field ops
must be exact on edge values. This is the one check of the kernel's code
that runs before a card does."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cudasp_tpu_torch.io import ingest as TI
from cudasp_tpu_torch.ops import field as TF
from cudasp_tpu_torch.ops import kernels as TK
from cudasp_tpu_torch.ops import scalar as TS
from cudasp_tpu_torch.oracle import ec as O
from cudasp_tpu_torch.oracle import encoding as E
from cudasp_tpu_torch.oracle import pipeline as PIPE
from cudasp_tpu_torch.oracle import vectors as V

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cudasp_tpu_torch", "csrc")
P = O.P


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the machine
    (measured: 5x slower for these files), and these tensors are small."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _host_build(out_dir, static_tu=None):
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the kernel's host check"
    so = out_dir / "libhostcheck.so"
    extra = [] if static_tu is None else [f'-DSP_STATIC_TU="{static_tu}"']
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
                    "-Werror", "-I", CSRC, *extra, "-o", str(so),
                    os.path.join(CSRC, "host_check.cpp")], check=True,
                   capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ("sp_fe_mul", "sp_fe_add", "sp_fe_sub"):
        getattr(lib, name).argtypes = [vp, vp, vp]
    for name in ("sp_fe_inv", "sp_fe_sqrt", "sp_fe_canon"):
        getattr(lib, name).argtypes = [vp, vp]
    lib.sp_scan_rows.argtypes = [vp] * 4 + [ci] + [vp] * 3 + [ci, vp] + [
        ci] * 4 + [vp]
    fns = [lib.sp_fe_mul, lib.sp_fe_inv, lib.sp_scan_rows]
    if static_tu is not None:
        lib.sp_scan_rows_static.argtypes = [vp] * 6 + [ci, vp] + [
            ci] * 4 + [vp]
        fns.append(lib.sp_scan_rows_static)
    for fn in fns:
        fn.restype = None
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _host_build(tmp_path_factory.mktemp("hostbuild"))


@pytest.fixture(scope="module")
def static_lib(tmp_path_factory):
    """key blob -> the host build with that key's generated static TU,
    built once per key."""
    built = {}

    def get(key_blob):
        if key_blob not in built:
            steps = TS.glv_wnaf_static(E.blob32_to_scalar(key_blob))
            d = tmp_path_factory.mktemp("static")
            (d / "key.cu").write_text(TK.static_source(steps))
            built[key_blob] = _host_build(d, d / "key.cu")
        return built[key_blob]
    return get


EDGES = [0, 1, 2, 977, P - 1, P, P + 1, 2**256 - 1, 2**256 - 2**32,
         2**255, (P + 1) // 2]


def _call(fn, *vals):
    args = [np.ascontiguousarray(TF.int_to_words(v)) for v in vals]
    out = np.zeros(8, np.uint32)
    fn(*(a.ctypes.data for a in args), out.ctypes.data)
    return TF.words_to_int(out)


def _edge_values(seed):
    rng = np.random.default_rng(seed)
    return EDGES + [int.from_bytes(rng.bytes(32), "big") for _ in range(6)]


def test_field_ops_exact_on_edges(lib):
    vals = _edge_values(1)
    for a in vals:
        for b in vals:
            assert _call(lib.sp_fe_mul, a, b) % P == a * b % P
            assert _call(lib.sp_fe_add, a, b) % P == (a + b) % P
            assert _call(lib.sp_fe_sub, a, b) % P == (a - b) % P
        assert _call(lib.sp_fe_canon, a) == a % P
        assert _call(lib.sp_fe_inv, a) % P == pow(a, P - 2, P)
        assert _call(lib.sp_fe_sqrt, a) % P == pow(a, (P + 1) // 4, P)


def _scan_rows(lib, blobs, outputs, key, spend, labels, wire,
               valid=None, ladder="fixed", plain=True, hi_only=None):
    """Host scan_row over the rows with one ladder, on the match planes'
    wire hi_only; returns (flags, plain flags or None)."""
    flat = np.concatenate([np.asarray(o, np.int64) for o in outputs])
    offs = np.cumsum([0] + [len(o) for o in outputs]).astype(np.int64)
    M = max(len(o) for o in outputs)
    b = next(TI.iter_packed(blobs, flat, offs, len(blobs), M))
    row_valid = b.row_valid if valid is None else valid
    planes = [np.ascontiguousarray(p) for p in TK.pack_batch_arrays(
        b.tweak_blobs, row_valid, b.outputs_hi, b.outputs_lo,
        b.outputs_valid, block_rows=32, wire=wire, hi_only=hi_only)]
    sched, sp, lab, nl = TI.pack_query_keys(key, spend, labels)
    digits, static = sched.operands(ladder)
    lab_c = np.ascontiguousarray(lab if nl else np.zeros((1, 2, 8),
                                                         np.uint32))
    comb = TS.comb_table_np()
    width = planes[0].shape[1]
    flags = np.zeros(width, np.int8)
    tw, oh, ol, ovm = planes
    rows = (tw.ctypes.data, oh.ctypes.data, ol.ctypes.data, ovm.ctypes.data)
    tail = (sp.ctypes.data, lab_c.ctypes.data, nl, comb.ctypes.data, width,
            M, 1 if wire == "xy" else 0, TK.HI_CODES[hi_only],
            flags.ctypes.data)
    if ladder == "static":
        lib.sp_scan_rows_static(*rows, *tail)
    else:
        d = np.ascontiguousarray(digits, np.int32)
        lib.sp_scan_rows(*rows, 1 if ladder == "wnaf" else 0, d.ctypes.data,
                         *tail)
    if not plain:
        return flags[:len(blobs)] != 0, None

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))

    pf = TK.scan_plain(*(t(p) for p in planes), digits, t(sp), t(lab),
                       TK.comb_table("cpu"), wire=wire, block_rows=32,
                       ladder=ladder, static_sched=static, hi_only=hi_only,
                       nout=M)
    return flags[:len(blobs)] != 0, pf[0, :len(blobs)].numpy() != 0


@pytest.mark.parametrize("wire", ["x", "xy"])
def test_scan_row_golden(lib, wire):
    for case in V.CASES:
        blobs = np.stack([np.frombuffer(r.tweak_blob, np.uint8)
                          for r in case.rows])
        got, _ = _scan_rows(lib, blobs, [r.outputs for r in case.rows],
                            case.scan_key_blob, case.spend_blob,
                            case.label_blobs, wire, plain=False)
        want = [r.height in case.expected_heights for r in case.rows]
        assert got.tolist() == want, case.name


# the static ladder is built for two keys: the BIP-352 vector's (three
# golden cases, with and without labels) and the random-rows key
STATIC_GOLDEN_KEY = V.CASES[1].scan_key_blob


@pytest.mark.parametrize("ladder", ["wnaf", "static"])
@pytest.mark.parametrize("wire", ["x", "xy"])
def test_scan_row_golden_wnaf_and_static(lib, static_lib, wire, ladder):
    cases = V.CASES if ladder == "wnaf" else [
        c for c in V.CASES if c.scan_key_blob == STATIC_GOLDEN_KEY]
    assert len(cases) == (6 if ladder == "wnaf" else 3)
    for case in cases:
        blobs = np.stack([np.frombuffer(r.tweak_blob, np.uint8)
                          for r in case.rows])
        got, _ = _scan_rows(lib if ladder == "wnaf"
                            else static_lib(case.scan_key_blob), blobs,
                            [r.outputs for r in case.rows],
                            case.scan_key_blob, case.spend_blob,
                            case.label_blobs, wire, ladder=ladder,
                            plain=False)
        want = [r.height in case.expected_heights for r in case.rows]
        assert got.tolist() == want, case.name


def _random_rows(seed):
    """A random key and 64 rows over 8 points, ~20% base and ~15% label
    matches, row 7 invalid; returns (rows, the oracle's flags)."""
    rng = np.random.default_rng(seed)
    g = (O.GX, O.GY)
    key = int.from_bytes(rng.bytes(32), "big") % O.N
    spend = O.ec_mul(g, int(rng.integers(1, 2**62)))
    label = O.ec_mul(g, int(rng.integers(1, 2**62)))
    pts = [O.ec_mul(g, int(k)) for k in rng.integers(1, 2**62, size=8)]
    cands = [PIPE.candidate_values(p, key, spend, [label]) for p in pts]
    pick = rng.integers(0, 8, size=64)
    outputs = []
    for j in pick:
        outs = [int(v) for v in rng.integers(-2**62, 2**62, size=3)]
        r = rng.random()
        if r < 0.2:
            outs[int(rng.integers(0, 3))] = cands[j][0]      # base match
        elif r < 0.35:
            outs[int(rng.integers(0, 3))] = cands[j][1]      # label match
        outputs.append(outs)
    blobs = np.stack([np.frombuffer(E.point_to_blob64(pts[j]), np.uint8)
                      for j in pick])
    valid = np.ones(64, bool)
    valid[7] = False                               # a padding row flags 0
    want = np.array([PIPE.scan_row(pts[j], key, spend, o, [label])
                     for j, o in zip(pick, outputs)]) & valid
    assert 5 < want.sum() < 40
    return (blobs, outputs, E.scalar_to_blob32(key), E.point_to_blob64(spend),
            [E.point_to_blob64(label)]), valid, want


@pytest.mark.parametrize("wire", ["x", "xy"])
def test_scan_row_random_rows_against_oracle(lib, wire):
    args, valid, want = _random_rows(5 if wire == "x" else 6)
    got, plain = _scan_rows(lib, *args, wire, valid)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)


@pytest.fixture(scope="module")
def rows7():
    return _random_rows(7)


@pytest.mark.parametrize("ladder", ["wnaf", "static"])
@pytest.mark.parametrize("wire", ["x", "xy"])
def test_scan_row_random_rows_wnaf_and_static(lib, static_lib, rows7, wire,
                                              ladder):
    """The plain ladders are held to the oracle in test_torch_ladders.py;
    here the card's code is."""
    args, valid, want = rows7
    got, _ = _scan_rows(lib if ladder == "wnaf" else static_lib(args[2]),
                        *args, wire, valid, ladder=ladder, plain=False)
    np.testing.assert_array_equal(got, want)


def test_scan_row_dead_candidate_and_invalid_y(lib):
    """The final point at infinity never matches, even against output 0;
    on the x wire an invalid y with the right parity still scans as the
    on-curve point, on the xy wire it does not."""
    case = V.CASES[0]
    row = case.rows[0]
    tweak = E.blob64_to_point(row.tweak_blob)
    key = E.blob32_to_scalar(case.scan_key_blob)
    t = int.from_bytes(PIPE.shared_secret_hash(O.ec_mul(tweak, key)), "big")
    spend = O.ec_neg(O.ec_mul((O.GX, O.GY), t % O.N))
    blob = np.frombuffer(row.tweak_blob, np.uint8)[None]
    for wire in ("x", "xy"):
        got, plain = _scan_rows(lib, blob, [[0, 5]], case.scan_key_blob,
                                E.point_to_blob64(spend), (), wire)
        assert got.tolist() == plain.tolist() == [False]
    x, y = tweak
    bad = np.frombuffer(E.point_to_blob64((x, (y + 2) % 2**256)),
                        np.uint8)[None]
    for wire, want in (("x", True), ("xy", False)):
        got, plain = _scan_rows(lib, bad, [list(row.outputs)],
                                case.scan_key_blob, case.spend_blob, (),
                                wire)
        assert got.tolist() == plain.tolist() == [want]


def _corrupt_low(outputs, hi_only):
    """Each output with bits below the cut's top 32 / 16 / 8 flipped: a
    cut still flags the row, the exact wire does not."""
    low = {"hi32": 0x5A5A5A5A, "hi16": 0x5A5A5A5A5A5A,
           "hi8": 0x5A5A5A5A5A5A5A}[hi_only]
    return [[int(np.int64(v) ^ np.int64(low)) for v in o] for o in outputs]


@pytest.mark.parametrize("hi_only", ["hi32", "hi16", "hi8"])
def test_scan_row_hi_wires(lib, rows7, hi_only):
    """scan_row on a cut wire: the golden flags (hi16 / hi8 unfold the
    validity unit, y's parity bit included, from the packed plane), and on
    random rows the plain version's flags bit for bit, with outputs exact
    and with their bits below the cut corrupted, where every oracle match
    still flags."""
    for case in V.CASES:
        blobs = np.stack([np.frombuffer(r.tweak_blob, np.uint8)
                          for r in case.rows])
        for ladder in ("fixed", "wnaf"):
            got, _ = _scan_rows(lib, blobs, [r.outputs for r in case.rows],
                                case.scan_key_blob, case.spend_blob,
                                case.label_blobs, "x", ladder=ladder,
                                plain=False, hi_only=hi_only)
            want = [r.height in case.expected_heights for r in case.rows]
            assert got.tolist() == want, (case.name, ladder)
    (blobs, outputs, *keys), valid, want = rows7
    for outs in (outputs, _corrupt_low(outputs, hi_only)):
        got, plain = _scan_rows(lib, blobs, outs, *keys, "x", valid,
                                hi_only=hi_only)
        np.testing.assert_array_equal(got, plain)
        assert (got | ~want).all()                      # a superset
