"""The scan kernel's field product and square (csrc/secp256k1.cuh): fe_mul
and fe_sqr, written over carry chains that are inline PTX on the card and
uint64_t code on the host. The host build (host_check.cpp under g++)
checks the algorithms against Python integers and against the JAX
package's field ops; the PTX text of every carry chain is read out of the
header and run by a small emulator of the PTX instructions it uses, and
held to the chain's host form and to Python integers. The plain version's
product counter counts squares apart (the bound prices them lower)."""

import ctypes
import os
import re
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from cudasp_tpu.ops import field as JF

from cudasp_tpu_torch.io import ingest as TI
from cudasp_tpu_torch.ops import field as TF
from cudasp_tpu_torch.ops import kernels as TK
from cudasp_tpu_torch.oracle import vectors as V

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cudasp_tpu_torch", "csrc")
P = TF.P_INT
M32 = 0xFFFFFFFF
W256 = 2**256
FOLD = 0x1000003D1            # 2^256 mod p = 2^32 + 977


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread each keeps them from oversubscribing the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the kernel's host check"
    so = tmp_path_factory.mktemp("fieldprod") / "libhostcheck.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
                    "-Werror", "-I", CSRC, "-o", str(so),
                    os.path.join(CSRC, "host_check.cpp")], check=True,
                   capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    vp, u32, ci = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int
    sigs = {"sp_fe_mul": ([vp] * 3, None), "sp_fe_sqr": ([vp] * 2, None),
            "sp_fe_add": ([vp] * 3, None), "sp_fe_sub": ([vp] * 3, None),
            "sp_mad_pairs": ([ci, vp, vp, u32], None),
            "sp_add8": ([vp, vp], u32), "sp_add8c": ([vp, vp, u32], u32),
            "sp_sub8": ([vp, vp], u32),
            "sp_add3_8": ([vp, u32, u32, u32], u32),
            "sp_sub2_8": ([vp, u32, u32], u32),
            "sp_add2_3": ([vp, u32, u32], None),
            "sp_sub2_3": ([vp, u32, u32], None)}
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def _fe_call(fn, *vals):
    args = [np.ascontiguousarray(TF.int_to_words(v)) for v in vals]
    out = np.zeros(8, np.uint32)
    fn(*(a.ctypes.data for a in args), out.ctypes.data)
    return TF.words_to_int(out)


# crafted values: the edges of p and of 2^256, all-ones and all-zero
# halves, multiples of 2^32 + 977, and other values in [p, 2^256)
CRAFTED = [0, 1, 2, 3, 977, FOLD, P - 1, P, P + 1, P + 2, P + 976,
           W256 - 1, W256 - 2, W256 - 2**32, P + 0x12345, 2**255,
           2**255 - 1, 2**128 - 1, W256 - 2**128, 2**128,
           (2**128 - 1) << 64, 2**224 - 1, M32 << 224, FOLD * 7,
           FOLD * (2**200 + 12345), FOLD * ((W256 - 1) // FOLD),
           (P + W256) // 2, 0x5555555555555555 * (2**192 + 2**128 + 2**64
                                                  + 1),
           0xAAAAAAAAAAAAAAAA * (2**192 + 2**128 + 2**64 + 1),
           int("7" * 64, 16)]
WORD_PICKS = (0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, M32)


def _biased_words(rng, n):
    """(n, 8) uint32 words, each one of WORD_PICKS or uniform."""
    pick = rng.integers(0, len(WORD_PICKS) + 1, size=(n, 8))
    uni = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64)
    w = np.where(pick < len(WORD_PICKS),
                 np.asarray(WORD_PICKS + (0,), np.uint64)[pick], uni)
    return w.astype(np.uint32)


def _biased_values(seed, n):
    return [TF.words_to_int(w) for w in _biased_words(
        np.random.default_rng(seed), n)]


RANDOM_PAIRS = 2000


@pytest.fixture(scope="module")
def random_pairs():
    a = _biased_values(11, RANDOM_PAIRS)
    b = _biased_values(12, RANDOM_PAIRS)
    return a, b


def test_crafted_values_are_distinct_and_in_range():
    assert len(set(CRAFTED)) == len(CRAFTED) == 30
    assert all(0 <= v < W256 for v in CRAFTED)
    assert sum(v >= P for v in CRAFTED) >= 10


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub"])
def test_crafted_pairs_against_python_ints(lib, op):
    """Every pair of crafted values (every value for sqr): the value mod p
    and an output below 2^256."""
    for a in CRAFTED:
        for b in (CRAFTED if op != "sqr" else (a,)):
            if op == "sqr":
                got, want = _fe_call(lib.sp_fe_sqr, a), a * a
            else:
                got = _fe_call(getattr(lib, f"sp_fe_{op}"), a, b)
                want = {"mul": a * b, "add": a + b, "sub": a - b}[op]
            assert got < W256 and got % P == want % P, (op, hex(a), hex(b))


@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_random_edge_biased_pairs_against_python_ints(lib, random_pairs, op):
    for a, b in zip(*random_pairs):
        if op == "sqr":
            got, want = _fe_call(lib.sp_fe_sqr, a), a * a % P
        else:
            got, want = _fe_call(lib.sp_fe_mul, a, b), a * b % P
        assert got < W256 and got % P == want, (op, hex(a), hex(b))


def test_sqr_equals_mul_by_itself(lib, random_pairs):
    """fe_sqr(a) is fe_mul(a, a) word for word (the same 512-bit square,
    the same reduction), on the crafted and the random values."""
    for a in CRAFTED + random_pairs[0]:
        s = _fe_call(lib.sp_fe_sqr, a)
        assert s == _fe_call(lib.sp_fe_mul, a, a) and s < W256


@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_same_values_as_the_jax_field(lib, random_pairs, op):
    """The crafted pairs (each crafted value against the reversed list)
    and the random pairs, through the JAX package's field ops on 13-bit
    limbs: canonical values equal."""
    a = CRAFTED + random_pairs[0]
    b = CRAFTED[::-1] + random_pairs[1]
    ja = np.stack([JF.int_to_limbs(v) for v in a], axis=1)
    jb = np.stack([JF.int_to_limbs(v) for v in b], axis=1)
    if op == "sqr":
        out = jax.jit(lambda x: JF.canonical(JF.sqr(x)))(ja)
        got = [_fe_call(lib.sp_fe_sqr, x) for x in a]
    else:
        out = jax.jit(lambda x, y: JF.canonical(JF.mul(x, y)))(ja, jb)
        got = [_fe_call(lib.sp_fe_mul, x, y) for x, y in zip(a, b)]
    out = np.asarray(out)
    want = [JF.limbs_to_int(out[:, j]) for j in range(out.shape[1])]
    assert [g % P for g in got] == want


# ---------------------------------------------------------------------------
# The carry chains' PTX, emulated
# ---------------------------------------------------------------------------


def _split_top(body, sep=":"):
    """body split at `sep` outside string literals."""
    parts, cur, in_str, esc = [], "", False, False
    for ch in body:
        if in_str:
            cur += ch
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
        elif ch == '"':
            in_str, cur = True, cur + ch
        elif ch == sep:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    return parts + [cur]


def _ptx_blocks():
    """{chain name: (instructions, [(constraint, expr)] operands)} for
    every asm block of secp256k1.cuh; mad_pairs' blocks are named by
    their pair count."""
    with open(os.path.join(CSRC, "secp256k1.cuh")) as f:
        text = f.read()
    blocks = {}
    for m in re.finditer(r"asm volatile\((.*?)\);", text, re.S):
        before = text[:m.start()]
        name = re.findall(r"SP_INLINE \w+ (\w+)\(", before)[-1]
        if name == "mad_pairs":        # one block per N, in order 1..4
            name += str(1 + sum(k.startswith(name) for k in blocks))
        tmpl, outs, ins = _split_top(m.group(1))
        code = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', tmpl))
        code = code.replace("\\n", " ").replace("\\t", " ")
        insns = [ln.strip() for ln in code.split(";") if ln.strip()]
        ops = re.findall(r'"([=+]?r)"\(([^)]*)\)', outs + "," + ins)
        assert name not in blocks, name
        blocks[name] = (insns, ops)
    return blocks


def _run_ptx(insns, ops, env):
    """Run the block on `env` (expr -> uint32 value for every "+r" and "r"
    operand); returns {expr: value} of the outputs. The carry flag starts
    undefined, and reading it before a write fails."""
    regs = []
    for cons, expr in ops:
        regs.append(None if cons == "=r" else env[expr])
    cf = None

    def val(tok):
        tok = tok.strip()
        if tok.startswith("%"):
            v = regs[int(tok[1:])]
            assert v is not None, f"{tok} read before it is written"
            return v
        return int(tok, 0) & M32

    def carry():
        assert cf is not None, "carry flag read before it is set"
        return cf

    for insn in insns:
        opc, rest = insn.split(None, 1)
        args = [a.strip() for a in rest.split(",")]
        d = int(args[0][1:])
        a, b = val(args[1]), val(args[2])
        parts = opc.split(".")
        base, cc = parts[0], "cc" in parts
        assert parts[-1] == "u32", insn
        if base in ("mad", "madc"):
            p = a * b
            s = ((p >> 32) if parts[1] == "hi" else (p & M32)) + val(args[3])
            if base == "madc":
                s += carry()
            new_cf = s >> 32
        elif base in ("add", "addc"):
            s = a + b + (carry() if base == "addc" else 0)
            new_cf = s >> 32
        elif base in ("sub", "subc"):
            s = a - b - (carry() if base == "subc" else 0)
            new_cf = 1 if s < 0 else 0
        else:
            raise AssertionError(f"unknown instruction {insn}")
        assert len(args) == (4 if base.startswith("mad") else 3), insn
        regs[d] = s & M32
        if cc:
            cf = new_cf
    return {expr: regs[k] for k, (cons, expr) in enumerate(ops)
            if cons != "r"}


def _arr(words):
    return np.ascontiguousarray(np.asarray(words, np.uint32))


def _val(words):
    return sum(int(w) << (32 * i) for i, w in enumerate(words))


def _words(v, n):
    return [(v >> (32 * i)) & M32 for i in range(n)]


def _chain_case(name, rng, lib):
    """One random case of a chain: (its operands by expression, its
    outputs by the host form, a check of the outputs against Python
    integers)."""
    w = [int(x) for x in _biased_words(rng, 4).reshape(-1)]
    if name.startswith("mad_pairs"):
        # r[2n], which takes the carry, holds a small value (0, 1 or 2)
        n = int(name[-1])
        r = w[:2 * n] + [int(rng.integers(0, 3))]
        x, y = w[8:8 + n], w[16]
        env = {f"r[{i}]": r[i] for i in range(2 * n + 1)}
        env.update({f"x[{k}]": x[k] for k in range(n)}, y=y)
        hr = _arr(r)
        lib.sp_mad_pairs(n, hr.ctypes.data, _arr(x).ctypes.data, y)
        host = {f"r[{i}]": int(hr[i]) for i in range(2 * n + 1)}

        def check(out):
            got = _val([out[f"r[{i}]"] for i in range(2 * n + 1)])
            assert got == _val(r) + sum(x[k] * y << (64 * k)
                                        for k in range(n))
        return env, host, check
    r, b = w[:8], w[8:16]
    env = {f"r[{i}]": r[i] for i in range(8)}
    hr = _arr(r)
    if name in ("add8", "add8c", "sub8"):
        env.update({f"b[{i}]": b[i] for i in range(8)})
        if name == "add8c":
            cin = int(rng.integers(0, 2))
            env["c"] = cin
            c = lib.sp_add8c(hr.ctypes.data, _arr(b).ctypes.data, cin)
            want = _val(r) + _val(b) + cin
        elif name == "add8":
            c = lib.sp_add8(hr.ctypes.data, _arr(b).ctypes.data)
            want = _val(r) + _val(b)
        else:
            c = lib.sp_sub8(hr.ctypes.data, _arr(b).ctypes.data)
            want = _val(r) - _val(b)
        key = "m" if name == "sub8" else "c"
        host = {**{f"r[{i}]": int(hr[i]) for i in range(8)}, key: c}

        def check(out):
            flag = out[key] & 1 if key == "m" else out[key]
            sign = -1 if key == "m" else 1
            got = _val([out[f"r[{i}]"] for i in range(8)])
            assert got + sign * (flag << 256) == want
        return env, host, check
    f = w[16:19]
    if name in ("add2_3", "sub2_3"):
        # only words 0..2 move, and the caller knows nothing leaves them
        r = r[:3]
        env = {f"r[{i}]": r[i] for i in range(3)}
        lo = _val(f[:2])
        if name == "add2_3" and _val(r) + lo >= 2**96:
            r[2] = 0
        if name == "sub2_3" and _val(r) < lo:
            r[2] = M32
        env = {f"r[{i}]": r[i] for i in range(3)}
        hr = _arr(r)
        getattr(lib, f"sp_{name}")(hr.ctypes.data, f[0], f[1])
        env.update(f0=f[0], f1=f[1])
        host = {f"r[{i}]": int(hr[i]) for i in range(3)}
        sign = 1 if name == "add2_3" else -1

        def check(out):
            got = _val([out[f"r[{i}]"] for i in range(3)])
            assert got == _val(r) + sign * lo
        return env, host, check
    if name == "add3_8":
        env.update(f0=f[0], f1=f[1], f2=f[2])
        c = lib.sp_add3_8(hr.ctypes.data, *f)
        host = {**{f"r[{i}]": int(hr[i]) for i in range(8)}, "c": c}

        def check(out):
            got = _val([out[f"r[{i}]"] for i in range(8)])
            assert got + (out["c"] << 256) == _val(r) + _val(f)
        return env, host, check
    assert name == "sub2_8", name
    env.update(f0=f[0], f1=f[1])
    m = lib.sp_sub2_8(hr.ctypes.data, f[0], f[1])
    host = {**{f"r[{i}]": int(hr[i]) for i in range(8)}, "m": m}

    def check(out):
        got = _val([out[f"r[{i}]"] for i in range(8)])
        assert got - ((out["m"] & 1) << 256) == _val(r) - _val(f[:2])
    return env, host, check


CHAINS = ["mad_pairs1", "mad_pairs2", "mad_pairs3", "mad_pairs4", "add8c",
          "add8", "sub8", "add3_8", "sub2_8", "add2_3", "sub2_3"]


def test_every_asm_block_is_a_checked_chain():
    """The header's inline PTX is exactly the carry chains checked below
    (a new asm block needs its own case here)."""
    assert sorted(_ptx_blocks()) == sorted(CHAINS)


@pytest.mark.parametrize("name", CHAINS)
def test_carry_chain_ptx_emulated(lib, name):
    """400 edge-biased cases of one chain: the PTX text, run by the
    emulator, gives the host form's words and carry, and both equal the
    chain's value on Python integers."""
    insns, ops = _ptx_blocks()[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    for _ in range(400):
        env, host, check = _chain_case(name, rng, lib)
        out = _run_ptx(insns, ops, env)
        if "m" in out:                 # the C side keeps the borrow bit
            out["m"] &= 1
        assert out == host, (name, env)
        check(out)


# ---------------------------------------------------------------------------
# The plain version's counts: products and squares apart
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ladder", ["fixed", "wnaf"])
def test_plain_version_counts_squares_apart(monkeypatch, ladder):
    """On golden case 0, PRODUCTS + SQUARES equals every multiplication
    the plain version makes (what PRODUCTS counted before squares were
    counted apart), and more than half of them are squares."""
    case = V.CASES[0]
    blobs = np.stack([np.frombuffer(r.tweak_blob, np.uint8)
                      for r in case.rows])
    flat = np.concatenate([np.asarray(r.outputs, np.int64)
                           for r in case.rows])
    offs = np.cumsum([0] + [len(r.outputs) for r in case.rows])
    b = next(TI.iter_packed(blobs, flat, offs, len(case.rows),
                            int(np.diff(offs).max())))
    planes = [torch.from_numpy(np.ascontiguousarray(p).view(np.int32))
              for p in TK.pack_batch_arrays(
                  b.tweak_blobs, b.row_valid, b.outputs_hi, b.outputs_lo,
                  b.outputs_valid, block_rows=32, wire="x")]
    sched, sp, lab, _ = TI.pack_query_keys(case.scan_key_blob,
                                           case.spend_blob,
                                           case.label_blobs)
    digits, _ = sched.operands(ladder)
    sp, lab = (torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
               for a in (sp, lab))
    calls = [0]
    inner = TF._mul

    def counted(a, b):
        calls[0] += a[..., 0].numel()
        return inner(a, b)

    monkeypatch.setattr(TF, "_mul", counted)
    TF.PRODUCTS[0] = TF.SQUARES[0] = 0
    flags = TK.scan_plain(*planes, digits, sp, lab, TK.comb_table("cpu"),
                          block_rows=32, wire="x", ladder=ladder)
    rows = {i for i, r in enumerate(case.rows)
            if r.height in case.expected_heights}
    got = TK.flags_to_bool(flags.numpy(), planes[0].shape[1])
    assert set(np.flatnonzero(got).tolist()) == rows
    assert TF.PRODUCTS[0] + TF.SQUARES[0] == calls[0] > 0
    assert TF.SQUARES[0] > TF.PRODUCTS[0] > 0


# ---------------------------------------------------------------------------
# probe.cu's field_kernel entry (chip_smoke.py's field-edges phase): its
# wrapper on the CPU runs the plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub"])
def test_field_op_plain_values(op):
    from cudasp_tpu_torch.ops import probes as TP

    a, b = CRAFTED, CRAFTED[::-1]
    x, y = (torch.from_numpy(np.ascontiguousarray(
        np.stack([TF.int_to_words(v) for v in vals], axis=1)).view(np.int32))
        for vals in (a, b))
    launches = TP.PROBES.field_launches
    out = TP.field_op(x, y, TP.FIELD_OPS.index(op)).numpy().view(np.uint32)
    got = [TF.words_to_int(out[:, j]) for j in range(out.shape[1])]
    want = [{"mul": u * v, "sqr": u * u, "add": u + v, "sub": u - v}[op] % P
            for u, v in zip(a, b)]
    assert got == want
    assert TP.PROBES.field_launches == launches
    with pytest.raises(ValueError):
        TP.field_op(x, y, len(TP.FIELD_OPS))
