"""The port's SQL front end (cudasp_tpu_torch.sql) against the JAX
package's (cudasp_tpu.sql) on the CPU: the tokenizer and parser on a
corpus of the dialect, both engines on one stub scan (the same rows and
the same SQLError messages), a golden sqllogictest script end to end
(port engine + port scan against JAX engine + JAX scan), the DuckDB
bridge's rewrite helpers, and make_engine without duckdb."""

import functools

import numpy as np
import pytest
import torch

from cudasp_tpu.oracle import vectors as JV
from cudasp_tpu.runtime import errors as JERR
from cudasp_tpu.sql import SQLEngine as JEngine
from cudasp_tpu.sql import duckdb_bridge as JB
from cudasp_tpu.sql import engine as JENG
from cudasp_tpu.sql import sqllogic as JL

import cudasp_tpu_torch as ct
from cudasp_tpu_torch.runtime import errors as TERR
from cudasp_tpu_torch.sql import SQLEngine, SQLError, make_engine
from cudasp_tpu_torch.sql import duckdb_bridge as TB
from cudasp_tpu_torch.sql import engine as TENG
from cudasp_tpu_torch.sql import sqllogic as TL

K32 = "BLOB '" + r"\x11" * 32 + "'"
K64 = "BLOB '" + r"\x22" * 64 + "'"
SCAN = ("cudasp_scan((SELECT txid, height, tweak_key, outputs FROM d), "
        f"{K32}, {K64}, CAST([] AS BLOB[])")

CORPUS = [
    "CREATE TABLE d(txid BLOB, height INTEGER, tweak_key BLOB, "
    "outputs BIGINT[])",
    "CREATE TABLE r AS SELECT 3 AS x, [1::BIGINT] AS l FROM range(5)",
    "CREATE TABLE b AS SELECT BLOB '\\xAA' AS txid, range AS height "
    "FROM range(10);",
    "INSERT INTO d VALUES (BLOB '\\x00\\x01', 7, BLOB 'ab', [1, -2, 3]), "
    "(NULL, 8, BLOB '\\xff', [])",
    "DROP TABLE IF EXISTS d",
    "DROP TABLE d",
    "SELECT COUNT(*) FROM d",
    "SELECT * FROM d WHERE height >= 7",
    "SELECT height AS h, txid FROM d WHERE txid <> BLOB '\\x00'",
    "SELECT CAST([] AS BLOB[])",
    "SELECT 5::BIGINT, -7, 'text', (3)",
    "SELECT x FROM (SELECT 1 AS x) WHERE x = 1 -- a comment",
    f"SELECT height FROM {SCAN}, batch_size := 50000)",
    f"SELECT COUNT(*) FROM {SCAN})",
    "SELECT * FROM cudasp_scan(d, BLOB '\\x01', BLOB '\\x02', "
    "[BLOB '\\x03', BLOB '\\x04'])",
    # errors: the same SQLError text from both parsers
    "SELECT FROM",
    "TRUNCATE t",
    "SELECT 1 2",
    "SELECT ?",
    "SELECT BLOB 5",
    "CREATE TABLE t(a INTEGER",
    "SELECT * FROM cudasp_scan(5, BLOB 'a')",
    "SELECT COUNT(x) FROM d",
]


def _same_outcome(fn_ours, fn_ref, arg):
    try:
        ref = ("ok", fn_ref(arg))
    except JENG.SQLError as e:
        ref = ("error", str(e))
    try:
        ours = ("ok", fn_ours(arg))
    except TENG.SQLError as e:
        ours = ("error", str(e))
    assert ours == ref, arg
    return ours


@pytest.mark.parametrize("sql", CORPUS)
def test_tokenizer_and_parser_same_as_jax(sql):
    _same_outcome(TENG.tokenize, JENG.tokenize, sql)
    _same_outcome(TENG.parse_statement, JENG.parse_statement, sql)


def _stub(errors):
    """A scan that matches the rows of even height, and checks key sizes
    with the given package's BindError."""
    calls = []

    def scan(table, key, spend, labels, config=None, batch_size=None):
        calls.append(batch_size)
        if len(key) != 32:
            raise errors.BindError("scan_private_key must be exactly 32 "
                                   "bytes")
        if batch_size is not None and batch_size <= 0:
            raise errors.BindError(f"batch_size must be in (0, 10000000], "
                                   f"got {batch_size}")
        h = np.asarray(table["height"], np.int64)
        idx = np.flatnonzero(h % 2 == 0)

        class Res:
            indices = idx
            txid = np.asarray(table["txid"], object)[idx]
            height = h[idx]
            tweak_key = np.stack([np.frombuffer(table["tweak_key"][i],
                                                np.uint8) for i in idx]) \
                if len(idx) else np.zeros((0, 64), np.uint8)
        return Res

    scan.calls = calls
    return scan


STUB_SCRIPT = [
    "CREATE TABLE d(txid BLOB, height INTEGER, tweak_key BLOB, "
    "outputs BIGINT[])",
    "INSERT INTO d VALUES " + ", ".join(
        f"(BLOB '\\x{i:02x}', {i}, BLOB '" + f"\\x{i:02x}" * 64
        + f"', [{i}, -{i}])" for i in range(6)),
    "CREATE TABLE big AS SELECT BLOB '\\x07' AS txid, range AS height, "
    "BLOB '" + "\\x09" * 64 + "' AS tweak_key, [1, 2] AS outputs "
    "FROM range(40)",
    f"SELECT * FROM {SCAN})",
    f"SELECT height FROM {SCAN}, batch_size := 3)",
    f"SELECT COUNT(*) FROM {SCAN})",
    "SELECT height, tweak_key FROM cudasp_scan((SELECT * FROM big), "
    f"{K32}, {K64}, []) WHERE height > 30",
    "SELECT COUNT(*) FROM cudasp_scan(big, " f"{K32}, {K64}, [])",
]
STUB_ERRORS = [
    "SELECT * FROM nope",
    "INSERT INTO d VALUES (1, 2)",
    "INSERT INTO nope VALUES (1)",
    f"SELECT * FROM cudasp_scan((SELECT * FROM d), BLOB '\\x01', {K64}, [])",
    f"SELECT * FROM {SCAN}, batch_size := 0)",
    f"SELECT * FROM {SCAN}, bogus := 1)",
    f"SELECT * FROM cudasp_scan((SELECT height FROM d), {K32}, {K64}, [])",
    f"SELECT * FROM cudasp_scan((SELECT * FROM d), {K32}, {K64})",
    f"SELECT * FROM cudasp_scan((SELECT * FROM d), {K32}, {K64}, 5)",
    "SELECT COUNT(*), height FROM d",
    "SELECT x",
    "SELECT a FROM d",
    "SELECT 1::FLOAT",
]


def test_engines_on_one_stub_scan_same_rows_and_errors():
    ours_scan, ref_scan = _stub(TERR), _stub(JERR)
    ours, ref = SQLEngine(scan_fn=ours_scan), JEngine(scan_fn=ref_scan)
    for sql in STUB_SCRIPT:
        assert ours.execute(sql) == ref.execute(sql), sql
    assert ours_scan.calls == ref_scan.calls == [None, 3, None, None, None]
    for sql in STUB_ERRORS:
        with pytest.raises(JENG.SQLError) as r:
            ref.execute(sql)
        with pytest.raises(SQLError) as o:
            ours.execute(sql)
        assert str(o.value) == str(r.value), sql
    assert ours.tables == ref.tables


def _fmt(b):
    return "".join(f"\\x{v:02X}" for v in b)


def _golden_script():
    """Every golden case as sqllogictest records: its table by CREATE and
    INSERT, then its matches' height, txid and tweak_key (the wrong-key
    cases: none); for the first case also COUNT(*) and a WHERE filter
    over the scan."""
    out = []
    for k, case in enumerate(JV.CASES):
        t = f"g{k}"

        def blob(b):
            return "BLOB '" + "".join(f"\\x{v:02x}" for v in b) + "'"

        out += ["statement ok",
                f"CREATE TABLE {t}(txid BLOB, height INTEGER, tweak_key "
                "BLOB, outputs BIGINT[])", "",
                "statement ok",
                f"INSERT INTO {t} VALUES " + ", ".join(
                    f"({blob(r.txid)}, {r.height}, {blob(r.tweak_blob)}, "
                    f"[{', '.join(map(str, r.outputs))}])"
                    for r in case.rows), ""]
        scan = (f"cudasp_scan((SELECT * FROM {t}), {blob(case.scan_key_blob)}"
                f", {blob(case.spend_blob)}, ["
                + ", ".join(blob(lb) for lb in case.label_blobs) + "])")
        rows = [r for h in case.expected_heights for r in case.rows
                if r.height == h]
        out += ["query III", f"SELECT height, txid, tweak_key FROM {scan}",
                "----"]
        out += [v for r in rows
                for v in (str(r.height), _fmt(r.txid), _fmt(r.tweak_blob))]
        out.append("")
        if k == 0:
            out += ["query I", f"SELECT COUNT(*) FROM {scan}", "----",
                    str(len(rows)), "",
                    "query I", f"SELECT height FROM {scan} WHERE height = "
                    f"{rows[0].height}", "----", str(rows[0].height), ""]
    return "\n".join(out)


def test_golden_script_end_to_end_same_as_jax():
    """Port engine + port scan (plain version) against JAX engine + JAX
    scan, on the same sqllogictest script: both pass every record."""
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        script = _golden_script()
        ours = TL.run_script(script, engine=SQLEngine(
            scan_fn=functools.partial(ct.scan, device="cpu"),
            default_config=ct.ScanConfig(block_rows=32)))
        ref = JL.run_script(script, engine=JEngine())
    finally:
        torch.set_num_threads(torch_threads)
    assert ours.ok, ours.failures
    assert ref.ok, ref.failures
    assert (ours.statements, ours.queries) == (ref.statements, ref.queries)
    assert ours.queries == len(JV.CASES) + 2


def test_sqllogic_parser_same_as_jax():
    script = _golden_script() + "\n\nrequire cudasp\n\nstatement error\n" \
        "SELECT * FROM nope\n"
    assert [vars(r) for r in TL.parse_script(script)] == \
        [vars(r) for r in JL.parse_script(script)]
    for v in (None, True, False, b"\x00\xab", 7, "x"):
        assert TL._format_value(v) == JL._format_value(v)


BRIDGE = [
    f"SELECT * FROM {SCAN})",
    "SELECT a FROM cudasp_scan((SELECT * FROM t WHERE f(x, y) = 1), "
    "'\\x01', '\\x02', ['a,b', 'c'], batch_size := 5) JOIN "
    "cudasp_scan(t, k, s, [])",
    "-- cudasp_scan(commented, out)\nSELECT 1",
    "SELECT 'cudasp_scan(in a string)' /* cudasp_scan(x) */",
    "SELECT \"cudasp_scan(\" FROM CUDASP_SCAN (t, k, s, l)",
    "SELECT cudasp_scan(t, k",
    "SELECT 1 /* open",
]


@pytest.mark.parametrize("sql", BRIDGE)
def test_bridge_helpers_same_as_jax(sql):
    def calls(mod):
        spans = mod._find_calls(sql)
        return spans, [mod._split_args(sql[sql.index("(", a) + 1:b - 1])
                       for a, b in spans], bytes(mod._masked(sql))

    _same_outcome(lambda _: calls(TB), lambda _: calls(JB), None)


def test_make_engine_builtin_without_duckdb():
    assert TB.duckdb is None
    eng = make_engine("auto")
    assert type(eng) is SQLEngine
    assert type(make_engine("builtin", scan_fn=len)) is SQLEngine
    with pytest.raises(ImportError, match="duckdb"):
        make_engine("duckdb")
