"""Real-DuckDB execution of the `cudasp_scan` surface (counterpart of
cudasp_tpu/sql/duckdb_bridge.py).

When the `duckdb` package is importable, DuckDBEngine runs every
statement in a DuckDB connection and bridges `cudasp_scan(...)` calls
through this package: the call's input subquery runs in DuckDB, its rows
go to the port's api.scan as Python columns, and the matching (txid,
height, tweak_key) rows come back as a temporary table the rewritten
query selects from.

DuckDB's Python API cannot register table in-out functions, so the
bridge rewrites each cudasp_scan call site textually before execution.
The rewrite is call-shaped (balanced parentheses, aware of strings and
comments), not a full SQL parse.
"""

from __future__ import annotations

import re
from typing import List, Tuple

try:
    import duckdb
except ImportError:               # rewrite helpers stay importable/testable
    duckdb = None

from .engine import SQLError


_CALL_RE = re.compile(r"\bcudasp_scan\s*\(", re.IGNORECASE)


def _masked(sql: str) -> bytearray:
    """1 at every index inside a comment (-- to EOL, /* */) or a
    string/quoted-identifier literal. A cudasp_scan( inside any of these
    is SQL text, not a call."""
    n = len(sql)
    mask = bytearray(n)
    i = 0
    while i < n:
        two = sql[i:i + 2]
        if two == "--":
            j = sql.find("\n", i)
            j = n if j < 0 else j
        elif two == "/*":
            j = sql.find("*/", i + 2)
            if j < 0:
                raise SQLError("unterminated /* comment")
            j += 2
        elif sql[i] == "'":
            j = i + 1
            while j < n and sql[j] != "'":
                j += 2 if sql[j] == "\\" else 1
            j += 1
        elif sql[i] == '"':
            j = sql.find('"', i + 1)
            j = n if j < 0 else j + 1
        else:
            i += 1
            continue
        for t in range(i, min(j, n)):
            mask[t] = 1
        i = j
    return mask


def _find_calls(sql: str) -> List[Tuple[int, int]]:
    """(start, end) spans of cudasp_scan(...) calls, paren-balanced,
    skipping string literals, quoted identifiers, and comments (both in
    match detection and inside the balanced span)."""
    mask = _masked(sql)
    spans = []
    for m in _CALL_RE.finditer(sql):
        if mask[m.start()]:
            continue                      # inside a comment/string
        depth = 1
        i = m.end()
        while i < len(sql) and depth:
            if mask[i]:
                i += 1
                continue
            c = sql[i]
            if c == "(":
                depth += 1
            elif c == ")":
                depth -= 1
            i += 1
        if depth:
            raise SQLError("unbalanced parentheses in cudasp_scan call")
        spans.append((m.start(), i))
    return spans


def _split_args(body: str) -> List[str]:
    """Split a call body on top-level commas (string/paren/bracket aware)."""
    args, depth, start, i = [], 0, 0, 0
    while i < len(body):
        c = body[i]
        if c == "'":
            i += 1
            while i < len(body) and body[i] != "'":
                i += 2 if body[i] == "\\" else 1
        elif c in "([":
            depth += 1
        elif c in ")]":
            depth -= 1
        elif c == "," and depth == 0:
            args.append(body[start:i].strip())
            start = i + 1
        i += 1
    args.append(body[start:].strip())
    return args


class DuckDBEngine:
    """SQLEngine-compatible interface executing on a real DuckDB."""

    def __init__(self, scan_fn=None, default_config=None,
                 connection=None):
        if duckdb is None:
            raise ImportError("the duckdb package is required for "
                              "DuckDBEngine (pip install duckdb)")
        if scan_fn is None:
            from .. import api

            scan_fn = api.scan
        self._scan = scan_fn
        self._config = default_config
        self.con = connection or duckdb.connect()
        self._view_counter = 0

    def execute(self, sql: str):
        sql = self._rewrite_scans(sql)
        cur = self.con.execute(sql)
        try:
            return cur.fetchall()
        except duckdb.Error:
            return None

    # -- bridge ------------------------------------------------------------
    def _rewrite_scans(self, sql: str) -> str:
        while True:
            spans = _find_calls(sql)
            if not spans:
                return sql
            start, end = spans[0]
            body = sql[sql.index("(", start) + 1:end - 1]
            view = self._materialize(body)
            sql = sql[:start] + view + sql[end:]

    def _materialize(self, body: str) -> str:
        args = _split_args(body)
        named = {}
        positional = []
        for a in args:
            m = re.match(r"(\w+)\s*:=\s*(.+)$", a, re.DOTALL)
            if m:
                named[m.group(1).lower()] = m.group(2)
            else:
                positional.append(a)
        if len(positional) != 4:
            raise SQLError(
                f"cudasp_scan takes 4 positional arguments, got "
                f"{len(positional)}")
        table_sql, key_sql, spend_sql, labels_sql = positional

        # table_sql is a table name or a parenthesized subquery; both are
        # valid FROM items in DuckDB
        rows = self.con.execute(
            f"SELECT txid, height, tweak_key, outputs FROM {table_sql}"
        ).fetchall()
        table = {
            "txid": [r[0] if r[0] is None else bytes(r[0]) for r in rows],
            "height": [r[1] for r in rows],
            "tweak_key": [r[2] if r[2] is None else bytes(r[2])
                          for r in rows],
            "outputs": [r[3] for r in rows],
        }
        scan_key = self._eval_blob(key_sql)
        spend_key = self._eval_blob(spend_sql)
        labels = self._eval_blob_list(labels_sql)
        kwargs = {}
        if "batch_size" in named:
            kwargs["batch_size"] = int(
                self.con.execute(f"SELECT {named['batch_size']}")
                .fetchone()[0])
        res = self._scan(table, scan_key, spend_key, labels,
                         config=self._config, **kwargs)
        self._view_counter += 1
        view = f"__cudasp_scan_result_{self._view_counter}"
        txids = (list(res.txid) if res.txid is not None
                 else [None] * len(res.indices))
        heights = ([int(h) for h in res.height] if res.height is not None
                   else [None] * len(res.indices))
        tweaks = [bytes(bytearray(t)) for t in res.tweak_key] \
            if res.tweak_key is not None else [None] * len(res.indices)
        self.con.execute(
            f"CREATE OR REPLACE TEMP TABLE {view} "
            "(txid BLOB, height INTEGER, tweak_key BLOB)")
        if txids:
            self.con.executemany(
                f"INSERT INTO {view} VALUES (?, ?, ?)",
                list(zip(txids, heights, tweaks)))
        return view

    def _eval_blob(self, sql: str) -> bytes:
        return bytes(self.con.execute(f"SELECT {sql}").fetchone()[0])

    def _eval_blob_list(self, sql: str) -> List[bytes]:
        v = self.con.execute(f"SELECT {sql}").fetchone()[0]
        return [bytes(b) for b in (v or [])]
