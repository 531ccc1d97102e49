"""A self-contained SQL interpreter for the `cudasp_scan` table function
(counterpart of cudasp_tpu/sql/engine.py).

The dialect of the reference system's SQL test suite: CREATE TABLE,
INSERT ... VALUES, CREATE TABLE AS SELECT ... FROM range(N), SELECT over
cudasp_scan with BLOB literals, list literals, casts, WHERE comparisons,
COUNT(*) and the batch_size named parameter, with no third-party
dependency. Queries run the port's scan, on the card by default.

Not a general SQL database: unsupported syntax raises SQLError.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from ..runtime.errors import BindError, IngestError


class SQLError(Exception):
    """Statement could not be parsed or executed."""


# --------------------------------------------------------------------------
# Tokenizer
# --------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
      (?P<ws>\s+|--[^\n]*)
    | (?P<num>\d+)
    | (?P<str>'(?:[^'\\]|\\.)*')
    | (?P<id>[A-Za-z_][A-Za-z_0-9]*)
    | (?P<op>::|:=|<>|<=|>=|[(),\[\];*=<>.+\-])
    """,
    re.VERBOSE,
)


def tokenize(sql: str) -> List[Tuple[str, str]]:
    tokens: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SQLError(f"unexpected character {sql[pos]!r} at {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        tokens.append((kind, m.group()))
    tokens.append(("end", ""))
    return tokens


def _parse_blob_literal(raw: str) -> bytes:
    """DuckDB BLOB literal body: '\\x00\\x01...' with \\xNN escapes; other
    characters are their own bytes."""
    body = raw[1:-1]
    out = bytearray()
    i = 0
    while i < len(body):
        if body[i] == "\\" and i + 3 < len(body) + 1 and body[i + 1] in "xX":
            out.append(int(body[i + 2:i + 4], 16))
            i += 4
        elif body[i] == "\\" and i + 1 < len(body):
            out.append(ord(body[i + 1]))
            i += 2
        else:
            out.append(ord(body[i]))
            i += 1
    return bytes(out)


# --------------------------------------------------------------------------
# AST — small closed set of node types (plain tuples, dispatch on tag)
# --------------------------------------------------------------------------
# ("int", v) ("blob", bytes) ("str", s) ("list", [expr]) ("col", name)
# ("count_star",) ("cast", expr, type) ("neg", expr) ("cmp", op, l, r)
# ("select", items, source, where)   items: [(expr|"star", alias)]
# ("table", name) ("range", n) ("scan", table_expr, args, named)
#   args: positional exprs; named: {name: expr}


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    # -- token helpers ----------------------------------------------------
    def peek(self) -> Tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> Tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def kw(self, *words: str) -> bool:
        """Consume the identifier(s) if they match (case-insensitive)."""
        save = self.i
        for w in words:
            kind, val = self.peek()
            if kind == "id" and val.upper() == w:
                self.i += 1
            else:
                self.i = save
                return False
        return True

    def expect_kw(self, *words: str) -> None:
        if not self.kw(*words):
            raise SQLError(f"expected {' '.join(words)}, got "
                           f"{self.peek()[1]!r}")

    def op(self, symbol: str) -> bool:
        kind, val = self.peek()
        if kind == "op" and val == symbol:
            self.i += 1
            return True
        return False

    def expect_op(self, symbol: str) -> None:
        if not self.op(symbol):
            raise SQLError(f"expected {symbol!r}, got {self.peek()[1]!r}")

    def ident(self) -> str:
        kind, val = self.next()
        if kind != "id":
            raise SQLError(f"expected identifier, got {val!r}")
        return val

    # -- grammar ----------------------------------------------------------
    def statement(self):
        if self.kw("CREATE", "TABLE"):
            name = self.ident()
            if self.kw("AS"):
                return ("create_as", name, self.select())
            self.expect_op("(")
            cols = []
            while True:
                cname = self.ident()
                ctype = self.type_name()
                cols.append((cname, ctype))
                if not self.op(","):
                    break
            self.expect_op(")")
            return ("create", name, cols)
        if self.kw("INSERT", "INTO"):
            name = self.ident()
            self.expect_kw("VALUES")
            rows = []
            while True:
                self.expect_op("(")
                row = [self.expr()]
                while self.op(","):
                    row.append(self.expr())
                self.expect_op(")")
                rows.append(row)
                if not self.op(","):
                    break
            return ("insert", name, rows)
        if self.peek()[1].upper() == "SELECT":
            return self.select()
        if self.kw("DROP", "TABLE"):
            self.kw("IF", "EXISTS")
            return ("drop", self.ident())
        raise SQLError(f"unsupported statement starting at "
                       f"{self.peek()[1]!r}")

    def type_name(self) -> str:
        base = self.ident().upper()
        if self.op("["):
            self.expect_op("]")
            return base + "[]"
        return base

    def select(self):
        self.expect_kw("SELECT")
        items = []
        while True:
            if self.op("*"):
                items.append(("star", None))
            else:
                e = self.expr()
                alias = None
                if self.kw("AS"):
                    alias = self.ident()
                items.append((e, alias))
            if not self.op(","):
                break
        source = None
        if self.kw("FROM"):
            source = self.source()
        where = None
        if self.kw("WHERE"):
            where = self.expr()
        return ("select", items, source, where)

    def source(self):
        if self.op("("):
            inner = self.select()
            self.expect_op(")")
            return inner
        name = self.ident()
        if name.lower() == "range" and self.op("("):
            n = self.expr()
            self.expect_op(")")
            return ("range", n)
        if name.lower() == "cudasp_scan":
            self.expect_op("(")
            table_expr = self.scan_table_arg()
            args, named = [], {}
            while self.op(","):
                kind, val = self.peek()
                if (kind == "id"
                        and self.toks[self.i + 1][1] == ":="):
                    self.i += 2
                    named[val.lower()] = self.expr()
                else:
                    args.append(self.expr())
            self.expect_op(")")
            return ("scan", table_expr, args, named)
        return ("table", name)

    def scan_table_arg(self):
        """First cudasp_scan argument: a (SELECT ...) subquery or table."""
        if self.op("("):
            if self.peek()[1].upper() == "SELECT":
                inner = self.select()
                self.expect_op(")")
                return inner
            raise SQLError("expected SELECT subquery as cudasp_scan arg 1")
        return ("table", self.ident())

    def expr(self):
        e = self.comparison()
        return e

    def comparison(self):
        left = self.term()
        for sym, tag in (("=", "eq"), ("<>", "ne"), ("<=", "le"),
                         (">=", "ge"), ("<", "lt"), (">", "gt")):
            if self.op(sym):
                return ("cmp", tag, left, self.term())
        return left

    def term(self):
        e = self.primary()
        while self.op("::"):
            e = ("cast", e, self.type_name())
        return e

    def primary(self):
        kind, val = self.peek()
        if kind == "num":
            self.next()
            return ("int", int(val))
        if kind == "op" and val == "-":
            self.next()
            inner = self.term()
            return ("neg", inner)
        if kind == "str":
            self.next()
            return ("str", val[1:-1])
        if kind == "op" and val == "[":
            self.next()
            elems = []
            if not self.op("]"):
                elems.append(self.expr())
                while self.op(","):
                    elems.append(self.expr())
                self.expect_op("]")
            return ("list", elems)
        if kind == "id":
            upper = val.upper()
            if upper == "BLOB":
                self.next()
                k2, v2 = self.next()
                if k2 != "str":
                    raise SQLError("BLOB must be followed by a string "
                                   "literal")
                return ("blob", _parse_blob_literal(v2))
            if upper == "CAST":
                self.next()
                self.expect_op("(")
                inner = self.expr()
                self.expect_kw("AS")
                t = self.type_name()
                self.expect_op(")")
                return ("cast", inner, t)
            if upper == "COUNT":
                self.next()
                self.expect_op("(")
                self.expect_op("*")
                self.expect_op(")")
                return ("count_star",)
            if upper == "NULL":
                self.next()
                return ("null",)
            self.next()
            return ("col", val)
        if kind == "op" and val == "(":
            self.next()
            inner = self.expr()
            self.expect_op(")")
            return inner
        raise SQLError(f"unexpected token {val!r} in expression")


def parse_statement(sql: str):
    p = _Parser(tokenize(sql))
    stmt = p.statement()
    p.op(";")
    if p.peek()[0] != "end":
        raise SQLError(f"trailing tokens at {p.peek()[1]!r}")
    return stmt


# --------------------------------------------------------------------------
# Evaluation
# --------------------------------------------------------------------------

Table = Dict[str, list]


def _nrows(t: Table) -> int:
    return len(next(iter(t.values()))) if t else 0


class SQLEngine:
    """Executes the dialect against scan_fn (default: the port's
    api.scan, which runs on the card and raises without one).

    execute(sql) returns a list of row tuples for queries, None for
    DDL/DML statements. The scan's BindError and IngestError surface as
    SQLError.
    """

    def __init__(self, scan_fn=None, default_config=None):
        if scan_fn is None:
            from .. import api

            scan_fn = api.scan
        self._scan = scan_fn
        self._config = default_config
        self.tables: Dict[str, Table] = {}
        self.schemas: Dict[str, List[Tuple[str, str]]] = {}

    # -- public ------------------------------------------------------------
    def execute(self, sql: str) -> Optional[List[tuple]]:
        stmt = parse_statement(sql)
        tag = stmt[0]
        if tag == "create":
            _, name, cols = stmt
            self.tables[name.lower()] = {c: [] for c, _ in cols}
            self.schemas[name.lower()] = cols
            return None
        if tag == "create_as":
            _, name, sel = stmt
            self.tables[name.lower()] = self._eval_select_table(sel)
            return None
        if tag == "drop":
            self.tables.pop(stmt[1].lower(), None)
            return None
        if tag == "insert":
            _, name, rows = stmt
            table = self.tables.get(name.lower())
            if table is None:
                raise SQLError(f"no such table {name}")
            cols = list(table.keys())
            for row in rows:
                if len(row) != len(cols):
                    raise SQLError(
                        f"INSERT arity {len(row)} != {len(cols)} columns")
                for c, e in zip(cols, row):
                    table[c].append(self._eval(e, None))
            return None
        if tag == "select":
            t = self._eval_select_table(stmt)
            cols = list(t.keys())
            n = _nrows(t)
            return [tuple(t[c][i] for c in cols) for i in range(n)]
        raise SQLError(f"unhandled statement {tag}")

    # -- select ------------------------------------------------------------
    def _eval_select_table(self, sel) -> Table:
        _, items, source, where = sel
        src = self._eval_source(source)
        if where is not None:
            n = _nrows(src)
            keep = [i for i in range(n)
                    if self._eval_row(where, src, i)]
            src = {c: [v[i] for i in keep] for c, v in src.items()}
        n = _nrows(src)
        if any(e != "star" and e[0] == "count_star" for e, _ in items):
            if len(items) != 1:
                raise SQLError("COUNT(*) must be the only select item")
            return {"count": [n]}
        out: Table = {}
        for k, (e, alias) in enumerate(items):
            if e == "star":
                out.update({c: list(v) for c, v in src.items()})
                continue
            name = alias or (e[1] if e[0] == "col" else f"col{k}")
            out[name] = [self._eval_row(e, src, i) for i in range(n)]
        return out

    def _eval_source(self, source) -> Table:
        if source is None:
            return {"": [None]}      # SELECT <constants> with no FROM
        tag = source[0]
        if tag == "table":
            t = self.tables.get(source[1].lower())
            if t is None:
                raise SQLError(f"no such table {source[1]}")
            return t
        if tag == "range":
            n = self._eval(source[1], None)
            return {"range": list(range(n))}
        if tag == "select":
            return self._eval_select_table(source)
        if tag == "scan":
            return self._eval_scan(source)
        raise SQLError(f"unhandled source {tag}")

    def _eval_scan(self, node) -> Table:
        _, table_expr, args, named = node
        src = self._eval_source(table_expr)
        for required in ("txid", "height", "tweak_key", "outputs"):
            if required not in src:
                raise SQLError(
                    f"cudasp_scan input is missing column '{required}'")
        if len(args) != 3:
            raise SQLError(
                f"cudasp_scan takes (table, scan_key, spend_key, labels); "
                f"got {1 + len(args)} arguments")
        scan_key = self._eval(args[0], None)
        spend_key = self._eval(args[1], None)
        labels = self._eval(args[2], None)
        if not isinstance(labels, list):
            raise SQLError("label_keys argument must be a list of BLOBs")
        kwargs = {}
        if "batch_size" in named:
            kwargs["batch_size"] = self._eval(named["batch_size"], None)
        unknown = set(named) - {"batch_size"}
        if unknown:
            raise SQLError(f"unknown named parameter(s): {sorted(unknown)}")
        table = {
            "txid": src["txid"],
            "height": src["height"],
            "tweak_key": src["tweak_key"],
            "outputs": src["outputs"],
        }
        try:
            res = self._scan(table, bytes(scan_key), bytes(spend_key),
                             [bytes(b) for b in labels],
                             config=self._config, **kwargs)
        except (BindError, IngestError) as e:
            raise SQLError(str(e)) from e
        return {
            "txid": list(res.txid) if res.txid is not None else
                    [None] * len(res.indices),
            "height": [int(h) for h in res.height]
                      if res.height is not None else
                      [None] * len(res.indices),
            "tweak_key": [bytes(bytearray(t)) for t in res.tweak_key]
                         if res.tweak_key is not None else
                         [None] * len(res.indices),
        }

    # -- expressions -------------------------------------------------------
    def _eval_row(self, e, src: Table, i: int):
        tag = e[0]
        if tag == "col":
            name = e[1]
            for c in src:
                if c.lower() == name.lower():
                    return src[c][i]
            raise SQLError(f"no such column {name}")
        if tag == "cmp":
            _, op, l, r = e
            lv = self._eval_row(l, src, i)
            rv = self._eval_row(r, src, i)
            return {"eq": lv == rv, "ne": lv != rv, "lt": lv < rv,
                    "gt": lv > rv, "le": lv <= rv, "ge": lv >= rv}[op]
        if tag == "list":
            return [self._eval_row(x, src, i) for x in e[1]]
        if tag == "cast":
            return _apply_cast(self._eval_row(e[1], src, i), e[2])
        if tag == "neg":
            return -self._eval_row(e[1], src, i)
        return self._eval(e, None)

    def _eval(self, e, _ctx):
        tag = e[0]
        if tag == "int":
            return e[1]
        if tag == "neg":
            return -self._eval(e[1], None)
        if tag == "blob":
            return e[1]
        if tag == "str":
            return e[1]
        if tag == "null":
            return None
        if tag == "list":
            return [self._eval(x, None) for x in e[1]]
        if tag == "cast":
            return _apply_cast(self._eval(e[1], None), e[2])
        if tag == "col":
            raise SQLError(f"column {e[1]} referenced outside a row "
                           "context")
        raise SQLError(f"cannot evaluate {tag} as a constant")


def _apply_cast(v, t: str):
    t = t.upper()
    if t in ("BIGINT", "INTEGER", "INT"):
        return int(v)
    if t == "BLOB":
        return bytes(v)
    if t.endswith("[]"):
        if not isinstance(v, list):
            raise SQLError(f"cannot cast {type(v).__name__} to {t}")
        return [_apply_cast(x, t[:-2]) for x in v]
    raise SQLError(f"unsupported cast target {t}")
