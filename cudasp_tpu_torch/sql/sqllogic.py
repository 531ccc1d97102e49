"""sqllogictest runner (counterpart of cudasp_tpu/sql/sqllogic.py).

A minimal executor for the records of the reference system's SQL suite
(`require`, `statement ok`, `statement error`, `query <types>` with a
`----`-delimited expected result), so the same file drives this engine.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional


@dataclass
class Record:
    kind: str                  # "statement" | "query" | "require"
    sql: str = ""
    expected: Optional[List[str]] = None
    line: int = 0


@dataclass
class RunReport:
    statements: int = 0
    queries: int = 0
    failures: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures


def parse_script(text: str) -> List[Record]:
    lines = text.splitlines()
    records: List[Record] = []
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if not line or line.startswith("#"):
            i += 1
            continue
        start = i + 1
        if line.startswith("require"):
            records.append(Record("require", sql=line.split(None, 1)[1],
                                  line=start))
            i += 1
            continue
        if line.startswith("statement"):
            # "statement ok" | "statement error"
            expect_error = line.split()[1] == "error"
            i += 1
            sql_lines = []
            while i < len(lines) and lines[i].strip() \
                    and not lines[i].startswith("#"):
                sql_lines.append(lines[i])
                i += 1
            records.append(Record("statement_error" if expect_error
                                  else "statement",
                                  sql="\n".join(sql_lines), line=start))
            continue
        if line.startswith("query"):
            i += 1
            sql_lines = []
            while i < len(lines) and lines[i].strip() != "----":
                sql_lines.append(lines[i])
                i += 1
            if i >= len(lines):
                raise ValueError(f"query at line {start} has no ---- block")
            i += 1  # past ----
            expected = []
            while i < len(lines) and lines[i].strip():
                expected.append(lines[i].strip())
                i += 1
            records.append(Record("query", sql="\n".join(sql_lines),
                                  expected=expected, line=start))
            continue
        raise ValueError(f"unrecognized sqllogictest line {start}: {line!r}")
    return records


def _format_value(v) -> str:
    """DuckDB sqllogictest value formatting for the types this suite uses."""
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (bytes, bytearray)):
        return "".join(f"\\x{b:02X}" for b in v)
    return str(v)


def run_script(text: str, engine=None,
               transform: Optional[Callable[[str], str]] = None) -> RunReport:
    """Execute a sqllogictest script against `engine` (default: a fresh
    builtin SQLEngine). `transform` rewrites each statement's SQL before
    execution (used by tests to scale down row counts)."""
    if engine is None:
        from .engine import SQLEngine

        engine = SQLEngine()
    report = RunReport()
    for rec in parse_script(text):
        if rec.kind == "require":
            # the engine IS the cudasp extension; nothing to load
            continue
        sql = transform(rec.sql) if transform else rec.sql
        if rec.kind == "statement":
            try:
                engine.execute(sql)
                report.statements += 1
            except Exception as e:  # noqa: BLE001 — collected into report
                report.failures.append(
                    f"line {rec.line}: statement failed: {e}\n  {sql}")
            continue
        if rec.kind == "statement_error":
            try:
                engine.execute(sql)
                report.failures.append(
                    f"line {rec.line}: statement expected to fail but "
                    f"succeeded\n  {sql}")
            except Exception:  # noqa: BLE001 — expected
                report.statements += 1
            continue
        # query
        try:
            rows = engine.execute(sql) or []
        except Exception as e:  # noqa: BLE001 — collected into report
            report.failures.append(
                f"line {rec.line}: query failed: {e}\n  {sql}")
            continue
        got: List[str] = []
        for row in rows:
            for v in row:
                got.append(_format_value(v))
        if got != rec.expected:
            report.failures.append(
                f"line {rec.line}: expected {rec.expected}, got {got}\n"
                f"  {sql}")
        else:
            report.queries += 1
    return report


def run_file(path: str, engine=None,
             transform: Optional[Callable[[str], str]] = None) -> RunReport:
    with open(path, "r", encoding="utf-8") as f:
        return run_script(f.read(), engine=engine, transform=transform)
