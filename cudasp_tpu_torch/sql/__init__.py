"""SQL front end: the `cudasp_scan` table function (counterpart of
cudasp_tpu/sql/).

The reference system is one SQL object, the `cudasp_scan` table in-out
function of a DuckDB extension. This package gives that surface twice:

  * engine.SQLEngine: a self-contained interpreter for the dialect of the
    reference system's SQL test suite, with no third-party dependency;
  * duckdb_bridge.DuckDBEngine: the same statements run by a real DuckDB
    (where the `duckdb` package imports), with cudasp_scan(...) calls
    bridged into the port's scan.

sqllogic.run_file drives either engine through sqllogictest files. Both
engines run the port's scan on the card unless given another scan_fn.
"""

from .engine import SQLEngine, SQLError
from .sqllogic import run_file, run_script

__all__ = ["SQLEngine", "SQLError", "run_file", "run_script", "make_engine"]


def make_engine(kind: str = "auto", **kw):
    """kind: 'builtin' | 'duckdb' | 'auto' (duckdb where it imports). kw
    (scan_fn, default_config) go to the engine."""
    if kind in ("auto", "duckdb"):
        try:
            from .duckdb_bridge import DuckDBEngine

            return DuckDBEngine(**kw)
        except ImportError:
            if kind == "duckdb":
                raise
    return SQLEngine(**kw)
