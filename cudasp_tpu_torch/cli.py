"""Command line of the port (counterpart of cudasp_tpu/cli.py): the
`cudasp_scan` table function for users without a SQL engine, and the SQL
front end.

    python -m cudasp_tpu_torch scan --input txs.parquet \\
        --scan-key <64-hex LE scalar> --spend-key <128-hex LE point> \\
        [--label <128-hex LE point>]... [--batch-size N] \\
        [--device cuda|cpu] [--backend auto|pallas|xla] \\
        [--stream CHUNK_ROWS] [--out matches.parquet]
    python -m cudasp_tpu_torch sql [script.sql | suite.test] [-e STMT]...

The input table has the columns txid (binary), height (int), tweak_key
(64-byte binary, LE x || LE y) and outputs (list<int64>), in Parquet,
Arrow IPC / Feather or JSONL (by extension; pyarrow is imported only for
the first two). Matches go to stdout as JSONL, or to a Parquet / Feather
file. Scans run on the card (--device cuda, the default: the
hand-written kernel) and raise without one; --device cpu runs the
kernel's plain version. --backend xla runs the XLA-graph backend's
counterpart (ops/pipeline.py) on the same device instead.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time


def _read_key(spec: str, width: int, name: str) -> bytes:
    """Key argument: hex string, or @path to a raw-bytes / hex file."""
    if spec.startswith("@"):
        with open(spec[1:], "rb") as f:
            data = f.read()
        if len(data) == width:
            return data
        spec = data.decode().strip()
    spec = spec.removeprefix("0x")
    try:
        raw = bytes.fromhex(spec)
    except ValueError as e:
        raise SystemExit(f"{name}: not valid hex: {e}") from e
    if len(raw) != width:
        raise SystemExit(f"{name}: expected {width} bytes, got {len(raw)}")
    return raw


def _load_table(path: str):
    if path.endswith((".parquet", ".pq")):
        import pyarrow.parquet as pq

        return pq.read_table(path)
    if path.endswith((".arrow", ".feather", ".ipc")):
        import pyarrow.feather as feather

        return feather.read_table(path)
    if path.endswith((".jsonl", ".json")):
        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
        return {
            "txid": [bytes.fromhex(r["txid"]) if isinstance(r.get("txid"), str)
                     else r.get("txid") for r in rows],
            "height": [r.get("height") for r in rows],
            "tweak_key": [bytes.fromhex(r["tweak_key"]) for r in rows],
            "outputs": [r.get("outputs", []) for r in rows],
        }
    raise SystemExit(f"unsupported input format: {path} "
                     "(use .parquet/.arrow/.feather/.jsonl)")


def _write_result(res, out: str):
    import numpy as np

    n = len(res.indices)
    txid = res.txid if res.txid is not None else [None] * n
    height = res.height if res.height is not None else [None] * n
    if out == "-" or out is None:
        for i in range(n):
            t = txid[i]
            print(json.dumps({
                "row": int(res.indices[i]),
                "txid": bytes(t).hex() if t is not None else None,
                "height": int(height[i]) if height[i] is not None else None,
                "tweak_key": bytes(res.tweak_key[i]).hex(),
            }))
        return
    import pyarrow as pa

    table = pa.table({
        "txid": pa.array([bytes(t) if t is not None else None for t in txid],
                         pa.binary()),
        "height": pa.array([int(h) if h is not None else None for h in height],
                           pa.int32()),
        "tweak_key": pa.array([bytes(t) for t in np.asarray(res.tweak_key)],
                              pa.binary()),
    })
    if out.endswith((".parquet", ".pq")):
        import pyarrow.parquet as pq

        pq.write_table(table, out)
    else:
        import pyarrow.feather as feather

        feather.write_table(table, out)


def _sql(args) -> int:
    from .api import scan
    from .sql import make_engine, run_file

    engine = make_engine(args.engine,
                         scan_fn=functools.partial(scan, device=args.device))
    if args.script and args.script.endswith(".test"):
        report = run_file(args.script, engine=engine)
        for f in report.failures:
            print(f"FAIL {f}", file=sys.stderr)
        print(f"# {report.statements} statements, {report.queries} "
              f"queries, {len(report.failures)} failures", file=sys.stderr)
        return 1 if report.failures else 0
    statements = list(args.execute)
    if args.script:
        with open(args.script) as f:
            statements += [s for s in f.read().split(";") if s.strip()]
    elif not statements:
        statements = [s for s in sys.stdin.read().split(";") if s.strip()]
    for stmt in statements:
        rows = engine.execute(stmt)
        if rows is not None:
            for row in rows:
                print("\t".join(
                    v.hex() if isinstance(v, (bytes, bytearray)) else str(v)
                    for v in row))
    return 0


def _scan(args) -> int:
    from .api import ScanConfig, scan, scan_stream

    scan_key = _read_key(args.scan_key, 32, "--scan-key")
    spend_key = _read_key(args.spend_key, 64, "--spend-key")
    labels = [_read_key(s, 64, "--label") for s in args.label]
    cfg = ScanConfig(backend=args.backend, upload=args.upload,
                     ladder=args.ladder, static_key=args.static_key)
    if args.batch_size is not None:
        cfg.batch_size = args.batch_size
    if args.block_rows is not None:
        cfg.block_rows = args.block_rows
    if args.stream:
        if not args.input.endswith((".parquet", ".pq")):
            raise SystemExit("--stream requires a parquet input")
        import pyarrow.parquet as pq

        pf = pq.ParquetFile(args.input)
        t0 = time.time()
        res = scan_stream(pf.iter_batches(batch_size=args.stream), scan_key,
                          spend_key, labels, config=cfg, device=args.device)
        dt = time.time() - t0
    else:
        table = _load_table(args.input)
        t0 = time.time()
        res = scan(table, scan_key, spend_key, labels, config=cfg,
                   device=args.device)
        dt = time.time() - t0
    _write_result(res, args.out)
    if args.metrics and res.metrics is not None:
        m = res.metrics.as_dict()
        m["wall_seconds"] = round(dt, 3)
        print(json.dumps(m), file=sys.stderr)
    print(f"# {len(res)} matches in {dt:.2f}s", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="cudasp_tpu_torch",
        description="BIP-352 silent-payments scanner on an NVIDIA GPU")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("scan", help="scan a table for matches")
    sp.add_argument("--input", required=True,
                    help="table file (.parquet/.arrow/.feather/.jsonl)")
    sp.add_argument("--scan-key", required=True,
                    help="32-byte LE scalar: hex or @file")
    sp.add_argument("--spend-key", required=True,
                    help="64-byte LE point (x||y): hex or @file")
    sp.add_argument("--label", action="append", default=[],
                    help="64-byte LE label point (repeatable)")
    sp.add_argument("--batch-size", type=int, default=None)
    sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the hand-written kernel on the card (raises "
                         "without one); cpu: its plain version")
    sp.add_argument("--backend", default="auto",
                    choices=["auto", "pallas", "xla"],
                    help="auto and pallas run the hand-written kernel "
                         "(its plain version on --device cpu); xla runs the "
                         "XLA-graph backend's counterpart, torch tensor ops "
                         "on the literal (x, y), on the same device")
    sp.add_argument("--upload", default="auto",
                    choices=["auto", "full64", "full", "hi32", "hi16",
                             "hi8"],
                    help="batch wire: auto picks per batch from the link "
                         "rate and the kernel time measured on the card; "
                         "full64 ships the 64-byte point, hi8/hi16/hi32 "
                         "prefilter words and an exact pass")
    sp.add_argument("--ladder", default="auto",
                    choices=["auto", "fixed", "wnaf"],
                    help="scalar-ladder schedule (auto = fixed)")
    sp.add_argument("--static-key", action="store_true",
                    help="build the scan key's schedule into a kernel of "
                         "its own (one nvcc build per key, cached on disk)")
    sp.add_argument("--block-rows", type=int, default=None,
                    help="rows per block-skip tile (default: the "
                         "device's row in runtime.tuning)")
    sp.add_argument("--out", default="-",
                    help="output file (.parquet/.feather) or '-' for JSONL")
    sp.add_argument("--metrics", action="store_true",
                    help="print scan metrics to stderr")
    sp.add_argument("--stream", type=int, default=0, metavar="CHUNK_ROWS",
                    help="stream the input in CHUNK_ROWS-row chunks with "
                         "bounded host memory (parquet only)")

    sq = sub.add_parser(
        "sql", help="run SQL (the cudasp_scan dialect) from a file, a -e "
                    "statement, or stdin; .test files run as sqllogictest")
    sq.add_argument("script", nargs="?",
                    help="SQL script or sqllogictest .test file "
                         "(default: read statements from stdin)")
    sq.add_argument("-e", "--execute", action="append", default=[],
                    help="execute this statement (repeatable)")
    sq.add_argument("--engine", default="auto",
                    choices=["auto", "builtin", "duckdb"],
                    help="duckdb = bridge through a real DuckDB when the "
                         "package is importable")
    sq.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where cudasp_scan runs (as for scan)")

    args = ap.parse_args(argv)
    return _sql(args) if args.cmd == "sql" else _scan(args)


if __name__ == "__main__":
    sys.exit(main())
