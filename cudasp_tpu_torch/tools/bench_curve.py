"""The bench curve (counterpart of the JAX package's tools/bench_curve.py):
the port's bench (tools/bench.py) at the reference's published sizes,
1,000,000, 9,400,000 and 32,700,000 rows, plus 1,000,000 rows with one
label. Each point runs in a fresh `python -m cudasp_tpu_torch.tools.bench`
process (--no-kernel-only above 4,000,000 rows: the kernel is measured at
the 1M point), at the bench's default batch size. The records merge into
--out, by default build/cudasp_tpu_torch/bench_curve.json.

    python -m cudasp_tpu_torch.tools.bench_curve
        [--points 1000000 9400000 32700000] [--labeled-rows 1000000]
        [--out PATH] [--device cuda|cpu]

Each record is the bench's JSON line, plus `labels`, `vs_reference_point`
(against the upstream GPU extension's published tx/s at that size),
`engine` and `runs` (each timed run's `# run` line from the bench's
stderr: pack, H2D and device-wait seconds, batches, launch rows). A point
whose process fails keeps an {"error": ...} record, and the tool then
exits 1. Merge (merge()): the best value per (rows, labels) of the same
engine; after an engine change the new record replaces the old one,
which goes into its `history`; points not re-run stay.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

from ..io import native
from ..ops import kernels as K

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)

REFERENCE = {                     # rows -> the upstream extension's tx/s
    1_000_000: 1_989_401.0,
    2_300_000: 2_265_266.0,
    5_000_000: 2_198_706.0,
    9_400_000: 2_596_475.0,
    32_700_000: 2_622_216.0,
}
# the Python sources of the timed path: the scan API, the ingest, the
# executor and the kernels' wrappers
TIMED_PY = ("api.py", "ops", "io", "runtime")
DEFAULT_OUT = os.path.join(K._BUILD_ROOT, "bench_curve.json")


def engine_id():
    """Identity of the code a point times: the build digests of the scan
    library (csrc/scan.cu and its headers) and of the C packer
    (csrc/pack.cpp), a digest of the timed path's Python sources
    (TIMED_PY), and git HEAD for a reader. `src`, over the three digests,
    decides whether two records are of the same engine."""
    scan = K.library_digest(K._SOURCES)
    pack = os.path.basename(os.path.dirname(native.library_path()))
    h = hashlib.sha256()
    for top in TIMED_PY:
        path = os.path.join(PKG, top)
        files = [path] if top.endswith(".py") else sorted(
            os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs
            if f.endswith(".py"))
        for f in files:
            h.update(os.path.relpath(f, PKG).encode())
            with open(f, "rb") as fh:
                h.update(fh.read())
    py = h.hexdigest()[:16]
    head = ""
    try:
        head = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=ROOT,
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    src = hashlib.sha256(f"{scan} {pack} {py}".encode()).hexdigest()[:16]
    return {"src": src, "scan_library": scan, "packer": pack, "python": py,
            "git": head}


def run_point(rows, labels=0, repeats=3, device="cuda"):
    """One point's record, from a fresh bench process."""
    cmd = [sys.executable, "-m", "cudasp_tpu_torch.tools.bench",
           "--rows", str(rows), "--repeats", str(repeats),
           "--device", device]
    if labels:
        cmd += ["--labels", str(labels)]
    if rows > 4_000_000:
        cmd += ["--no-kernel-only"]          # measured at the 1M point
    print(f"# running: {' '.join(cmd)}", file=sys.stderr, flush=True)
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
    sys.stderr.write(out.stderr[-2000:])
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    rec = json.loads(line[-1]) if line else {"error": out.stderr[-500:]}
    if out.returncode and "error" not in rec:
        rec["error"] = f"exit {out.returncode}: {out.stderr[-500:]}"
    rec["labels"] = labels
    rec["runs"] = [json.loads(ln[len("# run "):])
                   for ln in out.stderr.splitlines()
                   if ln.startswith("# run {")]
    ref = REFERENCE.get(rows)
    if ref and "value" in rec:
        rec["vs_reference_point"] = rec["value"] / ref
    return rec


def load(path):
    """The records of a curve file; none if it is missing or unreadable."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return []


def merge(records, old, engine):
    """This run's records merged with the file's (`old`): per (rows,
    labels), the best value of the same engine (engine["src"]); after an
    engine change this run's record, with the old one appended to its
    `history`; old points not re-run are kept, after this run's."""
    old = {(r.get("rows"), r.get("labels", 0)): r for r in old}
    merged = []
    for rec in records:
        key = (rec.get("rows"), rec.get("labels", 0))
        prev = old.pop(key, None)
        if prev is None:
            merged.append(rec)
            continue
        same_engine = prev.get("engine", {}).get("src") == engine["src"]
        if same_engine and prev.get("value", 0) > rec.get("value", 0):
            print(f"# keeping previous {key} point "
                  f"({prev['value']:.0f} > {rec.get('value', 0):.0f} "
                  f"tx/s; link {prev.get('link_MBps')} vs "
                  f"{rec.get('link_MBps')} MB/s)", file=sys.stderr)
            rec = prev
        elif not same_engine:
            hist = prev.pop("history", [])
            rec["history"] = hist + [
                {k: prev.get(k) for k in
                 ("value", "link_MBps", "engine") if k in prev}]
            print(f"# engine changed at {key}: replacing "
                  f"{prev.get('value', 0):.0f} -> "
                  f"{rec.get('value', 0):.0f} tx/s (old engine kept in "
                  f"history)", file=sys.stderr)
        merged.append(rec)
    merged.extend(old.values())
    return merged


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, nargs="*",
                    default=[1_000_000, 9_400_000, 32_700_000])
    ap.add_argument("--labeled-rows", type=int, default=1_000_000)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    eng = engine_id()
    points = [(rows, 0) for rows in args.points]
    if args.labeled_rows:
        points.append((args.labeled_rows, 1))
    records = []
    for rows, labels in points:
        records.append({**run_point(rows, labels, device=args.device),
                        "engine": eng})
        print(json.dumps(records[-1]), flush=True)

    merged = merge(records, load(args.out), eng)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(merged, f, indent=1)
    print(f"# wrote {args.out}", file=sys.stderr)
    return 1 if any("error" in r for r in records) else 0


if __name__ == "__main__":
    sys.exit(main())
