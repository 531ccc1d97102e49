"""First contact with a machine: one command from clean build caches to a
tuned, prebuilt state that has served a scan; the port's counterpart of
the JAX package's tools/first_contact.py. Each step is a subprocess, and
a failed step stops the chain with its exit code:

  1. autotune     tools/autotune.py: the card's launch shape, written as
                  its tuning row (--skip-autotune keeps the row there is;
                  --quick sweeps the reduced grid)
  2. seed_cache   tools/seed_cache.py: every library a scan needs, and
                  the static unit of each --scan-key
  3. scan         a scan() of --rows rows of tools/dataset.py's table
                  under the BIP-352 query, whose rows must equal the
                  table's is_match (root bench.py stays out of it)

    python -m cudasp_tpu_torch.tools.first_contact [--quick]
        [--skip-autotune] [--rows 1000000] [--pool 256]
        [--scan-key HEX|@file]... [--device cuda|cpu]

--device cpu runs each step on the CPU at small sizes (autotune with
--dry-run: a CPU tuning row would move later CPU scans). Prints each
step's wall time, then one JSON line of them all.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def run_step(name, args):
    cmd = [sys.executable, "-m", f"cudasp_tpu_torch.tools.{name}", *args]
    print(f"=== {name}: {' '.join(cmd[1:])}", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT)
    dt = time.perf_counter() - t0
    print(f"=== {name} done in {dt:.1f} s (exit {proc.returncode})",
          flush=True)
    if proc.returncode != 0:
        print(f"first_contact: step {name!r} failed; the steps before it "
              f"are kept and a rerun skips their builds", file=sys.stderr)
        sys.exit(proc.returncode)
    return dt


def smoke(rows, pool, device):
    """The chain's last step: scan() of `rows` rows, exact, in this
    process; one JSON line."""
    from ..api import ScanConfig, scan
    from . import dataset

    key, spend, _, _ = dataset.bip352_query()
    table, expect = dataset.bip352_table(rows, pool=pool)
    cfg = ScanConfig(block_rows=32) if device == "cpu" else ScanConfig()
    t0 = time.perf_counter()
    res = scan(table, key, spend, config=cfg, device=device)
    secs = time.perf_counter() - t0
    if list(res.indices) != list(expect):
        raise SystemExit(f"scan: {len(res.indices)} rows, expected "
                         f"{len(expect)}")
    m = res.metrics
    out = {"rows": rows, "seconds": secs, "tx_per_s": rows / secs,
           "matches": len(res.indices), "pack_seconds": m.pack_seconds,
           "upload_seconds": m.upload_seconds, "batches": m.batches}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--skip-autotune", action="store_true")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--pool", type=int, default=256)
    ap.add_argument("--scan-key", action="append", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="run step 3 alone, in this process")
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke(args.rows, args.pool, args.device)
    dev = ["--device", args.device]
    cpu = args.device == "cpu"
    t0 = time.perf_counter()
    steps = {}
    if not args.skip_autotune:
        steps["autotune"] = run_step("autotune", dev + (
            ["--rows", "256", "--reps", "1", "--dry-run"] if cpu else [])
            + (["--quick"] if args.quick else []))
    steps["seed_cache"] = run_step("seed_cache", dev + [
        a for k in args.scan_key for a in ("--scan-key", k)])
    steps["scan"] = run_step("first_contact", dev + [
        "--smoke", "--rows", str(args.rows), "--pool", str(args.pool)])
    out = {"steps": steps, "seconds": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
