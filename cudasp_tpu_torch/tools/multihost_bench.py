"""Multi-process scan throughput: the port of the JAX package's
tools/multihost_bench.py. One process a host (or a card), each started
with the same dataset arguments; every process builds tools/dataset.py's
table (the same for a seed), multihost_scan (parallel/distributed.py)
keeps its hash part, scans it on the process's mesh and all-gathers the
matches over gloo, and process 0 prints the JAX tool's JSON line:

    {"metric": "multihost_scan_throughput", "hosts": N, "value": tx/s,
     "unit": "tx/s", "rows": ..., "seconds": ...[, "efficiency_vs_1host"]}

after checking the merged rows against the table's is_match.

    # on each of N hosts (host 0 is the rendezvous)
    python -m cudasp_tpu_torch.tools.multihost_bench --coordinator
        host0:8476 --num-hosts N --host-id i [--rows 32700000]
    # N processes on this machine, on free local ports
    python -m cudasp_tpu_torch.tools.multihost_bench --spawn N [--rows ..]

--device cpu scans with the plain version (a few hundred rows); the
default, cuda, scans on every card of the process (--devices cuda:0 puts
each process on that card).
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coordinator", default=None,
                    help="host0:port of the gloo rendezvous")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--spawn", type=int, default=0,
                    help="start this many processes here and relay "
                         "process 0's line")
    ap.add_argument("--rows", type=int, default=32_700_000)
    ap.add_argument("--batch-size", type=int, default=524_288)
    ap.add_argument("--pool", type=int, default=256)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--one-host-txs", type=float, default=None,
                    help="one host's tx/s for the efficiency column")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", default=None,
                    help="comma-separated mesh entries of each process "
                         "(default: every card)")
    return ap.parse_args(argv)


def spawn(args, argv):
    """--spawn N: N local processes on a free port; returns process 0's
    JSON line (a dict). Every process started here is ended here."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rest, skip = [], False
    for a in argv:                       # drop --spawn and its value
        if skip:
            skip = False
        elif a == "--spawn":
            skip = True
        elif not a.startswith("--spawn="):
            rest.append(a)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cudasp_tpu_torch.tools.multihost_bench",
         *rest, "--coordinator", f"127.0.0.1:{port}", "--num-hosts",
         str(args.spawn), "--host-id", str(i)],
        cwd=os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(args.spawn)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=1800))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"a multihost_bench process failed "
                               f"({p.returncode}):\n{out}\n{err[-3000:]}")
    line = json.loads(outs[0][0].strip().splitlines()[-1])
    print(json.dumps(line), flush=True)
    return line


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _args(argv)
    if args.spawn:
        return spawn(args, argv)
    from ..api import ScanConfig
    from ..ops import probes as P
    from ..parallel import distributed as D
    from ..parallel.mesh import Mesh, make_mesh
    from . import dataset

    dev = P.resolve_device(args.device)
    D.init(coordinator_address=args.coordinator,
           num_processes=args.num_hosts, process_id=args.host_id)
    pid, nproc = D.host_info()
    if dev.type == "cpu":
        mesh = Mesh(["cpu"])
    elif args.devices:
        mesh = make_mesh(devices=args.devices.split(","))
    else:
        mesh = make_mesh()
    print(f"# host {pid}/{nproc}: {mesh}", file=sys.stderr)
    key, spend, _, _ = dataset.bip352_query()
    t0 = time.perf_counter()
    # every process makes the same table; multihost_scan keeps its part
    table, expect = dataset.bip352_table(args.rows, pool=args.pool)
    print(f"# dataset: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    cfg = ScanConfig(batch_size=args.batch_size, mesh=mesh,
                     block_rows=32 if dev.type == "cpu" else None)
    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        idx = D.multihost_scan(table, key, spend, (), config=cfg)
        times.append(time.perf_counter() - t0)
        if not np.array_equal(idx, expect):
            raise AssertionError(f"merged {len(idx)} rows, expected "
                                 f"{len(expect)}")
        print(f"# run: {times[-1]:.3f} s, {len(idx)} rows == is_match",
              file=sys.stderr)
    best = min(times)
    out = {"metric": "multihost_scan_throughput", "hosts": nproc,
           "value": args.rows / best, "unit": "tx/s", "rows": args.rows,
           "seconds": best}
    if args.one_host_txs:
        out["efficiency_vs_1host"] = out["value"] / (args.one_host_txs
                                                     * nproc)
    if nproc > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    if pid == 0:
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
