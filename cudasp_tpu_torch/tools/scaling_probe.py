"""Weak scaling of the mesh path: the port of the JAX package's
tools/scaling_probe.py. Over make_mesh(devices=[device] * n) for n = 1,
2, 4 (and, on a host with several cards, over every card), with the rows
a mesh entry holds fixed, it times (the host clock around calls that end
in synchronising every card, best of --reps):

  sharded    ops/kernels.py scan_flags_sharded alone, one launch an entry
  exchange   parallel/exchange.py rebalanced_scan: the row exchange of a
             batch whose live rows all sit in its first half, then the
             sharded scan
  xla        the XLA backend's pipeline (ops/pipeline.py scan_batch) over
             each entry's shard on that entry's stream, at a small width

Perfect weak scaling keeps a probe's time flat as n grows; efficiency is
the 1-entry time over the n-entry time. On a host with one card the
meshes repeat that card, so the entries share its SMs: the numbers say
what the fan-out and the exchange cost on one card, not how several cards
scale, and the output says so. One JSON line a (probe, mesh).

    python -m cudasp_tpu_torch.tools.scaling_probe [--rows-per-device
        65536] [--xla-rows-per-device 1024] [--block-rows 256] [--reps 3]
        [--device cuda|cpu]

--device cpu runs the plain versions on CPU meshes, at a few dozen rows
an entry.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops import kernels as K
from ..ops import pipeline as PL
from ..ops import probes as P
from ..parallel import exchange as X
from ..parallel.mesh import BatchShardings, Fanout, make_mesh
from .h2d_probe import batch_planes


def _sync(mesh):
    for d in mesh.distinct:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _ms(fn, mesh, reps):
    fn()
    _sync(mesh)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(mesh)
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def probe_mesh(mesh, per, xla_per, block_rows, reps):
    """{probe: ms} of one mesh."""
    dev = mesh.devices[0]
    n = mesh.size
    sh = BatchShardings(mesh)
    out = {}
    planes, sched, sp, lab = batch_planes(per * n, block_rows)
    ops = [P.to_device(p, dev) for p in planes]
    q = [P.to_device(a, dev) for a in (sp, lab)]
    comb = K.comb_table(dev)
    out["sharded"] = _ms(lambda: K.scan_flags_sharded(
        mesh, *ops, sched.odd, *q, comb, block_rows=block_rows), mesh, reps)
    # the exchange: every live row in the first half of the batch
    planes, *_ = batch_planes(per * n, block_rows, live=per * n // 2)
    ops = [P.to_device(p, dev) for p in planes]
    src = P.to_device(np.arange(2 * per * n, dtype=np.int32).reshape(2, -1),
                      dev)
    out["exchange"] = _ms(lambda: X.rebalanced_scan(
        mesh, *ops, src[:1], src[1:], sched.odd, *q, comb,
        block_rows=block_rows), mesh, reps)
    planes, sched, sp, lab = batch_planes(xla_per * n, block_rows, "xy")
    shards = [sh.lanes(P.to_device(p, dev)) for p in planes]
    query = {d: PL.query_limbs(*(P.to_device(a, d) for a in (sp, lab)))
             for d in mesh.distinct}

    def xla():
        fan = Fanout(mesh)
        outs = []
        for k, d in enumerate(mesh.devices):
            with fan.on(k), torch.inference_mode():
                sx, sy, lx, ly = query[d]
                outs.append([PL.scan_batch(
                    *PL.from_planes(*(s[k] for s in shards)), sched.glv,
                    sx, sy, lx, ly, nlabels=lx.shape[0])])
        fan.join(outs)

    out["xla"] = _ms(xla, mesh, reps)
    return out


def probe(per, xla_per, block_rows, reps, device, sizes=(1, 2, 4)):
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    dname = "cpu" if device.type == "cpu" else f"cuda:{device.index or 0}"
    meshes = [(f"{n} x {dname}", make_mesh(devices=[dname] * n))
              for n in sizes]
    if cards > 1:
        meshes.append(("all cards", make_mesh()))
    if device.type == "cpu":
        note = "CPU meshes: every entry runs the plain version on this host"
    elif cards == 1:
        note = ("repeated device: every entry of a mesh is the same card, "
                "so these are fan-out and exchange costs on one card, not "
                "multi-card scaling")
    else:
        note = f"{cards} cards: the 'all cards' mesh spans them"
    print(f"# {note}", file=sys.stderr, flush=True)
    results = []
    base = {}
    for label, mesh in meshes:
        times = probe_mesh(mesh, per, xla_per, block_rows, reps)
        for name, ms in times.items():
            rows = (xla_per if name == "xla" else per) * mesh.size
            if mesh.size == 1:
                base[name] = ms
            r = {"probe": name, "mesh": label, "entries": mesh.size,
                 "rows": rows, "ms": ms, "rows_per_s": rows / ms * 1e3,
                 "efficiency": base[name] / ms, "note": note}
            results.append(r)
            print(json.dumps(r), flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows-per-device", type=int, default=65_536)
    ap.add_argument("--xla-rows-per-device", type=int, default=1024)
    ap.add_argument("--block-rows", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sizes", default="1,2,4",
                    help="mesh entries, comma-separated; 1 comes first")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = P.resolve_device(args.device)
    print(f"# device: {P.device_name(dev)}", file=sys.stderr)
    sizes = tuple(int(n) for n in args.sizes.split(","))
    if sizes[0] != 1:
        raise SystemExit("--sizes starts at 1, the efficiency's base")
    for per in (args.rows_per_device, args.xla_rows_per_device):
        if per % args.block_rows:
            raise SystemExit("rows a device must be a multiple of "
                             "--block-rows")
    return probe(args.rows_per_device, args.xla_rows_per_device,
                 args.block_rows, args.reps, dev, sizes)


if __name__ == "__main__":
    main()
