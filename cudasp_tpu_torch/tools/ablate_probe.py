"""Per-stage cost of the scan kernel by subtraction: the port of the JAX
package's tools/ablate_probe.py. Each of the seven stages (sqrt, table,
ladder, serialize, hash, comb, match) is swapped for a cheap stand-in by
a build of the kernel with -DSP_ABLATE=<its bit> (csrc/secp256k1.cuh's
scan_row; ops/kernels.py ablated_kernel), all built at once, each into a
directory of its own; a stage's cost is the base kernel's time minus its
ablated build's, on the same device-resident random planes (the stage
costs do not depend on the data). The budget line sets the seven costs'
sum against the whole kernel; --stage-profile also runs
tools/stage_profile and prints its budget beside. The ablated builds'
flags are garbage: this is a timing instrument, and no scan loads them.

    python -m cudasp_tpu_torch.tools.ablate_probe [--rows 262144]
        [--block-rows 256] [--labels 0] [--reps 4] [--stages a,b,...]
        [--stage-profile] [--device cuda|cpu]

On the card: nvcc builds, CUDA events. --device cpu builds the kernel's
host form (csrc/host_check.cpp, the same scan_row) with g++ and
-DSP_ABLATE, one library a stage under build/cudasp_tpu_torch/host/
ablate/, and times it with the host clock on --rows rows (a few dozen).
"""

import argparse
import ctypes
import hashlib
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..io import ingest, native
from ..ops import kernels as K
from ..ops import probes as P
from ..ops import scalar as S
from ..oracle import vectors as V

OUTPUTS = 3
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror"]


def masks(stages):
    """{stage: its SP_ABLATE bit} for the named stages."""
    return {s: 1 << K.ABLATE_STAGES.index(s) for s in stages}


def random_planes(rows, labels):
    """Random x-wire planes (uint32: tweak words, oh, ol, every output and
    row valid) and the BIP-352 query's fixed schedule, spend and
    labels."""
    rng = np.random.default_rng(0)
    tw = rng.integers(0, 2**32, size=(8, rows), dtype=np.uint64)
    oh, ol = (rng.integers(0, 2**32, size=(OUTPUTS, rows), dtype=np.uint64)
              for _ in range(2))
    ovm = np.full((1, rows), (1 << 31) | ((1 << OUTPUTS) - 1), np.uint64)
    planes = [a.astype(np.uint32) for a in (tw, oh, ol, ovm)]
    sched, sp, lab, _ = ingest.pack_query_keys(
        V.SCAN_KEY_BIP352, V.SPEND_BIP352, [V.LABEL2] * labels)
    return planes, sched.odd, sp, lab


def host_library(mask):
    """csrc/host_check.cpp built by g++ with -DSP_ABLATE=mask into
    build/cudasp_tpu_torch/host/ablate/<digest>/ (reused while its
    sources and flags match; io/native.py gxx_build), loaded with
    ctypes."""
    flags = GXX_FLAGS + K.ablate_flags(mask)
    h = hashlib.sha256(" ".join(flags).encode())
    for name in ("host_check.cpp", "secp256k1.cuh"):
        with open(os.path.join(K._CSRC, name), "rb") as f:
            h.update(f.read())
    so = os.path.join(K._BUILD_ROOT, "host", "ablate", h.hexdigest()[:16],
                      "libhostcheck.so")
    if not os.path.exists(so):
        native.gxx_build(os.path.join(K._CSRC, "host_check.cpp"), so, flags,
                         K._CSRC)
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sp_scan_rows.argtypes = [vp] * 4 + [ci] + [vp] * 3 + [ci, vp] + [
        ci] * 4 + [vp]
    lib.sp_scan_rows.restype = None
    return lib


def host_scan(lib, planes, digits, sp, lab):
    """The host build's scan_row over the planes' rows (fixed ladder, x
    wire): (rows,) int8 flags."""
    tw, oh, ol, ovm = (np.ascontiguousarray(p) for p in planes)
    n = tw.shape[1]
    lab_c = np.ascontiguousarray(lab if len(lab) else
                                 np.zeros((1, 2, 8), np.uint32))
    d = np.ascontiguousarray(digits, np.int32)
    comb = S.comb_table_np()
    flags = np.zeros(n, np.int8)
    lib.sp_scan_rows(tw.ctypes.data, oh.ctypes.data, ol.ctypes.data,
                     ovm.ctypes.data, 0, d.ctypes.data,
                     np.ascontiguousarray(sp).ctypes.data, lab_c.ctypes.data,
                     len(lab), comb.ctypes.data, n, OUTPUTS, 0, 0,
                     flags.ctypes.data)
    return flags


def build_all(ms, device):
    """Every build of the run at once: the base and each stage's."""
    with ThreadPoolExecutor(len(ms) + 1) as pool:
        if device.type == "cuda":
            futs = [pool.submit(K.KERNELS["fixed"].library)] + [
                pool.submit(K.ablated_kernel(m).library) for m in ms]
        else:
            futs = [pool.submit(host_library, m) for m in [0, *ms]]
        return [f.result() for f in futs]


def probe(rows, block_rows, labels, reps, stages, device):
    ms = masks(stages)
    t0 = time.perf_counter()
    libs = build_all(list(ms.values()), device)
    built = time.perf_counter() - t0
    planes, digits, sp, lab = random_planes(rows, labels)
    if device.type == "cuda":
        ops = [P.to_device(p, device) for p in planes]
        q = [P.to_device(a, device) for a in (sp, lab)]
        comb = K.comb_table(device)

        def timed(mask):
            return P.best_ms(lambda: K.scan_flags(
                *ops, digits, *q, comb, block_rows=block_rows,
                pack_flags=rows % 32 == 0, ablate=mask), device, reps)
    else:
        host = dict(zip([0, *ms.values()], libs))

        def timed(mask):
            return P.best_ms(lambda: host_scan(host[mask], planes, digits,
                                               sp, lab), device, reps)
    base = timed(0)
    out = {"rows": rows, "base_ms": base, "build_seconds": built,
           "stages": {}}
    print(json.dumps({"stage": "base", "ms": base, "rows": rows}),
          flush=True)
    for name, mask in ms.items():
        t = timed(mask)
        r = {"stage": name, "mask": mask, "ms": t, "cost_ms": base - t,
             "share": (base - t) / base}
        out["stages"][name] = r
        print(json.dumps(r), flush=True)
    total = sum(r["cost_ms"] for r in out["stages"].values())
    out["budget"] = {"ms": total, "share": total / base}
    print(f"budget: the {len(ms)} stages' costs sum to {total:.3f} ms of "
          f"the base's {base:.3f} ms ({total / base:.1%})", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=262_144)
    ap.add_argument("--block-rows", type=int, default=256)
    ap.add_argument("--labels", type=int, default=0)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--stages", default=",".join(K.ABLATE_STAGES))
    ap.add_argument("--stage-profile", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = P.resolve_device(args.device)
    print(f"# device: {P.device_name(dev)}", file=sys.stderr)
    out = probe(args.rows, args.block_rows, args.labels, args.reps,
                args.stages.split(","), dev)
    if args.stage_profile:
        from . import stage_profile

        sp = stage_profile.main(
            ["--bt", str(args.rows), "--device", str(dev)]
            + (["--iters", "1"] if dev.type == "cpu" else []))
        out["stage_profile_budget"] = sp["budget"]
        print(f"beside stage_profile: its budget {sp['budget']['share']:.1%}"
              f" of its FULL kernel, the ablation's "
              f"{out['budget']['share']:.1%} of the base", flush=True)
    return out


if __name__ == "__main__":
    main()
