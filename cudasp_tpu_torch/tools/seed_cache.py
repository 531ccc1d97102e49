"""Prebuild every library a scan on this machine needs, so that no scan
waits for a compiler: the port's counterpart of the JAX package's
tools/seed_cache.py. It builds, all at once, into build/cudasp_tpu_torch/:

  csrc/scan.cu       the scan kernel's fixed and wnaf ladders (nvcc)
  csrc/probe.cu      the probe tools' kernels (nvcc)
  csrc/pack.cpp      the host packer (g++)
  one static unit    for each --scan-key: that key's "static" ladder
                     (nvcc), the explicit per-key prewarm of a long-lived
                     key (ScanConfig(static_key=True))

A library already built for the same sources and flags is loaded, not
rebuilt: a second run builds nothing. The reference prewarms upload-wire
variants in a background thread; the port's wire is a launch argument,
so there is nothing to prewarm and no thread. The static libraries
encode their keys (0o700 directories, kernels.py).

    python -m cudasp_tpu_torch.tools.seed_cache [--scan-key HEX|@file]...
        [--device cuda|cpu]

--scan-key takes a 32-byte scan key as hex, or @file holding one hex key
a line. --device cpu builds the host packer only (the CPU runs the
kernels' plain versions). Prints one JSON line: the builds it ran.
"""

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from ..io import native
from ..ops import kernels as K
from ..ops import probes as P
from ..ops import scalar as S
from ..oracle.encoding import blob32_to_scalar


def scan_keys(values):
    """--scan-key values -> 32-byte keys (hex, or @file of hex lines)."""
    keys = []
    for v in values:
        lines = ([ln.strip() for ln in open(v[1:]) if ln.strip()]
                 if v.startswith("@") else [v])
        for ln in lines:
            b = bytes.fromhex(ln)
            if len(b) != 32:
                raise SystemExit(f"a scan key is 32 bytes, got {len(b)}")
            keys.append(b)
    return keys


def seed(keys, device):
    """Build (or load) every library; returns what ran."""
    t0 = time.perf_counter()
    runs0 = (K.KERNELS["fixed"].nvcc_runs, K.KERNELS["static"].nvcc_runs,
             P.PROBES.nvcc_runs, native.STATE.runs)
    jobs = [native.library]
    if device.type == "cuda":
        st = K.KERNELS["static"]
        jobs += [K.KERNELS["fixed"].library, P.PROBES.library]
        jobs += [lambda s=S.glv_wnaf_static(blob32_to_scalar(k)):
                 st.library(s) for k in keys]
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(j) for j in jobs]:
            f.result()
    runs = (K.KERNELS["fixed"].nvcc_runs, K.KERNELS["static"].nvcc_runs,
            P.PROBES.nvcc_runs, native.STATE.runs)
    d = [b - a for a, b in zip(runs0, runs)]
    out = {"device": str(device), "keys": len(keys),
           "nvcc_runs": d[0] + d[1] + d[2], "gxx_runs": d[3],
           "scan_nvcc_runs": d[0], "static_nvcc_runs": d[1],
           "probe_nvcc_runs": d[2], "libraries": len(jobs),
           "seconds": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scan-key", action="append", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = P.resolve_device(args.device)
    keys = scan_keys(args.scan_key)
    if keys and dev.type != "cuda":
        raise SystemExit("a key's static unit is built with nvcc, for a "
                         "card: --scan-key needs --device cuda")
    return seed(keys, dev)


if __name__ == "__main__":
    main()
