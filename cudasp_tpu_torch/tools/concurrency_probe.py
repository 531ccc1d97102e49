"""Several tenants' scan() calls at once on one device, against one at a
time: the port of the JAX package's tools/concurrency_probe.py. Each
tenant scans tools/dataset.py's table under the BIP-352 query on its own
thread, and its rows must equal the table's is_match; the probe prints
the single scan's tx/s and the tenants' aggregate. The executor's shared
state ("auto"'s process-wide memo, the kernel libraries) is what the
threads contend for.

    python -m cudasp_tpu_torch.tools.concurrency_probe [--rows 500000]
        [--tenants 2] [--pool 128] [--device cuda|cpu]

--device cpu runs the plain version (a few hundred rows); the default,
cuda, raises without a GPU. Raises when a tenant's rows are not exact.
"""

import argparse
import json
import sys
import threading
import time

import numpy as np

from ..api import ScanConfig, scan
from ..ops import probes as P
from . import dataset

JOIN_TIMEOUT_S = 600


def probe(rows, tenants, pool, device, config=None):
    key, spend, _, _ = dataset.bip352_query()
    table, expect = dataset.bip352_table(rows, pool=pool)
    errors = []

    def one():
        try:
            res = scan(table, key, spend, config=config or ScanConfig(),
                       device=device)
            if not np.array_equal(res.indices, expect):
                raise AssertionError(f"{len(res.indices)} rows, expected "
                                     f"{len(expect)}")
        except Exception as e:                # reported after the join
            errors.append(e)

    one()                                     # builds, pinned memory
    t0 = time.perf_counter()
    one()
    single = time.perf_counter() - t0
    t0 = time.perf_counter()
    threads = [threading.Thread(target=one) for _ in range(tenants)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_TIMEOUT_S)
    together = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise RuntimeError(f"a tenant's scan outlived {JOIN_TIMEOUT_S} s")
    if errors:
        raise RuntimeError(f"a tenant's scan failed or was inexact: "
                           f"{errors[0]!r}") from errors[0]
    out = {"rows": rows, "tenants": tenants, "exact": True,
           "single_seconds": single, "single_tx_per_s": rows / single,
           "together_seconds": together,
           "aggregate_tx_per_s": tenants * rows / together,
           "speedup": single * tenants / together}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=500_000)
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--pool", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = P.resolve_device(args.device)
    print(f"# device: {P.device_name(dev)}", file=sys.stderr)
    cfg = ScanConfig(block_rows=32) if dev.type == "cpu" else None
    return probe(args.rows, args.tenants, args.pool, str(dev), cfg)


if __name__ == "__main__":
    main()
