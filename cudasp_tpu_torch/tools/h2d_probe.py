"""A batch's time split into its H2D copy, the kernel and the flags' D2H:
the port of the JAX package's tools/h2d_probe.py. One batch of --rows
copies of golden case 0's row 0 with 3 random outputs a row, packed on
the "full" wire (ops/kernels.py pack_batch_arrays), is timed:

  upload pinned     one H2D of the batch's planes from pinned memory
  upload pageable   the same from pageable memory
  upload x2, x4     the planes split into 2 or 4 lane ranges, each copied
                    on its own stream at once (does the link scale?)
  kernel            scan_flags on the device-resident planes
  flags D2H         the packed flags back into pinned memory

each the best of --reps by CUDA events. One JSON line each.

    python -m cudasp_tpu_torch.tools.h2d_probe [--rows 262144]
        [--block-rows 256] [--reps 3] [--device cuda|cpu]

--device cpu times host copies (there is no link) and the plain version
with the host clock, at a few hundred rows; the default, cuda, raises
without a GPU.
"""

import argparse
import json
import sys

import numpy as np
import torch

from ..io import ingest
from ..ops import kernels as K
from ..ops import probes as P
from ..oracle import vectors as V

OUTPUTS = 3


def batch_planes(rows, block_rows, wire="x", live=None):
    """`rows` copies of golden case 0's row 0 with OUTPUTS random outputs
    a row, packed on `wire` (rows past `live` are padding): (planes
    (uint32), the case's ScanSchedule, spend, labels)."""
    case = V.CASES[0]
    blobs = np.tile(np.frombuffer(case.rows[0].tweak_blob, np.uint8),
                    (rows, 1))
    rng = np.random.default_rng(0)
    oh = rng.integers(0, 2**31, (rows, OUTPUTS)).astype(np.int32)
    ol = rng.integers(0, 2**31, (rows, OUTPUTS)).astype(np.int32)
    valid = np.arange(rows) < (rows if live is None else live)
    planes = K.pack_batch_arrays(blobs, valid, oh, ol,
                                 np.ones((rows, OUTPUTS), bool), block_rows,
                                 wire=wire)
    sched, sp, lab, _ = ingest.pack_query_keys(case.scan_key_blob,
                                               case.spend_blob, [])
    return planes, sched, sp, lab


def _copy_ms(pairs, device, reps):
    """Best ms of copying each (dst, src) pair, each on its own stream on
    the card, all at once."""
    if device.type != "cuda":
        return P.best_ms(lambda: [d.copy_(s) for d, s in pairs], device,
                         reps)
    streams = [torch.cuda.Stream(device) for _ in pairs]

    def copy():
        cur = torch.cuda.current_stream(device)
        for st, (d, s) in zip(streams, pairs):
            st.wait_stream(cur)
            with torch.cuda.stream(st):
                d.copy_(s, non_blocking=True)
        for st in streams:
            cur.wait_stream(st)

    return P.best_ms(copy, device, reps)


def _split(host, parts, cuda, device):
    """(device, host) pairs of `parts` contiguous lane ranges of host,
    the host copies pinned on the card."""
    B = host.shape[1]
    out = []
    for k in range(parts):
        src = host[:, B * k // parts:B * (k + 1) // parts].contiguous()
        out.append((torch.empty_like(src, device=device),
                    src.pin_memory() if cuda else src))
    return out


def probe(rows, block_rows, reps, device):
    planes, sched, sp, lab = batch_planes(rows, block_rows)
    digits = sched.odd
    host = torch.from_numpy(np.concatenate(planes).view(np.int32))
    nbytes = host.numel() * 4
    cuda = device.type == "cuda"
    pinned = host.pin_memory() if cuda else host.clone()
    dev = torch.empty_like(host, device=device)
    out = {"rows": planes[0].shape[1], "bytes": nbytes,
           "bytes_per_row": nbytes / planes[0].shape[1]}

    def line(name, ms, **kw):
        r = {"probe": name, "ms": ms, **kw}
        out[name] = r
        print(json.dumps(r), flush=True)

    for name, src in (("upload pinned", pinned), ("upload pageable", host)):
        ms = _copy_ms([(dev, src)], device, reps)
        line(name, ms, MB_per_s=nbytes / ms / 1e3)
    for parts in (2, 4):
        ms = _copy_ms(_split(host, parts, cuda, device), device, reps)
        line(f"upload x{parts}", ms, MB_per_s=nbytes / ms / 1e3)
    rows_at = np.cumsum([0] + [p.shape[0] for p in planes])
    ops = [dev[a:z] for a, z in zip(rows_at[:-1], rows_at[1:])]
    q = [P.to_device(a, device) for a in (sp, lab)]
    comb = K.comb_table(device)
    width = planes[0].shape[1]

    def launch():
        return K.scan_flags(*ops, digits, *q, comb, block_rows=block_rows,
                            pack_flags=width % 32 == 0)

    flags = launch()
    ms = P.best_ms(launch, device, reps)
    line("kernel", ms, rows_per_s=width / ms * 1e3)
    back = (torch.empty(flags.shape, dtype=flags.dtype, pin_memory=True)
            if cuda else torch.empty_like(flags))
    ms = P.best_ms(lambda: back.copy_(flags, non_blocking=cuda), device,
                   reps)
    line("flags D2H", ms, bytes=flags.numel() * flags.element_size())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=262_144)
    ap.add_argument("--block-rows", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = P.resolve_device(args.device)
    print(f"# device: {P.device_name(dev)}", file=sys.stderr)
    return probe(args.rows, args.block_rows, args.reps, dev)


if __name__ == "__main__":
    main()
