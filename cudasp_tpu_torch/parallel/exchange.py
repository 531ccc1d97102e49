"""Row exchange across a mesh's entries, with skew handling (counterpart
of cudasp_tpu/parallel/exchange.py).

When data placement is fixed (each process owns given files or row
groups), the live rows per shard skew and the slowest shard gates the
batch. `rebalance` evens them out before the scan, lane for lane as the
JAX package's shard_map body (`_shard_rebalance`, exchange.py:45-70) does:

 1. Strided exchange: entry d sends its lane l to entry l mod N, so
    receiver d's lane m*N + i is sender i's lane m*N + d. Live rows are a
    prefix of every shard (ingest packs them so), so each receiver gets an
    equal share (+-1 per sender) of every sender's live rows.
 2. Per-entry compaction: a stable sort on the row-valid bit (bit 31 of
    the last, ovm, plane) puts the live lanes first again.
 3. Live-block masks, from the per-entry live counts: tiles with no live
    row skip the kernel's whole pipeline.

Within one process the exchange is N x N copies between the entries: each
sender stacks its planes and makes its strided slice for a receiver
contiguous on its own stream, and the receiver copies it in on its stream
after an event on the sender's (a device-to-device copy, across cards or
within one). This is what all_to_all does within one host;
torch.distributed's all_to_all would need one process per card, where the
reference has one process per host driving all of its chips. Nothing here
synchronises with the host: the counts and block masks stay on the
devices, so the scan is issued straight after the exchange.

`ScanConfig(mesh=..., rebalance=True)` routes every batch of a scan
through the exchange (runtime.executor)."""

from __future__ import annotations

import numpy as np
import torch

from .mesh import BatchShardings, Fanout, gather_lanes, is_sharded

ROW_VALID_BIT = 31     # ovm bit layout: see ops.kernels.pack_batch_arrays


def _receive(fan, dst, src, sender, receiver, ready):
    """dst (on the receiver's device) <- src (the sender's contiguous
    slice), on the receiver's stream after the sender's event; across two
    cards the copy runs between the two entries' streams, each waiting
    for the other (torch's cross-device copy)."""
    s_src, s_dst = fan.streams[sender], fan.streams[receiver]
    if s_dst is None:
        dst.copy_(src)
    elif src.device == dst.device:
        s_dst.wait_event(ready[sender])
        dst.copy_(src)
        src.record_stream(s_dst)
    else:
        with torch.cuda.stream(s_src), torch.cuda.stream(s_dst):
            dst.copy_(src)
        dst.record_stream(s_src)


def rebalance(mesh, *planes, block_rows: int = 512, streams=None):
    """Rebalance lane-sharded (K, B) planes over the mesh's entries.

    Each plane comes whole (K, B) or as per-entry (K, B / N) shards, all of
    one dtype; the LAST one must be the (1, B) ovm validity plane. Shards
    need a width that is a multiple of N and of block_rows. Returns (the
    rebalanced planes, live lanes first in every shard; the per-entry live
    counts, int32; the (B // block_rows,) int32 live-block mask), whole
    tensors on the planes' device when they came whole, else per-entry
    lists. streams: as for ops.kernels.scan_flags_sharded.

    Each entry's planes travel stacked as one (sum K, L) tensor, so a
    batch costs N x N strided copies, not N x N per plane."""
    n = mesh.size
    whole = not is_sharded(planes[-1])
    parts = [BatchShardings(mesh).lanes(p) for p in planes]
    if len({x[0].dtype for x in parts}) != 1:
        raise ValueError("rebalance: the planes must share one dtype")
    L = parts[-1][0].shape[-1]
    if L % n or L % block_rows:
        raise ValueError(f"shard width {L} must be a multiple of the mesh "
                         f"size {n} and of block_rows {block_rows}")
    rows = [x[0].shape[0] for x in parts]
    R = sum(rows)
    fan = Fanout(mesh, streams)
    # 1. each sender's planes stacked, then its strided slice for each
    # receiver made contiguous
    sent, ready = [], []
    for i in range(n):
        with fan.on(i):
            x = torch.cat([p[i] for p in parts]).reshape(R, L // n, n)
            sent.append([x[:, :, d].contiguous() for d in range(n)])
            if fan.streams[i] is not None:
                ready.append(fan.streams[i].record_event())
    out = [[] for _ in parts]
    counts, bmasks, made = [], [], []
    for d, dev in enumerate(mesh.devices):
        with fan.on(d):
            recv = torch.empty((R, L // n, n), dtype=parts[0][d].dtype,
                               device=dev)
            for i in range(n):
                _receive(fan, recv[:, :, i], sent[i][d], i, d, ready)
            recv = recv.reshape(R, L)
            # 2. live lanes first, in their order (a stable sort)
            valid = (recv[-1] >> ROW_VALID_BIT) & 1
            order = torch.argsort(1 - valid, stable=True)
            shard = recv[:, order]
            # 3. the live count and the live-block mask
            count = valid.sum(dtype=torch.int32).reshape(1)
            starts = torch.arange(L // block_rows, dtype=torch.int32,
                                  device=dev) * block_rows
            bm = (starts < count).to(torch.int32)
        at = 0
        for o, k in zip(out, rows):
            o.append(shard[at:at + k])
            at += k
        counts.append(count)
        bmasks.append(bm)
        made.append([shard, count, bm])
    fan.join(made)
    if whole:
        dev = planes[-1].device
        return ([gather_lanes(o, dev) for o in out],
                gather_lanes(counts, dev), gather_lanes(bmasks, dev))
    return out, counts, bmasks


def blockmask_from_counts(counts, n_local_blocks: int,
                          block_rows: int) -> np.ndarray:
    """Host-side form of the mask rule (ops.kernels.live_blockmask for one
    shard): per-entry live counts -> the (N * n_local_blocks,) int32 block
    mask, in (entry, local block) order."""
    counts = np.asarray(counts)
    i = np.arange(n_local_blocks) * block_rows
    return (i[None, :] < counts[:, None]).astype(np.int32).reshape(-1)


def rebalanced_scan(mesh, tweak_words, outputs_hi, outputs_lo, outputs_mask,
                    src_hi, src_lo, digits, spend, labels, comb, *,
                    block_rows: int = 512, ladder: str = "fixed",
                    static_sched=None, streams=None):
    """The exchange, then the sharded scan of the rebalanced lanes.

    The operands of ops.kernels.scan_flags_sharded on the exact x wire,
    plus (1, B) source-row planes (src_hi / src_lo: the int32 halves of
    each lane's original row index) that travel with their rows. Returns
    (flags (1, B) int8, src_hi, src_lo): the flags are in the REBALANCED
    lane order, so callers map them back through the source planes."""
    from ..ops import kernels as K

    planes, _counts, bmask = rebalance(
        mesh, tweak_words, outputs_hi, outputs_lo, src_hi, src_lo,
        outputs_mask, block_rows=block_rows, streams=streams)
    tw, oh, ol, shi, slo, ovm = planes
    flags = K.scan_flags_sharded(
        mesh, tw, oh, ol, ovm, digits, spend, labels, comb, bmask,
        block_rows=block_rows, ladder=ladder, static_sched=static_sched,
        streams=streams)
    return flags, shi, slo
