"""Multi-process scans: torch.distributed and hash-partitioned tables
(counterpart of cudasp_tpu/parallel/distributed.py).

  * every process reads and packs only its own hash part of the table
    (parallel.partition), so no process feeds the others;
  * each process's devices scan that part over its local mesh
    (ScanConfig(mesh=local_mesh()): ops.kernels.scan_flags_sharded);
  * the only traffic between processes is the match merge, a few bytes
    per matching row, all-gathered once per scan.

Run one process per host (or per group of cards):

    from cudasp_tpu_torch.parallel import distributed as D
    D.init(coordinator_address="host0:8476", num_processes=N, process_id=i)
    matches = D.multihost_scan(table, scan_key, spend_key, labels)

The merge moves host-side int64 row indices, so it runs on the gloo
backend, on CPU tensors, also where the scan runs on GPUs. Every function
works single-process as well (the merge is then the identity)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import partition


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None) -> None:
    """torch.distributed.init_process_group("gloo") over the rendezvous
    at tcp://coordinator_address ("host:port"); without an address, torch
    reads MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK from the
    environment. A no-op when single-process (no address and
    num_processes unset or 1)."""
    if coordinator_address is None and num_processes in (None, 1):
        return
    init_method = (f"tcp://{coordinator_address}" if coordinator_address
                   else "env://")
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=-1 if num_processes is None
                            else num_processes,
                            rank=-1 if process_id is None else process_id)


def host_info():
    """(this process's rank, process count); (0, 1) when torch.distributed
    is not initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_mesh(device=None):
    """The mesh of this process's devices: every visible CUDA device, or
    one CPU entry when device is "cpu" (the plain version)."""
    from .mesh import Mesh, make_mesh

    if device is not None and torch.device(device).type == "cpu":
        return Mesh(["cpu"])
    return make_mesh()


def allgather_matches(local_indices: np.ndarray) -> np.ndarray:
    """Union of every process's matched row indices, sorted, on every
    process. Single-process: the sorted unique indices. Multi-process: two
    all_gathers of CPU int64 tensors (the counts, then the indices padded
    to the largest count with -1)."""
    local = np.asarray(local_indices, np.int64)
    _, world = host_info()
    if world == 1:
        return np.unique(local)
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(counts, torch.tensor([local.size], dtype=torch.int64))
    m = max(int(c) for c in counts)
    padded = torch.full((m,), -1, dtype=torch.int64)
    padded[:local.size] = torch.from_numpy(local)
    gathered = [torch.empty(m, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(gathered, padded)
    flat = torch.cat(gathered).numpy()
    return np.unique(flat[flat >= 0])


def _take(col, idx):
    """Rows `idx` of one table column, in any form that scan() reads."""
    if isinstance(col, np.ndarray):
        return col[idx]
    if hasattr(col, "take"):                   # pyarrow
        return col.take(idx)
    if isinstance(col, tuple):                 # CSR outputs
        flat, offs = col
        offs = np.asarray(offs, np.int64)
        lens = (offs[1:] - offs[:-1])[idx]
        new_off = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(lens, out=new_off[1:])
        gidx = (np.repeat(offs[idx] - new_off[:-1], lens)
                + np.arange(new_off[-1], dtype=np.int64))
        return (np.asarray(flat, np.int64)[gidx], new_off)
    return [col[int(i)] for i in idx]


def _partition_keys(col) -> np.ndarray:
    """A partition column -> partition_rows' keys: an (n, k) uint8 array as
    it is; integers (a numpy integer array, or ints with NULL as 0) as
    (n,) uint64, two's complement for negatives; anything else as bytes,
    the first 32 of each (NULL as empty). The JAX package takes bytes(v)
    of an integer too, v zero bytes, which puts every id >= 32 in one
    part; the port does not."""
    if isinstance(col, np.ndarray):
        if col.dtype == np.uint8 and col.ndim == 2:
            return col
        if col.dtype.kind in "iu":
            return col.astype(np.uint64)
    if hasattr(col, "to_pylist"):
        col = col.to_pylist()
    if all(v is None or (isinstance(v, (int, np.integer))
                         and not isinstance(v, bool)) for v in col) \
            and any(v is not None for v in col):
        return np.array([0 if v is None else int(v) % 2**64 for v in col],
                        np.uint64)
    rows = [(bytes(b) if b is not None else b"")[:32] for b in col]
    keys = np.zeros((len(rows), 32), np.uint8)
    for i, b in enumerate(rows):
        keys[i, :len(b)] = np.frombuffer(b, np.uint8)
    return keys


def multihost_scan(table, scan_private_key: bytes, spend_public_key: bytes,
                   label_keys: Sequence[bytes] = (), *,
                   partition_key: str = "txid", config=None,
                   device=None) -> np.ndarray:
    """Scan `table` cooperatively across all processes; returns the global
    matched row indices, on every process.

    Each process keeps only its hash part of the rows (by
    `partition_key`, else round-robin by row index; stable in the original
    row order, so the indices are global), scans it on its local mesh
    (config.mesh, else local_mesh(device)), and all-gathers the matches.
    device: as for scan()."""
    from ..api import ScanConfig, _table_columns, scan

    host, n_hosts = host_info()
    cols = _table_columns(table)
    if partition_key in cols:
        mine = partition.local_shard_indices(
            _partition_keys(cols[partition_key]), n_hosts, host)
    else:
        n = len(cols["tweak_key"])
        mine = np.arange(host, n, n_hosts, dtype=np.int64)
    shard = {name: _take(c, mine) for name, c in cols.items()}
    cfg = config or ScanConfig()
    if cfg.mesh is None:
        cfg = dataclasses.replace(cfg, mesh=local_mesh(device))
    res = scan(shard, scan_private_key, spend_public_key, label_keys,
               config=cfg, device=device)
    return allgather_matches(mine[res.indices])
