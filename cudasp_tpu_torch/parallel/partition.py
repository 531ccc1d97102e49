"""Hash partition of a table's rows across processes (a numpy copy of
cudasp_tpu/parallel/partition.py:29-75, with the same salt and the same
FNV fold, so both packages put a row in the same part).

Rows are hash-partitioned by txid (any stable key): each process packs and
scans only its own part on its local mesh, and the only traffic between
processes is the match merge (parallel.distributed)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def partition_rows(keys: np.ndarray, n_parts: int,
                   salt: int = 0x9E3779B97F4A7C15) -> np.ndarray:
    """Stable hash partition: per-row part index in [0, n_parts).

    keys: (n,) uint64-convertible or (n, k) uint8 row keys."""
    k = np.asarray(keys)
    if k.dtype == np.uint8 and k.ndim == 2:
        # fold the bytes into a u64 (FNV-1a style, vectorized)
        acc = np.full(k.shape[0], 0xCBF29CE484222325, np.uint64)
        for c in range(k.shape[1]):
            acc = (acc ^ k[:, c].astype(np.uint64)) * np.uint64(0x100000001B3)
    else:
        acc = k.astype(np.uint64)
    acc ^= np.uint64(salt)
    acc *= np.uint64(0xFF51AFD7ED558CCD)
    acc ^= acc >> np.uint64(33)
    return (acc % np.uint64(n_parts)).astype(np.int64)


def local_shard_indices(keys: np.ndarray, n_hosts: int,
                        host_id: int) -> np.ndarray:
    """Row indices this process owns."""
    return np.flatnonzero(partition_rows(keys, n_hosts) == host_id)


def merge_matches(local_indices: Sequence[np.ndarray]) -> np.ndarray:
    """Union of per-process matched row indices, sorted (the single-process
    form of distributed.allgather_matches)."""
    if not local_indices:
        return np.zeros(0, np.int64)
    return np.unique(np.concatenate([np.asarray(i) for i in local_indices]))


def distributed_scan(table_keys: np.ndarray, scan_fn, n_hosts: int,
                     host_id: Optional[int] = None):
    """One process's part of the protocol, or all of it in turn.

    scan_fn(shard_indices) -> matched indices (absolute). With host_id,
    scans that process's part; without, scans every part in turn and
    merges them (a single-process run of the whole protocol)."""
    if host_id is not None:
        return scan_fn(local_shard_indices(table_keys, n_hosts, host_id))
    parts = [scan_fn(local_shard_indices(table_keys, n_hosts, h))
             for h in range(n_hosts)]
    return merge_matches(parts)
