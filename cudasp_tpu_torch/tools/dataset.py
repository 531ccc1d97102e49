"""The tools' synthetic table: the counterpart of the JAX package's root
bench.py make_dataset (bench.py:35-86), with the same signature and the
same arrays for the same arguments, from the port's own oracle.

Rows cycle through a pool of `pool` distinct tweak points (scalars drawn
from `seed`); every match_every-th row carries its point's true upper-64
value in its first output slot, the rest random values. The pool's
oracle work (~25 ms a point) is cached under build/cudasp_tpu_torch/
(POOL_CACHE_DIR), never under the JAX package's directory.

    tweaks, flat, offsets, is_match = make_dataset(
        1_000_000, pool=256, scan_key=key_int, spend=spend_point)
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from ..oracle import ec as O
from ..oracle import vectors as V
from ..oracle.encoding import blob32_to_scalar, blob64_to_point, \
    point_to_blob64
from ..oracle.pipeline import candidate_values

POOL_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "build",
    "cudasp_tpu_torch")


def pool_points(pool, seed, scan_key, spend):
    """(blobs (pool, 64) uint8, values (pool,) int64): the pool's points
    and their true upper-64 values, cached on disk by (pool, seed, key,
    spend) as bench.py's _pool_points keys them."""
    key = hashlib.sha256(
        f"{pool}|{seed}|{scan_key}|{spend}".encode()).hexdigest()[:16]
    cache = os.path.join(POOL_CACHE_DIR, f"benchpool_{key}.npz")
    if os.path.exists(cache):
        with np.load(cache) as d:
            return d["blobs"], d["values"]
    rng = np.random.default_rng(seed)
    g = (O.GX, O.GY)
    points = [O.ec_mul(g, int(k)) for k in rng.integers(1, 2**62,
                                                         size=pool)]
    blobs = np.stack([np.frombuffer(point_to_blob64(p), np.uint8)
                      for p in points])
    values = np.asarray([candidate_values(p, scan_key, spend)[0]
                         for p in points], np.int64)
    os.makedirs(POOL_CACHE_DIR, exist_ok=True)
    tmp = f"{cache}.{os.getpid()}.tmp.npz"
    np.savez_compressed(tmp, blobs=blobs, values=values)
    os.replace(tmp, cache)
    return blobs, values


def make_dataset(n_rows, pool=256, match_every=100, outputs_per_row=3,
                 seed=7, scan_key=None, spend=None):
    """(tweaks (n_rows, 64) uint8, flat outputs int64, offsets (n_rows + 1,)
    int64, is_match (n_rows,) bool), as bench.make_dataset returns them.
    scan_key: the scan key as an int; spend: the spend point (x, y)."""
    blobs, values = pool_points(pool, seed, scan_key, spend)
    rng = np.random.default_rng(seed)
    rng.integers(1, 2**62, size=pool)          # the pool's draws, as there
    row_pool = rng.integers(0, pool, size=n_rows)
    tweaks = blobs[row_pool]
    flat = rng.integers(-2**62, 2**62, size=n_rows * outputs_per_row,
                        dtype=np.int64)
    offsets = np.arange(n_rows + 1, dtype=np.int64) * outputs_per_row
    is_match = np.zeros(n_rows, bool)
    is_match[::match_every] = True
    flat[offsets[:-1][is_match]] = values[row_pool[is_match]]
    return tweaks, flat, offsets, is_match


def bip352_query():
    """(scan key blob, spend blob, scan key int, spend point): the golden
    BIP-352 query the JAX tools scan their tables with."""
    return (V.SCAN_KEY_BIP352, V.SPEND_BIP352,
            blob32_to_scalar(V.SCAN_KEY_BIP352),
            blob64_to_point(V.SPEND_BIP352))


def bip352_table(n_rows, pool=256, seed=7):
    """(table for scan(), expected row indices) of make_dataset under the
    BIP-352 query."""
    _, _, k, sp = bip352_query()
    tweaks, flat, offsets, is_match = make_dataset(
        n_rows, pool=pool, seed=seed, scan_key=k, spend=sp)
    return ({"tweak_key": tweaks, "outputs": (flat, offsets)},
            np.flatnonzero(is_match))
