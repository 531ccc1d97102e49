"""The multi-process scan of cudasp_tpu_torch.parallel.distributed on the
CPU: single-process (the merge is the identity and multihost_scan equals
scan, as the JAX package's tests/test_distributed.py holds it), and two
real processes on torch.distributed's gloo backend over a localhost
rendezvous, each scanning its hash part of a 16-row table and merging the
matches (the shape of tests/test_multiprocess.py), with 32-byte txids and
with integer txids, which the port partitions by value."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import cudasp_tpu
from cudasp_tpu.oracle import vectors as JV
from cudasp_tpu.parallel import partition as JP

import cudasp_tpu_torch as ct
from cudasp_tpu_torch.parallel import distributed as D
from cudasp_tpu_torch.parallel import partition as TP
from cudasp_tpu_torch.parallel.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(block_rows=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _table(case, n):
    """n rows cycling through a golden case, with distinct 32-byte txids,
    and the rows that match."""
    rows = case.rows
    txid = np.zeros((n, 32), np.uint8)
    for j in range(n):
        t = rows[j % len(rows)].txid or bytes([j % 256]) * 32
        txid[j, :len(t[:32])] = np.frombuffer(t[:32], np.uint8)
        txid[j, 0] ^= j & 0xFF
    return {
        "txid": txid,
        "height": np.asarray([rows[j % len(rows)].height for j in range(n)],
                             np.int32),
        "tweak_key": np.stack([np.frombuffer(rows[j % len(rows)].tweak_blob,
                                             np.uint8) for j in range(n)]),
        "outputs": [list(rows[j % len(rows)].outputs) for j in range(n)],
    }, sorted(j for j in range(n)
              if rows[j % len(rows)].height in case.expected_heights)


def test_single_process_info_and_merge():
    assert D.host_info() == (0, 1)
    D.init()                                    # single-process: a no-op
    D.init(num_processes=1)
    assert D.host_info() == (0, 1)
    assert D.allgather_matches(np.asarray([5, 3, 5, 9])).tolist() == [3, 5, 9]
    assert D.local_mesh("cpu").devices == (torch.device("cpu"),)


@pytest.mark.parametrize("mesh_entries", [None, 4], ids=["local", "mesh4"])
def test_multihost_scan_single_process(mesh_entries):
    """process count 1: multihost_scan equals the golden rows, on the
    local (one-entry CPU) mesh and on a 4-entry mesh from the config; the
    caller's config is left as it was."""
    case = JV.CASES[3]
    table, expect = _table(case, 120)
    cfg = ct.ScanConfig(**SMALL, mesh=None if mesh_entries is None else
                        make_mesh(devices=["cpu"] * mesh_entries))
    mesh = cfg.mesh
    idx = D.multihost_scan(table, case.scan_key_blob, case.spend_blob,
                           case.label_blobs, config=cfg, device="cpu")
    assert idx.tolist() == expect
    assert cfg.mesh is mesh


def test_simulated_multihost_scan_matches_single():
    """The table split four ways by the hash partition (the same parts as
    the JAX package's), each part scanned on its own, and merged: equal
    to the unpartitioned rows."""
    case = JV.CASES[0]
    table, expect = _table(case, 240)
    for h in range(4):
        np.testing.assert_array_equal(
            TP.local_shard_indices(table["txid"], 4, h),
            JP.local_shard_indices(table["txid"], 4, h))

    def scan_part(idx):
        part = {k: (v[idx] if isinstance(v, np.ndarray)
                    else [v[int(i)] for i in idx]) for k, v in table.items()}
        res = ct.scan(part, case.scan_key_blob, case.spend_blob,
                      device="cpu", config=ct.ScanConfig(**SMALL))
        return idx[res.indices]

    merged = TP.distributed_scan(table["txid"], scan_part, n_hosts=4)
    assert merged.tolist() == expect


_WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
from cudasp_tpu_torch.oracle import vectors as V
from cudasp_tpu_torch.parallel import distributed as D
import cudasp_tpu_torch as ct

pid, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
D.init(coordinator_address=f"127.0.0.1:{port}", num_processes=n,
       process_id=pid)
assert D.host_info() == (pid, n), D.host_info()
case = V.CASES[0]
rows = case.rows * 8                         # 16 rows across 2 processes
table = {
    "txid": [bytes([i]) * 32 for i in range(len(rows))],
    "height": [r.height for r in rows],
    "tweak_key": [r.tweak_blob for r in rows],
    "outputs": [list(r.outputs) for r in rows],
}
matches = D.multihost_scan(table, case.scan_key_blob, case.spend_blob,
                           case.label_blobs or [], device="cpu",
                           config=ct.ScanConfig(block_rows=8))
expect = sorted(i for i, r in enumerate(rows)
                if r.height in case.expected_heights)
got = sorted(int(i) for i in matches)
print(f"proc{pid}: {'OK' if got == expect else f'FAIL {got} != {expect}'}",
      flush=True)
assert got == expect
torch.distributed.destroy_process_group()
"""


def _two_processes(worker):
    """Run `worker` as processes 0 and 1 of a gloo group; their stdout."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(pid), "2", port], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-2000:]}"
    return [out for out, _ in outs]


def test_two_process_gloo_multihost_scan():
    for out in _two_processes(_WORKER):
        assert "OK" in out


_INT_ROWS = 16
_INT_WORKER = r"""
import json
import sys
import torch
torch.set_num_threads(1)
from cudasp_tpu_torch.oracle import vectors as V
from cudasp_tpu_torch.parallel import distributed as D
from cudasp_tpu_torch.parallel import partition
import cudasp_tpu_torch as ct

pid, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
D.init(coordinator_address=f"127.0.0.1:{port}", num_processes=n,
       process_id=pid)
case = V.CASES[0]
rows = case.rows * 8
table = {
    "txid": [1000 + 7919 * i for i in range(len(rows))],
    "height": [r.height for r in rows],
    "tweak_key": [r.tweak_blob for r in rows],
    "outputs": [list(r.outputs) for r in rows],
}
mine = partition.local_shard_indices(D._partition_keys(table["txid"]), n,
                                     pid)
matches = D.multihost_scan(table, case.scan_key_blob, case.spend_blob,
                           device="cpu", config=ct.ScanConfig(block_rows=8))
print(json.dumps({"rows": len(mine), "matches": matches.tolist()}))
torch.distributed.destroy_process_group()
"""


def test_two_process_gloo_multihost_scan_integer_txids():
    """Integer txids spread over both processes (the JAX package keys them
    as bytes(v), v zero bytes: one part for every id >= 32); the gathered
    indices equal the JAX package's scan of the same table."""
    rows = JV.CASES[0].rows * 8
    table = {"txid": [1000 + 7919 * i for i in range(_INT_ROWS)],
             "height": [r.height for r in rows],
             "tweak_key": [r.tweak_blob for r in rows],
             "outputs": [list(r.outputs) for r in rows]}
    case = JV.CASES[0]
    ref = cudasp_tpu.scan(table, case.scan_key_blob, case.spend_blob)
    res = [json.loads(out.splitlines()[-1])
           for out in _two_processes(_INT_WORKER)]
    assert all(r["rows"] > 0 for r in res)
    assert sum(r["rows"] for r in res) == _INT_ROWS
    for r in res:
        assert r["matches"] == ref.indices.tolist() == list(range(0, 16, 2))


@pytest.mark.parametrize("col", [
    [5, None, 2**64 - 1, -1],
    np.asarray([5, 0, -1, -1], np.int64),
    np.asarray([5, 0, 2**64 - 1, 2**64 - 1], np.uint64),
], ids=["list", "int64", "uint64"])
def test_integer_partition_keys_by_value(col):
    """Integers key the partition by value (NULL as 0, negatives as two's
    complement); bytes, and uint8 matrices, as before."""
    keys = D._partition_keys(col)
    assert keys.dtype == np.uint64
    assert keys.tolist() == [5, 0, 2**64 - 1, 2**64 - 1]
    raw = D._partition_keys([b"\x01\x02", None])
    assert raw.shape == (2, 32) and raw[0, :2].tolist() == [1, 2]
    mat = np.ones((3, 32), np.uint8)
    assert D._partition_keys(mat) is mat
