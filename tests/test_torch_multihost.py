"""The multi-process scan of cudasp_tpu_torch.parallel.distributed on the
CPU: single-process (the merge is the identity and multihost_scan equals
scan, as the JAX package's tests/test_distributed.py holds it), and two
real processes on torch.distributed's gloo backend over a localhost
rendezvous, each scanning its hash part of a 16-row table and merging the
matches (the shape of tests/test_multiprocess.py)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

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


def test_two_process_gloo_multihost_scan():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(pid), "2", port], env=env,
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
        assert "OK" in out
