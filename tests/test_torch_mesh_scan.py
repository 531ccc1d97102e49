"""cudasp_tpu_torch.scan over a mesh on the CPU: ScanConfig(mesh=<4 CPU
entries>) gives the mesh-less scan's rows and the golden heights on every
golden case, plain, through the row exchange (rebalance=True) and on the
hi8 cut with its exact pass; a device that disagrees with the mesh is a
BindError; and the executor's exchange glue maps every row back through
its source-row planes (the JAX package's tests/test_exchange.py:83-120,
with a stub kernel)."""

import numpy as np
import pytest
import torch

from cudasp_tpu.oracle import vectors as JV

import cudasp_tpu_torch as ct
from cudasp_tpu_torch.ops import kernels as TK
from cudasp_tpu_torch.parallel.mesh import Mesh, make_mesh
from cudasp_tpu_torch.runtime import executor as TX

SMALL = dict(block_rows=8)      # 128-row batches: 4 shards of 32 lanes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _table(case, n=None):
    rows = [case.rows[j % len(case.rows)] for j in range(n or len(case.rows))]
    return {
        "height": np.asarray([r.height for r in rows], dtype=np.int64),
        "tweak_key": np.stack([np.frombuffer(r.tweak_blob, np.uint8)
                               for r in rows]),
        "outputs": [list(r.outputs) for r in rows],
    }


def _scan(case, **cfg):
    return ct.scan(_table(case), case.scan_key_blob, case.spend_blob,
                   case.label_blobs, device="cpu",
                   config=ct.ScanConfig(**SMALL, **cfg))


@pytest.mark.parametrize("case", JV.CASES, ids=[c.name for c in JV.CASES])
def test_mesh_scan_equal_to_mesh_less_on_golden_cases(case):
    mesh = make_mesh(devices=["cpu"] * 4)
    ref = _scan(case)
    for cfg in ({}, {"rebalance": True}, {"upload": "hi8"}):
        res = _scan(case, mesh=mesh, **cfg)
        np.testing.assert_array_equal(res.indices, ref.indices)
        assert tuple(int(h) for h in res.height) == case.expected_heights
        m = res.metrics
        assert m.n_devices == 4 and m.launch_rows == 128
        assert m.upload_mode == cfg.get("upload", "full")
        if cfg.get("upload") == "hi8":
            assert m.reverified_rows >= len(case.expected_heights)


def test_device_that_disagrees_with_the_mesh_is_a_bind_error():
    case = JV.CASES[0]
    cuda_mesh = Mesh(["cuda:0"] * 2)
    with pytest.raises(ct.BindError, match="mesh"):
        ct.scan(_table(case), case.scan_key_blob, case.spend_blob,
                device="cpu", config=ct.ScanConfig(mesh=cuda_mesh))
    with pytest.raises(ct.BindError, match="mesh"):
        ct.scan(_table(case), case.scan_key_blob, case.spend_blob,
                device="cuda", config=ct.ScanConfig(
                    mesh=make_mesh(devices=["cpu"] * 2)))
    # a CPU mesh decides where the scan runs; "cpu" agrees with it
    res = ct.scan(_table(case), case.scan_key_blob, case.spend_blob,
                  config=ct.ScanConfig(mesh=make_mesh(devices=["cpu"]),
                                       **SMALL))
    assert tuple(int(h) for h in res.height) == case.expected_heights


@pytest.mark.parametrize("rebalance", [True, False],
                         ids=["rebalance", "plain"])
def test_exchange_glue_maps_every_row_back(monkeypatch, rebalance):
    """300 ragged rows over an 8-entry mesh with a stub kernel under which
    every live row matches: through the exchange, the source-row planes
    bring every row back (indices == range(300)), as in the JAX
    package's own glue test."""
    calls = []

    def live_rows_match(tw, oh, ol, ovm, *a, pack_flags=False, **kw):
        calls.append(tw.shape[1])
        flags = ((ovm >> 31) & 1).to(torch.int8)
        return TK.pack_flag_words(flags) if pack_flags else flags

    monkeypatch.setattr(TK, "scan_flags", live_rows_match)
    case = JV.CASES[0]
    n = 300
    res = ct.scan(_table(case, n), case.scan_key_blob, case.spend_blob,
                  device="cpu", config=ct.ScanConfig(
                      mesh=make_mesh(devices=["cpu"] * 8),
                      rebalance=rebalance, block_rows=64))
    assert res.indices.tolist() == list(range(n))
    assert res.metrics.rows_scanned == n
    # 512 lanes, 64 a shard; without the exchange the 300 live rows fill
    # the first five shards and the others are skipped as padding
    assert calls == [64] * (8 if rebalance else 5)
    if rebalance:
        # tweak words, outputs hi and lo, ovm, the two source-row planes
        M = max(len(r.outputs) for r in case.rows)
        assert res.metrics.exchange_bytes == 4 * 512 * (8 + 2 * M + 1 + 2)


class _TimedCpu(TX._Cpu):
    """The plain version with a card's timings faked per entry: a 50 MB/s
    link each, and entry k's kernel (k + 1) us, so "auto" runs its loop
    on a CPU mesh, link-bound."""

    timed = True
    made = 0

    def __init__(self, device):
        super().__init__(device)
        self.k = _TimedCpu.made
        _TimedCpu.made += 1

    def stage(self, wire, bmask):
        _, ops, bm, staged, _ = super().stage(wire, bmask)
        sent = sum(p.nbytes for p in wire)
        return {"sent": sent}, ops, bm, staged, sent

    def wait(self, slot, outs, metrics):
        return ([o.numpy() for o in outs], slot["sent"] / 50e6,
                (self.k + 1) * 1e-6)


def test_auto_on_a_mesh_models_the_slowest_entry(monkeypatch):
    """On a 2-entry mesh, "auto" reads the slowest entry's kernel time and
    the batch's bytes over the longest H2D (twice one entry's link), cuts
    to hi8 from the first batch the feeder packs after batch 0's times,
    keeps the rows exact through the exact pass, and memoizes per
    mesh."""
    monkeypatch.setattr(TX, "_Cpu", _TimedCpu)
    monkeypatch.setattr(TX.BatchExecutor, "_auto_memo", TX.OrderedDict())
    _TimedCpu.made = 0
    case = JV.CASES[0]          # row 0 matches, row 1 does not
    assert case.expected_heights == (case.rows[0].height,)
    pick = [0 if j % 64 == 0 else 1 for j in range(1024)]  # 1.6% match
    table = {"tweak_key": np.stack([np.frombuffer(
                 case.rows[k].tweak_blob, np.uint8) for k in pick]),
             "outputs": [list(case.rows[k].outputs) for k in pick]}
    mesh = make_mesh(devices=["cpu"] * 2)
    res = ct.scan(table, case.scan_key_blob, case.spend_blob, device="cpu",
                  batch_size=128, config=ct.ScanConfig(mesh=mesh, **SMALL))
    assert res.indices.tolist() == list(range(0, 1024, 64))
    m = res.metrics
    # batches 0 and 1 ship full (batch 1 is packed before batch 0's times
    # are read); the feeder packs at most QUEUE_DEPTH + 3 batches ahead of
    # the decision, so batches 6 and 7 at least ship hi8, and their
    # matches (two a batch) pass the exact pass
    assert TX.QUEUE_DEPTH + 3 <= 6
    assert m.batches == 8 and m.upload_mode == "hi8"
    assert m.reverified_rows >= 4
    assert m.kernel0_seconds == pytest.approx(2e-6)
    assert m.link_bytes_per_second == pytest.approx(100e6)
    M = max(len(r.outputs) for r in case.rows)
    assert TX.BatchExecutor._auto_memo[("fixed", 128, M, mesh)] == (
        pytest.approx(2e-6), "hi8")
