"""Tracing, the metrics line and batch retry of the port, on the CPU: the
CUDASP_METRICS line carries every key of the JAX package's, a
CUDASP_PROFILE_DIR trace holds the executor's named spans, and a batch
that fails once runs again (batch_retries) while one that fails twice
raises ExecutionError naming it, as tests/test_runtime.py pins for the
JAX package's executor."""

import glob
import json

import numpy as np
import pytest
import torch

import cudasp_tpu
from cudasp_tpu.oracle import vectors as JV

import cudasp_tpu_torch as ct
from cudasp_tpu_torch.io import ingest
from cudasp_tpu_torch.ops import kernels as K
from cudasp_tpu_torch.runtime import executor as X
from cudasp_tpu_torch.runtime.metrics import ScanMetrics

SPANS = ("cudasp.pack", "cudasp.stage_h2d", "cudasp.launch", "cudasp.wait")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _table(case):
    rows = case.rows
    return {"txid": [r.txid for r in rows],
            "height": [r.height for r in rows],
            "tweak_key": [r.tweak_blob for r in rows],
            "outputs": [list(r.outputs) for r in rows]}


def _metrics_line(err):
    lines = [json.loads(ln) for ln in err.splitlines()
             if ln.startswith("{") and '"scan_metrics"' in ln]
    assert len(lines) == 1, err
    return lines[0]


def test_metrics_line_has_every_key_of_the_jax_line(monkeypatch, capsys):
    case = JV.CASES[1]
    monkeypatch.setenv("CUDASP_METRICS", "1")
    res = ct.scan(_table(case), case.scan_key_blob, case.spend_blob,
                  device="cpu", config=ct.ScanConfig(block_rows=32))
    ours = _metrics_line(capsys.readouterr().err)
    cudasp_tpu.scan(_table(case), case.scan_key_blob, case.spend_blob)
    ref = _metrics_line(capsys.readouterr().err)
    assert set(ref) <= set(ours), set(ref) - set(ours)
    assert ours["event"] == "scan_metrics"
    assert (ours["rows_in"], ours["matches"]) == (
        len(case.rows), len(case.expected_heights))
    assert ours["batch_size"] == ct.api.DEFAULT_BATCH_SIZE == \
        ref["batch_size"]
    assert ours["launch_rows"] == 128
    assert (ours["batch_retries"], ours["prewarm_failures"],
            ours["warm_variants"]) == (0, 0, 0)
    assert ours["total_seconds"] > 0
    assert res.metrics.as_dict() == {k: v for k, v in ours.items()
                                     if k != "event"}


def test_no_metrics_line_unless_asked(monkeypatch, capsys):
    case = JV.CASES[0]
    monkeypatch.delenv("CUDASP_METRICS", raising=False)
    monkeypatch.delenv("CUDASP_PROFILE_DIR", raising=False)
    ct.scan(_table(case), case.scan_key_blob, case.spend_blob, device="cpu",
            config=ct.ScanConfig(block_rows=32))
    assert "scan_metrics" not in capsys.readouterr().err


@pytest.mark.parametrize("upload", ["full", "hi8"])
def test_profile_dir_trace_holds_the_spans(monkeypatch, tmp_path, upload):
    """A trace file per scan, with the executor's spans (CPU activities
    here); a cut wire adds the exact pass."""
    case = JV.CASES[0]
    monkeypatch.setenv("CUDASP_PROFILE_DIR", str(tmp_path))
    res = ct.scan(_table(case), case.scan_key_blob, case.spend_blob,
                  device="cpu",
                  config=ct.ScanConfig(block_rows=32, upload=upload))
    assert tuple(int(h) for h in res.height) == case.expected_heights
    files = glob.glob(str(tmp_path / "scan-*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    want = SPANS + (("cudasp.exact_pass",) if upload == "hi8" else ())
    assert set(want) <= names, set(want) - names


def _batches(n):
    case = JV.CASES[0]
    blobs = np.tile(np.frombuffer(case.rows[0].tweak_blob, np.uint8), (n, 1))
    flat = np.arange(3 * n, dtype=np.int64)
    offsets = np.arange(n + 1, dtype=np.int64) * 3
    sched, spend, labels, _ = ingest.pack_query_keys(
        case.scan_key_blob, case.spend_blob, [])
    return (ingest.iter_packed(blobs, flat, offsets, batch_size=128,
                               max_outputs=3), sched, spend, labels)


def _live_rows_match(tw, oh, ol, ovm, *a, pack_flags=False, **kw):
    """A stand-in for the launch: every live row matches."""
    flags = ((ovm >> 31) & 1).to(torch.int8)
    return K.pack_flag_words(flags) if pack_flags else flags


@pytest.mark.parametrize("where", ["launch", "wait"])
def test_batch_retry_transient_fault(monkeypatch, where):
    """Batch 1 fails once, at its launch or at its result (where a fault
    of the card shows): it runs again from its PackedBatch, counted in
    batch_retries, and no row is lost. Failing twice raises
    ExecutionError(1)."""
    n = 3 * 128
    state = {"calls": 0, "fail_at": {2}}
    if where == "launch":
        def flaky(*a, **kw):
            state["calls"] += 1
            if state["calls"] in state["fail_at"]:
                raise RuntimeError("injected transient fault")
            return _live_rows_match(*a, **kw)
        monkeypatch.setattr(K, "scan_flags", flaky)
    else:
        monkeypatch.setattr(K, "scan_flags", _live_rows_match)
        wait = X._Cpu.wait

        def flaky(self, slot, outs, metrics):
            state["calls"] += 1
            if state["calls"] in state["fail_at"]:
                raise RuntimeError("injected transient fault")
            return wait(self, slot, outs, metrics)
        monkeypatch.setattr(X._Cpu, "wait", flaky)
    batches, sched, spend, labels = _batches(n)
    m = ScanMetrics()
    results = X.BatchExecutor("cpu", block_rows=32).run(
        batches, sched, spend, labels, metrics=m)
    assert m.batch_retries == 1 and m.batches == 3
    got = np.concatenate([srcs[fl & (srcs >= 0)] for fl, srcs in results])
    np.testing.assert_array_equal(got, np.arange(n))

    state["calls"], state["fail_at"] = 0, {2, 3}
    batches, sched, spend, labels = _batches(n)
    m = ScanMetrics()
    with pytest.raises(ct.ExecutionError) as err:
        X.BatchExecutor("cpu", block_rows=32).run(
            batches, sched, spend, labels, metrics=m)
    assert err.value.batch_index == 1
    assert "batch 1 failed" in str(err.value)
    assert "injected transient fault" in str(err.value.cause)
    assert m.batch_retries == 1


def test_batch_retry_through_scan(monkeypatch):
    """The same through scan(): the metrics of the result count the retry,
    and the rows are the golden case's."""
    case = JV.CASES[0]
    calls = []
    real = K.scan_flags

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected transient fault")
        return real(*a, **kw)
    monkeypatch.setattr(K, "scan_flags", flaky)
    res = ct.scan(_table(case), case.scan_key_blob, case.spend_blob,
                  device="cpu", config=ct.ScanConfig(block_rows=32))
    assert tuple(int(h) for h in res.height) == case.expected_heights
    assert res.metrics.batch_retries == 1 and len(calls) == 2
