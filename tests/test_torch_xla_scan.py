"""cudasp_tpu_torch.scan(..., ScanConfig(backend="xla"), device="cpu")
against cudasp_tpu.scan(..., ScanConfig(backend="xla")) on the CPU: the
same rows, bit for bit, with fused False and True, on every golden case,
a seeded table with a label, the adversarial keys and points of
tests/test_pipeline_golden.py, and an off-curve row on which the XLA
backend and the scan kernel's plain version differ on purpose (the
kernel reads only y's parity). Also what the XLA backend does with the
kernel's options (upload, rebalance: nothing, as in the JAX package), its
metrics, and its batch retry. And on the kernel's path, the reference's
ScanConfig(block_rows=None) and tile against the JAX package's."""

import numpy as np
import pytest
import torch

import cudasp_tpu
from cudasp_tpu.oracle import ec as JO
from cudasp_tpu.oracle import encoding as JE
from cudasp_tpu.oracle import pipeline as JP
from cudasp_tpu.oracle import vectors as JV

import cudasp_tpu_torch as ct
from cudasp_tpu_torch.ops import pipeline as PL
from cudasp_tpu_torch.parallel.mesh import make_mesh
from cudasp_tpu_torch.runtime.errors import ExecutionError

G = (JO.GX, JO.GY)
CASES_BY_NAME = {c.name: c for c in JV.CASES}
# 8-row batches: on the CPU the pipeline's cost is its op count, not rows
SMALL = dict(block_rows=8, tile=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker (tests/test_torch_api.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _table(case):
    rows = case.rows
    return {"txid": [r.txid for r in rows],
            "height": np.asarray([r.height for r in rows], np.int64),
            "tweak_key": [r.tweak_blob for r in rows],
            "outputs": [list(r.outputs) for r in rows]}


def _port(table, key, spend, labels=(), fused=False, **kw):
    cfg = {**SMALL, **kw}
    return ct.scan(table, key, spend, labels, device="cpu",
                   config=ct.ScanConfig(backend="xla", fused=fused, **cfg))


def _jax(table, key, spend, labels=(), **kw):
    return cudasp_tpu.scan(table, key, spend, labels,
                           config=cudasp_tpu.ScanConfig(backend="xla", **kw))


@pytest.fixture(scope="module")
def jax_golden():
    """The JAX package's rows of each golden case, scanned once (its
    block_rows=None default)."""
    return {c.name: _jax(_table(c), c.scan_key_blob, c.spend_blob,
                         c.label_blobs, block_rows=None).indices
            for c in JV.CASES}


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
@pytest.mark.parametrize("case", JV.CASES, ids=[c.name for c in JV.CASES])
def test_golden_case_same_rows_as_jax(case, fused, jax_golden):
    res = _port(_table(case), case.scan_key_blob, case.spend_blob,
                case.label_blobs, fused=fused)
    np.testing.assert_array_equal(res.indices, jax_golden[case.name])
    assert tuple(int(h) for h in res.height) == case.expected_heights
    m = res.metrics
    assert (m.upload_mode, m.ladder, m.launch_rows, m.reverified_rows,
            m.batches) == ("full64", "", 8, 0, 1)


@pytest.mark.parametrize("case", JV.CASES, ids=[c.name for c in JV.CASES])
def test_block_rows_none_scans_like_jax(case, jax_golden):
    """The reference's default, the device's row, on the kernel's path;
    the JAX rows are its ScanConfig(block_rows=None) scans."""
    res = ct.scan(_table(case), case.scan_key_blob, case.spend_blob,
                  case.label_blobs, device="cpu",
                  config=ct.ScanConfig(block_rows=None))
    np.testing.assert_array_equal(res.indices, jax_golden[case.name])
    assert tuple(int(h) for h in res.height) == case.expected_heights
    assert res.metrics.launch_rows == 256       # the CPU row's block_rows


def test_tile_caps_the_batches_like_jax(monkeypatch):
    """tile=128 splits 300 rows into 3 batches in both packages, with the
    same rows; CUDASP_TILE does the same when tile is None."""
    monkeypatch.delenv("CUDASP_TILE", raising=False)
    case = JV.CASES[0]
    row = case.rows[0]
    t = {"tweak_key": [row.tweak_blob] * 300,
         "outputs": [[5, 6]] * 299 + [list(row.outputs)]}
    ref = cudasp_tpu.scan(t, case.scan_key_blob, case.spend_blob,
                          config=cudasp_tpu.ScanConfig(tile=128))
    ours = ct.scan(t, case.scan_key_blob, case.spend_blob, device="cpu",
                   config=ct.ScanConfig(tile=128, block_rows=32))
    np.testing.assert_array_equal(ours.indices, ref.indices)
    assert ours.indices.tolist() == [299]
    assert ours.metrics.batches == ref.metrics.batches == 3
    monkeypatch.setenv("CUDASP_TILE", "128")
    env = ct.scan(t, case.scan_key_blob, case.spend_blob, device="cpu",
                  config=ct.ScanConfig(block_rows=32))
    assert (env.indices.tolist(), env.metrics.batches) == ([299], 3)


def _seeded_table(seed, n=40, pool=6):
    rng = np.random.default_rng(seed)
    key = int.from_bytes(rng.bytes(32), "big") % JO.N
    spend = JO.ec_mul(G, int(rng.integers(1, 2**62)))
    label = JO.ec_mul(G, int(rng.integers(1, 2**62)))
    pts = [JO.ec_mul(G, int(k)) for k in rng.integers(1, 2**62, size=pool)]
    vals = [JP.candidate_values(p, key, spend, [label]) for p in pts]
    pick = rng.integers(0, pool, size=n)
    # one output a row and one label: the shapes of a golden label case,
    # whose JAX program this process has compiled already
    outputs = [[int(v)] for v in rng.integers(-2**62, 2**62, size=n)]
    planted = np.flatnonzero(rng.random(n) < 0.3)
    for i in planted:
        outputs[i][0] = vals[pick[i]][i % 2]
    table = {"height": np.arange(n, dtype=np.int64),
             "tweak_key": np.stack([np.frombuffer(
                 JE.point_to_blob64(pts[j]), np.uint8) for j in pick]),
             "outputs": outputs}
    return (table, JE.scalar_to_blob32(key), JE.point_to_blob64(spend),
            [JE.point_to_blob64(label)], planted)


@pytest.fixture(scope="module")
def seeded():
    table, key, spend, labels, planted = _seeded_table(17)
    ref = _jax(table, key, spend, labels).indices
    np.testing.assert_array_equal(ref, planted)
    return table, key, spend, labels, ref


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_seeded_table_same_rows_as_jax(seeded, fused):
    table, key, spend, labels, ref = seeded
    res = _port(table, key, spend, labels, fused=fused, tile=64)
    np.testing.assert_array_equal(res.indices, ref)
    assert (res.metrics.batches, res.metrics.launch_rows) == (1, 64)


def test_adversarial_keys_and_points_same_rows_as_jax():
    """tests/test_pipeline_golden.py's table: scan keys 0 and n send every
    ECDH to infinity (no match), an off-curve tweak never matches, the
    good row does."""
    case = JV.CASES[0]
    row = case.rows[0]
    table = {"height": [1, 2],
             "tweak_key": [row.tweak_blob, bytes(range(64))],
             "outputs": [list(row.outputs), [123, 456]]}
    for k, want in ((0, []), (JO.N, []), (None, [0])):
        kb = case.scan_key_blob if k is None else JE.scalar_to_blob32(k)
        ref = _jax(table, kb, case.spend_blob).indices
        ours = _port(table, kb, case.spend_blob, fused=k == JO.N).indices
        assert ref.tolist() == ours.tolist() == want


def test_off_curve_row_differs_from_the_kernels_plain_version():
    """gecc_case0 with row 0's y + 2 (same parity, off the curve): the XLA
    backend computes on the literal (x, y) and does not match; the scan
    kernel's plain version reads only y's parity and does."""
    case = JV.CASES[0]
    t = _table(case)
    blob = bytearray(t["tweak_key"][0])
    y = int.from_bytes(blob[32:], "little") + 2
    blob[32:] = y.to_bytes(32, "little")
    t["tweak_key"] = [bytes(blob)] + t["tweak_key"][1:]
    ref = _jax(t, case.scan_key_blob, case.spend_blob).indices
    for fused in (False, True):
        ours = _port(t, case.scan_key_blob, case.spend_blob, fused=fused)
        assert ours.indices.tolist() == ref.tolist() == []
    kernel = ct.scan(t, case.scan_key_blob, case.spend_blob, device="cpu",
                     config=ct.ScanConfig(block_rows=32))
    assert kernel.indices.tolist() == [0]


def test_upload_and_rebalance_do_nothing_on_xla():
    """As on the JAX package's XLA backend: a cut upload runs no exact
    pass, rebalance no exchange; a mesh splits each batch over its
    entries, and the rows are the same."""
    case = next(c for c in JV.CASES if c.label_blobs)
    t = _table(case)
    ref = _jax(t, case.scan_key_blob, case.spend_blob, case.label_blobs,
               upload="hi8", rebalance=True).indices
    res = _port(t, case.scan_key_blob, case.spend_blob, case.label_blobs,
                upload="hi8", rebalance=True, tile=16,
                mesh=make_mesh(devices=["cpu"] * 2))
    np.testing.assert_array_equal(res.indices, ref)
    assert tuple(int(h) for h in res.height) == case.expected_heights
    m = res.metrics
    assert (m.upload_mode, m.reverified_rows, m.exchange_bytes,
            m.n_devices, m.launch_rows) == ("full64", 0, 0, 2, 16)


def test_batch_retry_then_execution_error_on_xla(monkeypatch):
    case = JV.CASES[0]
    t = _table(case)
    real = PL.scan_batch
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected fault")
        return real(*a, **kw)

    monkeypatch.setattr(PL, "scan_batch", flaky)
    res = _port(t, case.scan_key_blob, case.spend_blob)
    assert res.indices.tolist() == [0]
    assert (res.metrics.batch_retries, len(calls)) == (1, 2)

    def broken(*a, **kw):
        raise RuntimeError("injected fault")

    monkeypatch.setattr(PL, "scan_batch", broken)
    with pytest.raises(ExecutionError) as err:
        _port(t, case.scan_key_blob, case.spend_blob)
    assert err.value.batch_index == 0


def test_stream_and_sql_reach_the_xla_backend(monkeypatch):
    """scan_stream and the SQL engine pass their ScanConfig through to the
    XLA backend: the same rows, every batch through ops/pipeline.py."""
    from cudasp_tpu_torch.sql import SQLEngine

    calls = []
    real = PL.scan_batch
    monkeypatch.setattr(PL, "scan_batch",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    case = CASES_BY_NAME["label_distinct"]
    t = _table(case)
    cfg = ct.ScanConfig(backend="xla", **SMALL)
    res = ct.scan_stream([t], case.scan_key_blob, case.spend_blob,
                         case.label_blobs, config=cfg, device="cpu")
    assert tuple(int(h) for h in res.height) == case.expected_heights
    assert res.metrics.upload_mode == "full64" and len(calls) == 1

    def blob(b):
        return "BLOB '" + "".join(f"\\x{v:02x}" for v in b) + "'"

    eng = SQLEngine(scan_fn=lambda *a, **kw: ct.scan(*a, device="cpu", **kw),
                    default_config=cfg)
    eng.execute("CREATE TABLE t (txid BLOB, height INTEGER, tweak_key BLOB, "
                "outputs BIGINT[])")
    for r in case.rows:
        eng.execute(f"INSERT INTO t VALUES ({blob(r.txid)}, {r.height}, "
                    f"{blob(r.tweak_blob)}, "
                    f"[{', '.join(map(str, r.outputs))}])")
    rows = eng.execute(
        f"SELECT height FROM cudasp_scan((SELECT * FROM t), "
        f"{blob(case.scan_key_blob)}, {blob(case.spend_blob)}, "
        f"[{', '.join(blob(lb) for lb in case.label_blobs)}])")
    assert tuple(r[0] for r in rows) == case.expected_heights
    assert len(calls) == 2


def test_unknown_backend_is_a_bind_error():
    case = JV.CASES[0]
    with pytest.raises(ct.BindError, match="backend"):
        ct.scan(_table(case), case.scan_key_blob, case.spend_blob,
                device="cpu", config=ct.ScanConfig(backend="cuda"))
