"""cudasp_tpu_torch.scan(device="cpu") against cudasp_tpu.scan on the CPU:
the same row indices on every golden case and on a small seeded table,
plus bind validation, NULL rows, long output lists, the empty table, and
the rule that scan() without a device needs a GPU."""

import numpy as np
import pytest
import torch

import cudasp_tpu
from cudasp_tpu.oracle import ec as JO
from cudasp_tpu.oracle import encoding as JE
from cudasp_tpu.oracle import pipeline as JP
from cudasp_tpu.oracle import vectors as JV

import cudasp_tpu_torch as ct

G = (JO.GX, JO.GY)
SMALL = dict(block_rows=32)     # 128-row batches keep the CPU runs short


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the machine
    (measured: 5x slower for these files), and these tensors are small."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _table(case):
    rows = case.rows
    return {
        "txid": [r.txid for r in rows],
        "height": np.asarray([r.height for r in rows], dtype=np.int32),
        "tweak_key": np.stack([np.frombuffer(r.tweak_blob, np.uint8)
                               for r in rows]),
        "outputs": [list(r.outputs) for r in rows],
    }


def _both(table, key, spend, labels=(), **kw):
    ours = ct.scan(table, key, spend, labels, device="cpu",
                   config=ct.ScanConfig(**SMALL), **kw)
    ref = cudasp_tpu.scan(table, key, spend, labels)
    return ours, ref


@pytest.mark.parametrize("case", JV.CASES, ids=[c.name for c in JV.CASES])
def test_golden_case_same_rows_as_jax(case):
    ours, ref = _both(_table(case), case.scan_key_blob, case.spend_blob,
                      case.label_blobs)
    np.testing.assert_array_equal(ours.indices, ref.indices)
    assert tuple(int(h) for h in ours.height) == case.expected_heights
    assert list(ours.txid) == list(ref.txid)
    for i, idx in enumerate(ours.indices):
        assert bytes(ours.tweak_key[i]) == case.rows[idx].tweak_blob
    m = ours.metrics
    assert (m.rows_in, m.matches, m.upload_mode) == (
        len(case.rows), len(case.expected_heights), "full")


def _seeded_table(seed, n=100, pool=6):
    rng = np.random.default_rng(seed)
    key = int.from_bytes(rng.bytes(32), "big") % JO.N
    spend = JO.ec_mul(G, int(rng.integers(1, 2**62)))
    pts = [JO.ec_mul(G, int(k)) for k in rng.integers(1, 2**62, size=pool)]
    vals = [JP.candidate_values(p, key, spend)[0] for p in pts]
    pick = rng.integers(0, pool, size=n)
    outputs = [list(rng.integers(-2**62, 2**62, size=3)) for _ in range(n)]
    planted = np.flatnonzero(rng.random(n) < 0.2)
    for i in planted:
        outputs[i][int(rng.integers(0, 3))] = vals[pick[i]]
    table = {
        "height": np.arange(n, dtype=np.int64),
        "tweak_key": np.stack([np.frombuffer(JE.point_to_blob64(pts[j]),
                                             np.uint8) for j in pick]),
        "outputs": outputs,
    }
    return table, JE.scalar_to_blob32(key), JE.point_to_blob64(spend), \
        planted


def test_seeded_table_same_rows_as_jax():
    table, key, spend, planted = _seeded_table(11)
    ours, ref = _both(table, key, spend)
    np.testing.assert_array_equal(ours.indices, ref.indices)
    np.testing.assert_array_equal(ours.indices, planted)
    full64 = ct.scan(table, key, spend, device="cpu",
                     config=ct.ScanConfig(upload="full64", **SMALL))
    np.testing.assert_array_equal(full64.indices, planted)
    assert full64.metrics.upload_mode == "full64"


def test_null_rows_skipped_like_jax():
    case = JV.CASES[0]
    row = case.rows[0]                      # matches
    t = {
        "txid": [row.txid, None, row.txid, row.txid],
        "height": [1, 2, None, 4],
        "tweak_key": [row.tweak_blob, row.tweak_blob, row.tweak_blob, None],
        "outputs": [list(row.outputs)] * 4,
    }
    ours, ref = _both(t, case.scan_key_blob, case.spend_blob)
    np.testing.assert_array_equal(ours.indices, ref.indices)
    assert ours.indices.tolist() == [0]


def test_more_than_30_outputs_split_into_virtual_rows():
    case = JV.CASES[0]
    row = case.rows[0]
    outs = list(range(1, 41))
    outs[35] = row.outputs[0]               # the matching value, late
    t = {"tweak_key": [row.tweak_blob, row.tweak_blob],
         "outputs": [outs, list(range(1, 45))]}
    ours, ref = _both(t, case.scan_key_blob, case.spend_blob)
    np.testing.assert_array_equal(ours.indices, ref.indices)
    assert ours.indices.tolist() == [0]
    wide = ct.scan(t, case.scan_key_blob, case.spend_blob, device="cpu",
                   config=ct.ScanConfig(max_outputs=64, **SMALL))
    assert wide.indices.tolist() == [0]
    assert wide.metrics.rows_scanned == 4   # width capped at 30: 2 + 2


def test_empty_table():
    case = JV.CASES[0]
    t = {"tweak_key": np.zeros((0, 64), np.uint8), "outputs": []}
    res = ct.scan(t, case.scan_key_blob, case.spend_blob, device="cpu")
    assert len(res) == 0 and res.tweak_key.shape == (0, 64)
    assert res.metrics.batches == 0


def test_bind_and_ingest_errors():
    case = JV.CASES[0]
    t = _table(case)
    k, s = case.scan_key_blob, case.spend_blob
    with pytest.raises(ct.BindError):
        ct.scan(t, k[:31], s, device="cpu")
    with pytest.raises(ct.BindError):
        ct.scan(t, k, s[:63], device="cpu")
    with pytest.raises(ct.BindError):
        ct.scan(t, k, s, [s[:10]], device="cpu")
    with pytest.raises(ct.BindError):
        ct.scan(t, k, s, batch_size=0, device="cpu")
    with pytest.raises(ct.BindError):
        ct.scan(t, k, s, device="cpu", config=ct.ScanConfig(upload="hi4"))
    with pytest.raises(ct.IngestError):
        ct.scan({"tweak_key": t["tweak_key"]}, k, s, device="cpu")
    with pytest.raises(ct.IngestError):
        ct.scan({"tweak_key": [b"\x01" * 63], "outputs": [[1]]}, k, s,
                device="cpu")


@pytest.mark.parametrize("upload", ["hi4", "exact", "", "full64+hi8",
                                    "full64,hi16", "FULL"])
def test_unknown_upload_is_a_bind_error(upload):
    """Six modes exist; a misspelt one, or full64 joined to a cut (there is
    no such wire: full64 is exact), is refused before any batch runs."""
    case = JV.CASES[0]
    with pytest.raises(ct.BindError, match="upload"):
        ct.scan(_table(case), case.scan_key_blob, case.spend_blob,
                device="cpu", config=ct.ScanConfig(upload=upload))


_UPLOAD_REF = {}


@pytest.mark.parametrize("upload", ["full64", "hi32", "hi16", "hi8", "auto"])
def test_golden_cases_same_rows_as_jax_on_every_upload(upload):
    """Every golden case on each upload mode: the JAX package's rows (a
    cut through its exact second pass; "auto" is "full" on the CPU)."""
    for case in JV.CASES:
        if case.name not in _UPLOAD_REF:
            _UPLOAD_REF[case.name] = cudasp_tpu.scan(
                _table(case), case.scan_key_blob, case.spend_blob,
                case.label_blobs).indices
        ours = ct.scan(_table(case), case.scan_key_blob, case.spend_blob,
                       case.label_blobs, device="cpu",
                       config=ct.ScanConfig(upload=upload, **SMALL))
        np.testing.assert_array_equal(ours.indices, _UPLOAD_REF[case.name])
        assert tuple(int(h) for h in ours.height) == case.expected_heights
        m = ours.metrics
        assert m.upload_mode == ("full" if upload == "auto" else upload)
        if upload in ("hi32", "hi16", "hi8"):
            # every match went through the exact pass (hi16 and hi8 may
            # flag more: their top bits can collide)
            assert m.reverified_rows >= len(case.expected_heights)
        else:
            assert m.reverified_rows == 0


@pytest.mark.parametrize("block_rows", [32, 48, 64, 100])
def test_block_rows_need_not_be_a_multiple_of_32(block_rows):
    """Packed flags need a lane width that is a multiple of 32; other
    widths read int8 flags back, as the reference does. Case 0's batch is
    128 rows wide, padded to a block_rows multiple (144 and 200 take the
    int8 flags); 130 rows make a 256-row batch, 288 wide at block_rows=48,
    which packs."""
    case = JV.CASES[0]
    ours = ct.scan(_table(case), case.scan_key_blob, case.spend_blob,
                   device="cpu", config=ct.ScanConfig(block_rows=block_rows))
    assert tuple(int(h) for h in ours.height) == case.expected_heights
    if block_rows == 48:
        row = case.rows[0]
        t = {"tweak_key": [row.tweak_blob] * 130,
             "outputs": [list(row.outputs)] * 130}
        res = ct.scan(t, case.scan_key_blob, case.spend_blob, device="cpu",
                      config=ct.ScanConfig(block_rows=48))
        assert res.indices.tolist() == list(range(130))


def test_scan_needs_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case = JV.CASES[0]
    t = _table(case)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ct.scan(t, case.scan_key_blob, case.spend_blob)
    with pytest.raises(RuntimeError):
        ct.scan(t, case.scan_key_blob, case.spend_blob, device="cuda")


def test_execution_error_carries_the_batch(monkeypatch):
    """Batch 1 fails, and fails again on its one retry."""
    from cudasp_tpu_torch.ops import kernels as K

    calls = []

    def boom(*a, **kw):
        calls.append(1)
        if len(calls) in (2, 3):
            raise RuntimeError("injected")
        return K.pack_flag_words(torch.zeros((1, a[0].shape[1]),
                                         dtype=torch.int8))

    monkeypatch.setattr(K, "scan_flags", boom)
    table, key, spend, _ = _seeded_table(12, n=600)
    with pytest.raises(ct.ExecutionError) as err:
        ct.scan(table, key, spend, device="cpu",
                batch_size=256,
                config=ct.ScanConfig(**SMALL))
    assert err.value.batch_index == 1
