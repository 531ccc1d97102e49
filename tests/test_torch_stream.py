"""cudasp_tpu_torch.scan_stream, ScanCursor and scan_resumable against the
JAX package's on the CPU: the same rows and columns from the same chunks,
the same cursor file byte for byte, and a cursor that either package
saved mid-stream finished by the other. The port runs device="cpu" (the
kernel's plain version); the JAX package runs one batch shape (128 rows)
throughout, so its XLA compile is paid once."""

import functools

import numpy as np
import pytest
import torch

import cudasp_tpu
from cudasp_tpu.oracle import ec as JO
from cudasp_tpu.oracle import encoding as JE
from cudasp_tpu.oracle import pipeline as JP
from cudasp_tpu.oracle import vectors as JV
from cudasp_tpu.runtime import checkpoint as JC

import cudasp_tpu_torch as ct
from cudasp_tpu_torch.runtime import checkpoint as TC

G = (JO.GX, JO.GY)
N_ROWS = 300


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg():
    return ct.ScanConfig(block_rows=32, batch_size=128)


def _jcfg():
    return cudasp_tpu.ScanConfig(batch_size=128)


def _golden_table(case):
    rows = case.rows
    return {"txid": [r.txid for r in rows],
            "height": np.asarray([r.height for r in rows], np.int64),
            "tweak_key": [r.tweak_blob for r in rows],
            "outputs": [list(r.outputs) for r in rows]}


class Killed(Exception):
    """The chunk source dies."""


@functools.lru_cache(maxsize=1)
def _random_table(seed=21, n=N_ROWS, pool=5):
    rng = np.random.default_rng(seed)
    key = int.from_bytes(rng.bytes(32), "big") % JO.N
    spend = JO.ec_mul(G, int(rng.integers(1, 2**62)))
    pts = [JO.ec_mul(G, int(k)) for k in rng.integers(1, 2**62, size=pool)]
    vals = [JP.candidate_values(p, key, spend)[0] for p in pts]
    pick = rng.integers(0, pool, size=n)
    outputs = [[int(v) for v in rng.integers(-2**62, 2**62, size=3)]
               for _ in range(n)]
    planted = np.flatnonzero(rng.random(n) < 0.1)
    for i in planted:
        outputs[i][int(rng.integers(0, 3))] = int(vals[pick[i]])
    table = {
        "txid": [rng.bytes(32) for _ in range(n)],
        "height": np.arange(n, dtype=np.int64) + 800_000,
        "tweak_key": np.stack([np.frombuffer(JE.point_to_blob64(pts[j]),
                                             np.uint8) for j in pick]),
        "outputs": outputs,
    }
    return table, JE.scalar_to_blob32(key), JE.point_to_blob64(spend), \
        planted


def _chunks(table, rows, stop_after=None, cursor=None, path=None):
    """The table in `rows`-row chunks; with a cursor, saved to `path`
    before each chunk is handed out (the one before it is then done) and
    at the end; stop_after: raise once that many chunks are done."""
    n = len(table["tweak_key"])
    for k, a in enumerate(range(0, n, rows)):
        if cursor is not None and k:
            cursor.save(path)
        if stop_after is not None and k == stop_after:
            raise Killed
        yield {name: c[a:a + rows] for name, c in table.items()}
    if cursor is not None:
        cursor.save(path)


def _same(ours, ref):
    np.testing.assert_array_equal(ours.indices, ref.indices)
    assert [bytes(t) for t in ours.txid] == [bytes(t) for t in ref.txid]
    np.testing.assert_array_equal(np.asarray(ours.height, np.int64),
                                  np.asarray(ref.height, np.int64))
    np.testing.assert_array_equal(np.asarray(ours.tweak_key),
                                  np.asarray(ref.tweak_key))


_FRESH = {}


def _fresh_jax():
    """The JAX package's scan_stream over the random table in 100-row
    chunks, with its cursor (computed once)."""
    if not _FRESH:
        table, key, spend, _ = _random_table()
        cur = JC.ScanCursor()
        _FRESH["res"] = cudasp_tpu.scan_stream(
            _chunks(table, 100), key, spend, config=_jcfg(), checkpoint=cur)
        _FRESH["cursor"] = cur
    return _FRESH["res"], _FRESH["cursor"]


@pytest.mark.parametrize("case", JV.CASES, ids=[c.name for c in JV.CASES])
def test_golden_case_stream_same_as_jax(case):
    """One row a chunk: every golden case's rows and columns."""
    t = _golden_table(case)
    args = (case.scan_key_blob, case.spend_blob, case.label_blobs)
    ours = ct.scan_stream(_chunks(t, 1), *args, config=_cfg(),
                          device="cpu")
    ref = cudasp_tpu.scan_stream(_chunks(t, 1), *args, config=_jcfg())
    _same(ours, ref)
    assert tuple(int(h) for h in ours.height) == case.expected_heights
    assert ours.metrics.rows_in == len(case.rows)


def test_random_table_stream_and_cursor_same_as_jax(tmp_path):
    """300 rows in 100-row chunks: the same rows and columns, and the two
    cursors' files byte for byte (format, digest, match_rows)."""
    table, key, spend, planted = _random_table()
    ref, jcur = _fresh_jax()
    cur = ct.ScanCursor()
    ours = ct.scan_stream(_chunks(table, 100), key, spend, config=_cfg(),
                          checkpoint=cur, device="cpu")
    _same(ours, ref)
    np.testing.assert_array_equal(ours.indices, planted)
    m = ours.metrics
    assert (m.rows_in, m.rows_scanned, m.batches, m.matches) == (
        N_ROWS, N_ROWS, 3, len(planted))
    assert (m.batch_size, m.launch_rows) == (128, 128)
    cur.save(str(tmp_path / "port.json"))
    jcur.save(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    assert TC._query_digest(key, spend, []) == cur.query_digest


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cursor_resumes_across_packages(tmp_path, writer):
    """One package scans two 100-row chunks, saves its cursor and dies; the
    other loads the file and finishes in 64-row chunks (the cursor lands
    inside a chunk): the result equals a fresh run, indices and all three
    columns, and the resumed run scanned only the uncovered rows."""
    table, key, spend, _ = _random_table()
    path = str(tmp_path / "cursor.json")
    ref, _ = _fresh_jax()
    first = (JC.ScanCursor() if writer == "jax" else ct.ScanCursor())
    run = ((lambda c: cudasp_tpu.scan_stream(c, key, spend, config=_jcfg(),
                                             checkpoint=first))
           if writer == "jax" else
           (lambda c: ct.scan_stream(c, key, spend, config=_cfg(),
                                     checkpoint=first, device="cpu")))
    with pytest.raises(Killed):
        run(_chunks(table, 100, stop_after=2, cursor=first, path=path))
    if writer == "jax":
        cur = ct.ScanCursor.load(path)
        res = ct.scan_stream(_chunks(table, 64), key, spend, config=_cfg(),
                             checkpoint=cur, device="cpu")
    else:
        cur = JC.ScanCursor.load(path)
        res = cudasp_tpu.scan_stream(_chunks(table, 64), key, spend,
                                     config=_jcfg(), checkpoint=cur)
    assert first.rows_done == 200
    _same(res, ref)
    assert res.metrics.rows_in == N_ROWS - 200
    assert cur.rows_done == N_ROWS


def test_enc_dec_and_digest_same_as_jax():
    cells = [None, b"\x00\x01", bytearray(b"ab"), np.bytes_(b"xy"), True,
             np.bool_(False), 7, np.int64(-3), np.uint32(9), "txt",
             np.arange(4, dtype=np.uint8), 1.5, object()]
    for v in cells:
        enc = TC._enc_val(v)
        assert enc == JC._enc_val(v), v
        dec = TC._dec_val(enc)
        jdec = JC._dec_val(enc)
        assert (dec is TC._UNENCODABLE) == (jdec is JC._UNENCODABLE)
        if dec is not TC._UNENCODABLE:
            assert dec == jdec
    for case in JV.CASES:
        args = (case.scan_key_blob, case.spend_blob, case.label_blobs)
        assert TC._query_digest(*args) == JC._query_digest(*args)


def test_key_mismatch_is_a_bind_error():
    table, key, spend, _ = _random_table()
    cur = ct.ScanCursor(rows_done=100, query_digest="0" * 16)
    with pytest.raises(ct.BindError, match="different query"):
        ct.scan_stream(_chunks(table, 100), key, spend, checkpoint=cur,
                       device="cpu")
    with pytest.raises(ValueError, match="different query"):
        TC.scan_resumable(table, key, spend, cursor=cur, device="cpu")


def test_heterogeneous_schema_is_an_ingest_error():
    case = JV.CASES[0]
    t = _golden_table(case)
    first = {k: v[:1] for k, v in t.items()}
    second = {k: v[1:] for k, v in t.items() if k != "txid"}
    with pytest.raises(ct.IngestError, match="heterogeneous"):
        ct.scan_stream(iter([first, second]), case.scan_key_blob,
                       case.spend_blob, config=_cfg(), device="cpu")


def test_covered_chunks_are_skipped_without_packing():
    """A cursor at row 200 without match_rows (as written before they
    were kept): the 64-row chunks before it are skipped, the one that holds
    row 200 is scanned from there, only rows 200..299 count, and the
    result has every index but no passthrough columns."""
    table, key, spend, planted = _random_table()
    ref, jcur = _fresh_jax()
    cur = ct.ScanCursor(rows_done=200,
                        matches=[i for i in jcur.matches if i < 200],
                        query_digest=jcur.query_digest)
    seen = []

    def chunks():
        for c in _chunks(table, 64):
            seen.append(len(c["tweak_key"]))
            yield c

    res = ct.scan_stream(chunks(), key, spend, config=_cfg(),
                         checkpoint=cur, device="cpu")
    m = res.metrics
    assert (m.rows_in, m.rows_scanned) == (100, 100)
    assert m.batches == 2          # rows 200..255 and 256..299
    np.testing.assert_array_equal(res.indices, planted)
    assert res.txid is None and res.height is None
    assert m.matches == len(planted)
    assert seen == [64, 64, 64, 64, 44]


def test_scan_resumable_same_as_jax(tmp_path):
    table, key, spend, planted = _random_table()
    ours, tcur = TC.scan_resumable(table, key, spend, chunk_rows=128,
                                   config=_cfg(), device="cpu",
                                   checkpoint_path=str(tmp_path / "t.json"))
    ref, jcur = JC.scan_resumable(table, key, spend, chunk_rows=128,
                                  config=_jcfg(),
                                  checkpoint_path=str(tmp_path / "j.json"))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, planted)
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    # a finished cursor scans nothing more
    again, _ = TC.scan_resumable(table, key, spend, cursor=tcur,
                                 device="cpu")
    np.testing.assert_array_equal(again, planted)
