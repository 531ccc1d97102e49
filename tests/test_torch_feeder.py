"""The executor's feeder thread and the pipeline ramp, on the CPU: a
scan through the feeder equals the JAX package's; a fault in packing
batch i, or on the caller's side, raises ExecutionError(i) and leaves no
feeder thread alive; a transient fault is retried and counted; the
feeder pulls at most QUEUE_DEPTH + 1 batches ahead of the launches;
iter_packed(ramp=) cuts the JAX package's batches and CUDASP_RAMP keeps
the rows; and concurrent scans share "auto"'s process-wide memo safely."""

import threading
import time

import numpy as np
import pytest
import torch

import cudasp_tpu
from cudasp_tpu.io import ingest as JI
from cudasp_tpu.oracle import ec as JO
from cudasp_tpu.oracle import encoding as JE
from cudasp_tpu.oracle import pipeline as JP

import cudasp_tpu_torch as ct
from cudasp_tpu_torch.io import ingest as TI
from cudasp_tpu_torch.io import native as N
from cudasp_tpu_torch.ops import kernels as K
from cudasp_tpu_torch.runtime import executor as X
from cudasp_tpu_torch.runtime.metrics import ScanMetrics

SMALL = dict(block_rows=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _feeders():
    return [t for t in threading.enumerate() if t.name == "cudasp-feeder"]


@pytest.fixture(scope="module")
def seeded():
    """A 160-row table over 5 oracle points: 3 outputs a row (some rows
    5, which split into virtual rows), about a tenth planted."""
    rng = np.random.default_rng(31)
    key = int.from_bytes(rng.bytes(32), "big") % JO.N
    spend = JO.ec_mul((JO.GX, JO.GY), int(rng.integers(1, 2**62)))
    pts = [JO.ec_mul((JO.GX, JO.GY), int(k))
           for k in rng.integers(1, 2**62, size=5)]
    vals = [JP.candidate_values(p, key, spend)[0] for p in pts]
    n = 160
    pick = rng.integers(0, 5, size=n)
    outputs = [[int(v) for v in rng.integers(-2**62, 2**62,
                                             size=5 if i % 7 == 0 else 3)]
               for i in range(n)]
    planted = np.flatnonzero(rng.random(n) < 0.1)
    for i in planted:
        outputs[i][-1] = vals[pick[i]]
    table = {"height": np.arange(n, dtype=np.int64) + 100,
             "tweak_key": np.stack([np.frombuffer(
                 JE.point_to_blob64(pts[j]), np.uint8) for j in pick]),
             "outputs": outputs}
    return (table, JE.scalar_to_blob32(key), JE.point_to_blob64(spend),
            planted)


def _scan(seeded, **kw):
    table, key, spend, _ = seeded
    return ct.scan(table, key, spend, device="cpu",
                   config=ct.ScanConfig(max_outputs=3, tile=32, **SMALL,
                                        **kw))


def test_scan_through_the_feeder_equals_jax(seeded):
    table, key, spend, planted = seeded
    res = _scan(seeded)
    ref = cudasp_tpu.scan(table, key, spend)
    np.testing.assert_array_equal(res.indices, planted)
    np.testing.assert_array_equal(res.indices, ref.indices)
    np.testing.assert_array_equal(res.height, ref.height)
    m = res.metrics
    # 160 rows, 23 of them split in two: 183 virtual rows, 32 a batch
    assert m.batches == 6 and m.pack_seconds > 0
    assert not _feeders()


def _executor(n=5 * 128):
    """(batches generator, schedule, spend, labels) of n rows of golden
    case 0's first row in 128-row batches."""
    from cudasp_tpu_torch.oracle import vectors as V

    case = V.CASES[0]
    blobs = np.tile(np.frombuffer(case.rows[0].tweak_blob, np.uint8), (n, 1))
    flat = np.arange(3 * n, dtype=np.int64)
    offsets = np.arange(n + 1, dtype=np.int64) * 3
    sched, spend, labels, _ = TI.pack_query_keys(case.scan_key_blob,
                                                 case.spend_blob, [])
    return (TI.iter_packed(blobs, flat, offsets, batch_size=128,
                           max_outputs=3), sched, spend, labels)


def _live_rows_match(tw, oh, ol, ovm, *a, pack_flags=False, hi_only=None,
                     nout=None, **kw):
    """A stand-in for the launch: every live row matches (on any wire)."""
    v = K.row_validity(oh, ovm, nout, hi_only)
    flags = ((v.to(torch.int64) >> 31) & 1).to(torch.int8)
    return K.pack_flag_words(flags) if pack_flags else flags


@pytest.mark.parametrize("at", [0, 3])
def test_a_packing_fault_names_its_batch_and_stops_the_feeder(
        monkeypatch, at):
    monkeypatch.setattr(K, "scan_flags", _live_rows_match)
    real = N.pack_wire
    calls = []

    def faulty(*a, **kw):
        calls.append(1)
        if len(calls) == at + 1:
            raise RuntimeError("injected packing fault")
        return real(*a, **kw)

    monkeypatch.setattr(N, "pack_wire", faulty)
    with pytest.raises(ct.ExecutionError) as err:
        X.BatchExecutor("cpu", block_rows=32).run(*_executor())
    assert err.value.batch_index == at
    assert "injected packing fault" in str(err.value.cause)
    assert not _feeders()


def test_a_fault_of_the_generator_names_its_batch(monkeypatch):
    monkeypatch.setattr(K, "scan_flags", _live_rows_match)
    batches, *rest = _executor()

    def broken():
        yield next(batches)
        yield next(batches)
        raise ValueError("injected ingest fault")

    with pytest.raises(ct.ExecutionError) as err:
        X.BatchExecutor("cpu", block_rows=32).run(broken(), *rest)
    assert err.value.batch_index == 2
    assert not _feeders()


def test_a_fault_on_the_callers_side_stops_the_feeder(monkeypatch):
    """A launch that fails twice raises ExecutionError(2) while the
    feeder has batches queued; a failure outside any batch (here the
    metrics) propagates as it is; neither leaves the feeder alive, and the
    next scan is exact."""
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) in (3, 4):
            raise RuntimeError("injected launch fault")
        time.sleep(0.05)            # the feeder fills its queue meanwhile
        return _live_rows_match(*a, **kw)

    monkeypatch.setattr(K, "scan_flags", flaky)
    with pytest.raises(ct.ExecutionError) as err:
        X.BatchExecutor("cpu", block_rows=32).run(*_executor())
    assert err.value.batch_index == 2
    assert not _feeders()

    class Broken(ScanMetrics):
        def __setattr__(self, name, value):
            if name == "batches" and value == 2:
                raise KeyError("injected caller fault")
            super().__setattr__(name, value)

    monkeypatch.setattr(K, "scan_flags", _live_rows_match)
    with pytest.raises(KeyError, match="injected caller fault"):
        X.BatchExecutor("cpu", block_rows=32).run(*_executor(),
                                                  metrics=Broken())
    assert not _feeders()
    got = X.BatchExecutor("cpu", block_rows=32).run(*_executor())
    rows = np.concatenate([s[f & (s >= 0)] for f, s in got])
    np.testing.assert_array_equal(rows, np.arange(5 * 128))


def test_a_retry_is_counted_through_the_feeder(monkeypatch):
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected transient fault")
        return _live_rows_match(*a, **kw)

    monkeypatch.setattr(K, "scan_flags", flaky)
    m = ScanMetrics()
    got = X.BatchExecutor("cpu", block_rows=32).run(*_executor(),
                                                    metrics=m)
    assert m.batch_retries == 1 and m.batches == 5
    rows = np.concatenate([s[f & (s >= 0)] for f, s in got])
    np.testing.assert_array_equal(rows, np.arange(5 * 128))


def test_the_feeder_runs_at_most_the_queue_ahead(monkeypatch):
    """With a slow launch the feeder fills its queue, and pulls at most
    QUEUE_DEPTH + 1 batches past the last launch (the queue and the one it
    holds)."""
    batches, *rest = _executor(12 * 128)
    pulled, gaps = [0], []

    def counted():
        for b in batches:
            pulled[0] += 1
            yield b

    def slow(*a, **kw):
        time.sleep(0.1)
        gaps.append(pulled[0] - len(gaps) - 1)
        return _live_rows_match(*a, **kw)

    monkeypatch.setattr(K, "scan_flags", slow)
    X.BatchExecutor("cpu", block_rows=32).run(counted(), *rest)
    assert len(gaps) == 12 and pulled[0] == 12
    assert 1 <= max(gaps) <= X.QUEUE_DEPTH + 1
    assert not _feeders()


def _ragged(seed, n, maxlen=7):
    rng = np.random.default_rng(seed)
    blobs = rng.integers(0, 256, size=(n, 64), dtype=np.uint8)
    lens = rng.integers(1, maxlen, size=n)
    flat = rng.integers(-2**62, 2**62, size=int(lens.sum()), dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return blobs, flat, offs


@pytest.mark.parametrize("ramp", [0, 8, 50, 64, 200])
@pytest.mark.parametrize("uniform", [True, False])
def test_ramp_batches_equal_jax(ramp, uniform):
    if uniform:
        rng = np.random.default_rng(5)
        n = 150
        blobs = rng.integers(0, 256, size=(n, 64), dtype=np.uint8)
        flat = rng.integers(-2**62, 2**62, size=3 * n, dtype=np.int64)
        offs = np.arange(n + 1, dtype=np.int64) * 3
    else:
        blobs, flat, offs = _ragged(6, 90)
    ours = list(TI.iter_packed(blobs, flat, offs, 64, 3, ramp=ramp))
    ref = list(JI.iter_packed(blobs, flat, offs, 64, 3, ramp=ramp,
                              layout="kernel"))
    assert [len(b.source_rows) for b in ours] == [
        len(b.source_rows) for b in ref]
    if 0 < ramp < 64:
        assert len(ours[0].source_rows) == ramp
    for a, b in zip(ours, ref):
        for name in ("tweak_blobs", "row_valid", "outputs_valid",
                     "source_rows"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        for name in ("outputs_hi", "outputs_lo"):
            np.testing.assert_array_equal(
                getattr(a, name), np.where(b.outputs_valid,
                                           getattr(b, name), 0))


def test_cudasp_ramp_keeps_the_rows(seeded, monkeypatch):
    table, key, spend, planted = seeded
    plain = _scan(seeded)
    monkeypatch.setenv("CUDASP_RAMP", "16")
    ramped = _scan(seeded)
    np.testing.assert_array_equal(ramped.indices, planted)
    np.testing.assert_array_equal(ramped.height, plain.height)
    # the 16-row first batch, then 32-row batches over the other rows
    assert ramped.metrics.batches == 1 + -(-(183 - 16) // 32)
    assert plain.metrics.batches == -(-183 // 32)
    # the XLA backend takes no ramp, as in the JAX package (its pipeline
    # stood in for: every live row matches)
    from cudasp_tpu_torch.ops import pipeline as PL

    monkeypatch.setattr(PL, "scan_batch", lambda tx, ty, rv, *a, **k: rv)
    xla = _scan(seeded, backend="xla")
    assert xla.metrics.batches == plain.metrics.batches


class _TimedCpu(X._Cpu):
    """The plain version with a card's times faked, so "auto" runs its
    loop (and its memo) on the CPU."""

    timed = True

    def stage(self, wire, bmask):
        _, ops, bm, staged, _ = super().stage(wire, bmask)
        sent = sum(p.nbytes for p in wire)
        return {"sent": sent}, ops, bm, staged, sent

    def wait(self, slot, outs, metrics):
        return [o.numpy() for o in outs], slot["sent"] / 50e6, 1e-6


class _YieldingMemo(X.OrderedDict):
    """The memo with the scans' writes lined up: every writer's first
    insert waits for the others (a barrier, given up after a second, as
    it is while a lock serialises the writers), then each waits a time of
    its own before moving its key to the end and before each eviction, so
    unguarded writers interleave there."""

    def __init__(self, writers):
        super().__init__()
        self.barrier = threading.Barrier(writers)

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        try:
            self.barrier.wait(timeout=1.0)
        except threading.BrokenBarrierError:
            pass

    def move_to_end(self, k, last=True):
        time.sleep(0.003 * (k[1] // 32 % 8))
        super().move_to_end(k, last)

    def popitem(self, last=True):
        time.sleep(0.002)
        return super().popitem(last)


def test_threaded_scans_equal_serial_ones_at_the_memo_bound(monkeypatch):
    """Eight threads scan tables of several widths at once with "auto",
    against a memo held at its bound (2 here, 64 in the port): every
    thread's rows equal its serial scan's, and no scan fails on another's
    eviction (before the lock, one scan's popitem could evict the key
    another was moving to the end: KeyError)."""
    monkeypatch.setattr(X, "_Cpu", _TimedCpu)
    monkeypatch.setattr(X, "AUTO_MEMO_MAX", 2)
    monkeypatch.setattr(K, "scan_flags", _live_rows_match)
    from cudasp_tpu_torch.oracle import vectors as V

    case = V.CASES[0]

    def table(n):
        return {"tweak_key": np.tile(np.frombuffer(
                    case.rows[0].tweak_blob, np.uint8), (n, 1)),
                "outputs": (np.arange(3 * n, dtype=np.int64),
                            np.arange(n + 1, dtype=np.int64) * 3)}

    sizes = [32 * (k + 1) for k in range(8)]
    # one batch of n rows a scan (tile=n): a memo key a width
    serial = {n: ct.scan(table(n), case.scan_key_blob, case.spend_blob,
                         device="cpu",
                         config=ct.ScanConfig(tile=n, **SMALL)).indices
              for n in sizes}
    monkeypatch.setattr(X.BatchExecutor, "_auto_memo",
                        _YieldingMemo(len(sizes)))
    errors, got = [], {}

    def one(n):
        try:
            for _ in range(3):
                got[n] = ct.scan(table(n), case.scan_key_blob,
                                 case.spend_blob, device="cpu",
                                 config=ct.ScanConfig(tile=n,
                                                      **SMALL)).indices
        except Exception as e:                # asserted after the join
            errors.append(e)

    threads = [threading.Thread(target=one, args=(n,)) for n in sizes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    for n in sizes:
        np.testing.assert_array_equal(got[n], serial[n])
        np.testing.assert_array_equal(got[n], np.arange(n))
    assert len(X.BatchExecutor._auto_memo) == 2
    assert not _feeders()
