"""The port's data-parallel layer against the JAX package on the CPU: the
hash partition, the sharded scan wrapper (ops.kernels.scan_flags_sharded
against scan_pallas_sharded, both around the same stub kernel, then with
the real plain version against the single launch and the golden flags),
the row exchange (parallel.exchange.rebalance, lane for lane against the
JAX shard_map on the 8-device CPU mesh of tests/conftest.py) and the mesh
itself. No Pallas kernel is compiled here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from cudasp_tpu.ops import field as JF
from cudasp_tpu.ops import kernels as JK
from cudasp_tpu.oracle import vectors as JV
from cudasp_tpu.parallel import exchange as JX
from cudasp_tpu.parallel import mesh as JM
from cudasp_tpu.parallel import partition as JP

from cudasp_tpu_torch.io import ingest as TI
from cudasp_tpu_torch.ops import kernels as TK
from cudasp_tpu_torch.parallel import exchange as TX
from cudasp_tpu_torch.parallel import mesh as TM
from cudasp_tpu_torch.parallel import partition as TP


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cpu_mesh(n):
    return TM.make_mesh(devices=["cpu"] * n)


def _t(a):
    """A uint32 / int32 numpy plane as the port's int32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


# ---------------------------------------------------------------------------
# (a) the hash partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_parts", [1, 3, 4, 8])
def test_partition_equal_to_jax(n_parts):
    rng = np.random.default_rng(n_parts)
    byte_keys = rng.integers(0, 256, (5000, 32)).astype(np.uint8)
    int_keys = rng.integers(0, 2**62, 5000, dtype=np.int64)
    for keys in (byte_keys, int_keys):
        np.testing.assert_array_equal(TP.partition_rows(keys, n_parts),
                                      JP.partition_rows(keys, n_parts))
        for host in range(n_parts):
            np.testing.assert_array_equal(
                TP.local_shard_indices(keys, n_parts, host),
                JP.local_shard_indices(keys, n_parts, host))
    parts = [np.asarray([5, 1]), np.asarray([1, 9, 3])]
    np.testing.assert_array_equal(TP.merge_matches(parts),
                                  JP.merge_matches(parts))
    assert TP.merge_matches([]).tolist() == []


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_mesh_entries_and_errors(monkeypatch):
    mesh = _cpu_mesh(4)
    assert mesh.size == 4 and mesh.device_type == "cpu"
    assert mesh.distinct == (torch.device("cpu"),)
    assert mesh == _cpu_mesh(4) and hash(mesh) == hash(_cpu_mesh(4))
    assert mesh != _cpu_mesh(2)
    assert TM.make_mesh(2, devices=["cpu"] * 4) == _cpu_mesh(2)
    assert TM.lane_ranges(4, 128) == [(0, 32), (32, 64), (64, 96),
                                      (96, 128)]
    assert TM.Mesh(["cuda", "cuda:0"]).devices == (
        torch.device("cuda:0"),) * 2
    with pytest.raises(ValueError):
        TM.make_mesh(5, devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        TM.Mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError):
        TM.Mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.make_mesh()
    with pytest.raises(ValueError):
        TM.make_mesh(devices=["cuda:0"] * 2)
    sh = TM.BatchShardings(mesh)
    x = torch.arange(3 * 128, dtype=torch.int32).reshape(3, 128)
    parts = sh.lanes(x)
    assert all(p.is_contiguous() and p.shape == (3, 32) for p in parts)
    assert torch.equal(TM.gather_lanes(parts, "cpu"), x)
    assert list(sh.replicated(x)) == [torch.device("cpu")]


# ---------------------------------------------------------------------------
# (b) the sharded wrapper around a stub kernel, against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_stub(monkeypatch):
    """Installs `stub` as the JAX package's Pallas call for the sharded
    wrapper (its shard_map cache cleared before and after)."""
    def install(stub):
        monkeypatch.setattr(JK, "_scan_pallas_call", stub)
        JK._sharded_scan_fn.cache_clear()
    yield install
    JK._sharded_scan_fn.cache_clear()


def _jax_query():
    sx = sy = np.zeros((JF.NLIMBS, 1), np.int32)
    lx = ly = np.zeros((1, JF.NLIMBS, 1), np.int32)
    return (jnp.asarray(np.zeros((2, 34), np.int32)), jnp.asarray(sx),
            jnp.asarray(sy), jnp.asarray(lx), jnp.asarray(ly),
            JK.comb_table_kernel())


_PORT_QUERY = (np.zeros((2, 34), np.int32),
               torch.zeros((2, 8), dtype=torch.int32),
               torch.zeros((0, 2, 8), dtype=torch.int32),
               torch.zeros((32, 256, 2, 8), dtype=torch.int32))


def test_sharded_lane_split_and_blockmask_equal_to_jax(monkeypatch,
                                                       jax_stub):
    """Each shard sees B/8 contiguous lanes of a wide and of a (1, B)
    plane, its own part of the block mask in (entry, local block) order
    (the stubs zero dead tiles, as the kernel does; a shard that is all
    padding is skipped on the CPU), and the flags come back in lane
    order: the same as the JAX package's shard_map around the same stub.
    A width that does not split into 8 x block_rows raises in both."""
    def jstub(tw, oh, ol, ovm, digits, sx, sy, lx, ly, comb, blockmask=None,
              *, block_rows, **kw):
        out = tw[:1] + ovm
        if blockmask is not None:          # dead tiles flag 0, as the kernel
            out = out * jnp.repeat(blockmask, block_rows)[None].astype(
                jnp.uint32)
        return out.astype(jnp.int32)

    def tstub(tw, oh, ol, ovm, digits, spend, labels, comb, blockmask=None,
              *, block_rows, **kw):
        out = tw[:1] + ovm
        if blockmask is not None:
            out = out * blockmask.repeat_interleave(block_rows)[None]
        return out

    jax_stub(jstub)
    monkeypatch.setattr(TK, "scan_flags", tstub)
    jmesh, tmesh = JM.make_mesh(8), _cpu_mesh(8)
    B, M, br = 8 * 128, 3, 32
    rng = np.random.default_rng(0)
    tw = rng.integers(0, 2**20, (16, B)).astype(np.uint32)
    oh = rng.integers(0, 2**20, (M, B)).astype(np.uint32)
    ovm = rng.integers(0, 2**20, (1, B)).astype(np.uint32)
    bmask = (rng.random(B // br) < 0.5).astype(np.int32)
    bmask[4:8] = 0                          # the second shard: padding
    for bm in (None, bmask):
        ref = np.asarray(JK.scan_pallas_sharded(
            jmesh, jnp.asarray(tw), jnp.asarray(oh), jnp.asarray(oh),
            jnp.asarray(ovm), *_jax_query(),
            None if bm is None else jnp.asarray(bm), nlabels=1,
            block_rows=br))
        ours = TK.scan_flags_sharded(
            tmesh, _t(tw), _t(oh), _t(oh), _t(ovm), *_PORT_QUERY,
            None if bm is None else torch.from_numpy(bm), block_rows=br)
        assert ref.dtype == np.int32
        np.testing.assert_array_equal(ours.numpy(), ref)
    with pytest.raises(ValueError, match="not a multiple"):
        JK.scan_pallas_sharded(
            jmesh, *(jnp.asarray(a[:, :512]) for a in (tw, oh, oh, ovm)),
            *_jax_query(), nlabels=1, block_rows=128)
    with pytest.raises(ValueError, match="not a multiple"):
        TK.scan_flags_sharded(
            tmesh, *(_t(a[:, :512]) for a in (tw, oh, oh, ovm)),
            *_PORT_QUERY, block_rows=128)


@pytest.mark.parametrize("cut,punits", [("hi32", 1), ("hi16", 2),
                                        ("hi8", 4)])
def test_sharded_cut_dummies_replicate_like_jax(monkeypatch, jax_stub, cut,
                                                punits):
    """On a cut the (M, 1) / (1, 1) dummies are replicated, not split
    (ol on every cut, ovm on hi16 / hi8), while the match plane splits by
    lanes: the shapes every shard sees and the flags equal the JAX
    package's (cudasp_tpu/ops/kernels.py:845-849)."""
    seen = {"jax": set(), "port": []}
    jax_hi = True if cut == "hi32" else cut

    def jstub(tw, oh, ol, ovm, digits, sx, sy, lx, ly, comb, blockmask=None,
              *, hi_only=False, nout=None, **kw):
        seen["jax"].add(((tw.shape, oh.shape, ol.shape, ovm.shape),
                         (hi_only, nout)))
        return (oh[:1] & 0xFFFF).astype(jnp.int8)

    def tstub(tw, oh, ol, ovm, digits, spend, labels, comb, blockmask=None,
              *, hi_only=None, nout=None, **kw):
        seen["port"].append(((tuple(tw.shape), tuple(oh.shape),
                              tuple(ol.shape), tuple(ovm.shape)),
                             (hi_only, nout)))
        return (oh[:1] & 0xFFFF).to(torch.int8)

    jax_stub(jstub)
    monkeypatch.setattr(TK, "scan_flags", tstub)
    B, M = 8 * 128, 3
    rng = np.random.default_rng(1)
    tweaks = rng.integers(0, 256, (B, 64)).astype(np.uint8)
    oh = rng.integers(0, 2**31, (B, M)).astype(np.int32)
    ol = rng.integers(0, 2**31, (B, M)).astype(np.int32)
    ov = np.ones((B, M), bool)
    jplanes = JK.pack_batch_arrays(tweaks, np.ones(B, bool), oh, ol, ov, B,
                                   hi_only=jax_hi)
    tplanes = TK.pack_batch_arrays(tweaks, np.ones(B, bool), oh, ol, ov, B,
                                   hi_only=cut)
    for a, b in zip(jplanes, tplanes):
        assert a.tobytes() == b.tobytes()
    ref = np.asarray(JK.scan_pallas_sharded(
        JM.make_mesh(8), *(jnp.asarray(a) for a in jplanes), *_jax_query(),
        nlabels=0, block_rows=128, hi_only=jax_hi, nout=M))
    ours = TK.scan_flags_sharded(
        _cpu_mesh(8), *(_t(a) for a in tplanes), *_PORT_QUERY,
        block_rows=128, hi_only=cut, nout=M)
    np.testing.assert_array_equal(ours.numpy(), ref)
    rows = (M + punits) // punits if cut != "hi32" else M
    shapes = ((8, B // 8), (rows, B // 8), (M, 1) if cut == "hi32" else
              (1, 1), (1, B // 8) if cut == "hi32" else (1, 1))
    (jshapes, jmode), = seen["jax"]
    assert jshapes == shapes and jmode == (jax_hi, M)
    assert seen["port"] == [(shapes, (cut, M))] * 8


# ---------------------------------------------------------------------------
# (c) the sharded wrapper with the real plain version
# ---------------------------------------------------------------------------


def _golden_batch(case, width, block_rows, live=None):
    """`width` rows cycling through a golden case's rows, packed; rows
    from `live` on are padding. Returns (planes, expected flags, nout)."""
    rows = [case.rows[j % len(case.rows)] for j in range(width)]
    n = width if live is None else live
    blobs = np.stack([np.frombuffer(r.tweak_blob, np.uint8)
                      for r in rows[:n]])
    flat = np.concatenate([np.asarray(r.outputs, np.int64)
                           for r in rows[:n]])
    offs = np.cumsum([0] + [len(r.outputs) for r in rows[:n]])
    nout = int(np.diff(offs).max())
    b = next(TI.iter_packed(blobs, flat, offs, width, nout))
    planes = TK.pack_batch_arrays(b.tweak_blobs, b.row_valid, b.outputs_hi,
                                  b.outputs_lo, b.outputs_valid,
                                  block_rows=block_rows)
    expect = np.array([j < n and r.height in case.expected_heights
                       for j, r in enumerate(rows)])
    return [_t(p) for p in planes], expect


def _query(case):
    sched, sp, lab, _ = TI.pack_query_keys(case.scan_key_blob,
                                           case.spend_blob, case.label_blobs)
    return sched.operands("fixed")[0], _t(sp), _t(lab), TK.comb_table("cpu")


@pytest.mark.parametrize("case", JV.CASES, ids=[c.name for c in JV.CASES])
def test_sharded_plain_equal_to_single_launch_and_golden(case):
    """4 shards of 32 lanes, every one with live rows: packed flags equal
    to the single call's and to the golden flags."""
    planes, expect = _golden_batch(case, 128, 32)
    q = _query(case)
    ours = TK.scan_flags_sharded(_cpu_mesh(4), *planes, *q, block_rows=32,
                                 pack_flags=True)
    single = TK.scan_flags(*planes, *q, block_rows=32, pack_flags=True)
    assert ours.dtype == torch.int32 and ours.shape == (1, 4)
    np.testing.assert_array_equal(ours.numpy(), single.numpy())
    np.testing.assert_array_equal(TK.flags_to_bool(ours.numpy(), 128),
                                  expect)


def test_sharded_plain_int8_shards_with_a_ragged_blockmask():
    """Shards of 24 lanes (not a multiple of 32) read int8 flags and
    refuse packing; a ragged block mask leaves the last shard all padding
    (0 flags) and the third half live."""
    case = JV.CASES[1]
    planes, expect = _golden_batch(case, 96, 24, live=50)
    q = _query(case)
    bmask = torch.from_numpy(TK.live_blockmask(50, 4, 24))
    assert bmask.tolist() == [1, 1, 1, 0]
    mesh = _cpu_mesh(4)
    ours = TK.scan_flags_sharded(mesh, *planes, *q, bmask, block_rows=24)
    single = TK.scan_flags(*planes, *q, bmask, block_rows=24)
    assert ours.dtype == torch.int8 and ours.shape == (1, 96)
    np.testing.assert_array_equal(ours.numpy(), single.numpy())
    np.testing.assert_array_equal(ours.numpy()[0] != 0, expect)
    with pytest.raises(ValueError, match="multiple of 32"):
        TK.scan_flags_sharded(mesh, *planes, *q, bmask, block_rows=24,
                              pack_flags=True)


# ---------------------------------------------------------------------------
# (d) the row exchange, lane for lane against the JAX shard_map
# ---------------------------------------------------------------------------


def _skewed_planes(ndev=8, per=64, live=(60, 40, 20, 10, 5, 2, 0, 0),
                   seed=0, prefix=True):
    """Lane-sharded planes with skewed per-shard live rows: a prefix of
    each shard, or (prefix=False) scattered."""
    B = ndev * per
    rng = np.random.default_rng(seed)
    tw = rng.integers(0, 2**32, (8, B), dtype=np.uint32)
    oh = rng.integers(0, 2**32, (3, B), dtype=np.uint32)
    ovm = rng.integers(0, 2**31, (1, B), dtype=np.uint32)
    for d in range(ndev):
        lanes = (np.arange(live[d]) if prefix
                 else rng.choice(per, live[d], replace=False))
        ovm[0, d * per + lanes] |= np.uint32(1 << TX.ROW_VALID_BIT)
    return tw, oh, ovm


@pytest.mark.parametrize("prefix", [True, False],
                         ids=["valid-prefix", "scattered"])
def test_rebalance_equal_to_jax_lane_for_lane(prefix):
    planes = _skewed_planes(prefix=prefix, seed=int(prefix))
    jmesh = JM.make_mesh(8)
    lane = NamedSharding(jmesh, PartitionSpec(None, "data"))
    jp, jc, jb = JX.rebalance(
        jmesh, *(jax.device_put(a, lane) for a in planes), block_rows=32)
    tp, tc, tb = TX.rebalance(_cpu_mesh(8), *(_t(a) for a in planes),
                              block_rows=32)
    for a, b in zip(jp, tp):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert tc.dtype == tb.dtype == torch.int32
    assert int(tc.sum()) == int((planes[2] >> 31).sum())
    np.testing.assert_array_equal(
        tb.numpy(), TX.blockmask_from_counts(tc.numpy(), 2, 32))
    # sharded in, sharded out: the same lanes
    sp, sc, sb = TX.rebalance(
        _cpu_mesh(8), *(TM.BatchShardings(_cpu_mesh(8)).lanes(_t(a))
                        for a in planes), block_rows=32)
    assert isinstance(sp[0], list) and len(sp[0]) == 8
    for a, b in zip(tp, sp):
        assert torch.equal(a, TM.gather_lanes(b, "cpu"))
    with pytest.raises(ValueError, match="multiple"):
        TX.rebalance(_cpu_mesh(8), *(_t(a) for a in planes), block_rows=48)


def test_blockmask_from_counts_equal_to_jax():
    counts = np.asarray([300, 0, 512, 1, 257])
    assert TX.blockmask_from_counts(counts, 2, 256).tolist() == \
        JX.blockmask_from_counts(counts, 2, 256).tolist() == \
        [1, 1, 0, 0, 1, 1, 1, 0, 1, 1]


def test_rebalanced_scan_maps_flags_back_through_source_rows():
    """The JAX package's test_rebalanced_scan_interpret with the plain
    version: every live row in the first of four shards, exchanged, then
    scanned; the flags, read back through the source-row planes that
    travelled with their rows, are the golden flags."""
    case = JV.CASES[0]
    planes, expect = _golden_batch(case, 128, 8, live=32)
    src = np.arange(128, dtype=np.int64)
    shi, slo = (torch.from_numpy(h[None]) for h in TI.split_outputs_i64(src))
    flags, rhi, rlo = TX.rebalanced_scan(
        _cpu_mesh(4), *planes, shi, slo, *_query(case), block_rows=8)
    assert flags.dtype == torch.int8 and flags.shape == (1, 128)
    back = (rhi[0].long() << 32) | (rlo[0].long() & 0xFFFFFFFF)
    assert sorted(back.tolist()) == list(range(128))
    got = np.zeros(128, bool)
    got[back.numpy()] = flags[0].numpy() != 0
    np.testing.assert_array_equal(got, expect)
    # every shard got 8 of the 32 live rows
    _, counts, _ = TX.rebalance(_cpu_mesh(4), planes[3], block_rows=8)
    assert counts.tolist() == [8, 8, 8, 8]
