"""The port's host-path tools on the CPU: tools/dataset.py makes the JAX
package's bench.py table; every tool this slice adds (kernel_probe,
h2d_probe, concurrency_probe, ablate_probe, scaling_probe,
multihost_bench with two gloo processes, seed_cache, first_contact) runs
its --device cpu mode at a tiny size with its correctness check; the
kernel's host build compiles and runs with every SP_ABLATE stage, and
its default build gives the golden flags; no scan kernel loads an
ablated library."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import bench

from cudasp_tpu_torch.ops import kernels as K
from cudasp_tpu_torch.ops import scalar as S
from cudasp_tpu_torch.oracle import vectors as V
from cudasp_tpu_torch.io import ingest as TI
from cudasp_tpu_torch.tools import (ablate_probe, concurrency_probe, dataset,
                                    h2d_probe, kernel_probe, scaling_probe,
                                    seed_cache)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.mark.parametrize("kw", [
    dict(pool=5, match_every=10, outputs_per_row=2, seed=3),
    dict(pool=3, seed=7)])
def test_dataset_equals_bench_make_dataset(tmp_path, monkeypatch, kw):
    monkeypatch.setattr(bench, "_POOL_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(dataset, "POOL_CACHE_DIR", str(tmp_path / "port"))
    _, _, key, spend = dataset.bip352_query()
    ref = bench.make_dataset(700, scan_key=key, spend=spend, **kw)
    for _ in range(2):                  # computed, then from the cache
        ours = dataset.make_dataset(700, scan_key=key, spend=spend, **kw)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert len(os.listdir(tmp_path / "port")) == 1


def test_kernel_probe_cpu():
    out = kernel_probe.main(CPU + ["--rows", "64", "--block-rows", "32",
                                   "--reps", "1", "--pool", "4",
                                   "--ladders", "fixed,static", "--wires",
                                   "x,xy"])
    assert [(r["ladder"], r["wire"]) for r in out] == [
        ("fixed", "x"), ("static", "x"), ("fixed", "xy"), ("static", "xy")]
    assert all(r["ok"] and r["matches"] == 1 for r in out)


def test_h2d_probe_cpu():
    out = h2d_probe.main(CPU + ["--rows", "64", "--block-rows", "32",
                                "--reps", "1"])
    for name in ("upload pinned", "upload pageable", "upload x2",
                 "upload x4", "kernel", "flags D2H"):
        assert out[name]["ms"] > 0
    assert out["bytes_per_row"] == 60


def test_concurrency_probe_cpu():
    out = concurrency_probe.main(CPU + ["--rows", "64", "--tenants", "2",
                                        "--pool", "4"])
    assert out["exact"] and out["tenants"] == 2


def _host_golden(lib, case):
    tab = {"tweak_key": np.stack([np.frombuffer(r.tweak_blob, np.uint8)
                                  for r in case.rows]),
           "outputs": TI.outputs_to_csr([r.outputs for r in case.rows])}
    flat, offs = tab["outputs"]
    M = int(np.diff(offs).max())
    b = next(TI.iter_packed(tab["tweak_key"], flat, offs, len(case.rows), M))
    tw, oh, ol, ovm = (np.ascontiguousarray(p) for p in K.pack_batch_arrays(
        b.tweak_blobs, b.row_valid, b.outputs_hi, b.outputs_lo,
        b.outputs_valid, block_rows=32))
    sched, sp, lab, nl = TI.pack_query_keys(case.scan_key_blob,
                                            case.spend_blob, case.label_blobs)
    lab = np.ascontiguousarray(lab if nl else np.zeros((1, 2, 8), np.uint32))
    d = np.ascontiguousarray(sched.odd, np.int32)
    comb = S.comb_table_np()
    n = tw.shape[1]
    flags = np.zeros(n, np.int8)
    lib.sp_scan_rows(tw.ctypes.data, oh.ctypes.data, ol.ctypes.data,
                     ovm.ctypes.data, 0, d.ctypes.data, sp.ctypes.data,
                     lab.ctypes.data, nl, comb.ctypes.data, n, M, 0, 0,
                     flags.ctypes.data)
    return set(np.flatnonzero(flags[:len(case.rows)]).tolist())


def test_ablate_probe_cpu_and_the_host_builds():
    """Every SP_ABLATE stage's host build compiles (g++ -Wall -Werror) and
    runs, and the probe reports each stage; the default build gives every
    golden case's flags, as the kernel's code did before the stand-ins."""
    out = ablate_probe.main(CPU + ["--rows", "8", "--reps", "1"])
    assert list(out["stages"]) == list(K.ABLATE_STAGES)
    assert out["base_ms"] > 0 and "budget" in out
    base = ablate_probe.host_library(0)
    for case in V.CASES:
        expect = {i for i, r in enumerate(case.rows)
                  if r.height in case.expected_heights}
        assert _host_golden(base, case) == expect, case.name
    planes, digits, sp, lab = ablate_probe.random_planes(8, 0)
    for mask in (1 << i for i in range(len(K.ABLATE_STAGES))):
        flags = ablate_probe.host_scan(ablate_probe.host_library(mask),
                                       planes, digits, sp, lab)
        assert flags.shape == (8,)


def test_no_scan_kernel_loads_an_ablated_library(monkeypatch):
    assert not any("SP_ABLATE" in f for f in K.NVCC_FLAGS)
    assert K.ablate_flags(0) == [] and K.ablate_flags(4) == [
        "-DSP_ABLATE=4"]
    for kern in K.KERNELS.values():
        assert kern.ablate == 0
    with pytest.raises(ValueError):
        K.ScanKernel("static", ablate=4)
    with pytest.raises(ValueError):
        K.ScanKernel("fixed", ablate=1 << len(K.ABLATE_STAGES))
    tw = torch.zeros((8, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="no plain version"):
        K.scan_flags(tw, tw[:3], tw[:3], tw[:1], np.zeros((2, 34), np.int32),
                     None, None, None, ablate=4)

    class _Fn:
        restype = None

        def __init__(self, v):
            self.v = v

        def __call__(self):
            return self.v

    def fake_library(src, sources, so_name, flags=()):
        """A library that reports the SP_ABLATE mask it was built with:
        the flags' mask, or 4 for the default build's path (a stray
        ablated build where the scan kernel's library should be)."""
        built = int(flags[0].split("=")[1]) if flags else 4
        return types.SimpleNamespace(
            _name=so_name, cudasp_scan_launch=types.SimpleNamespace(),
            cudasp_scan_ablate=_Fn(built)), None

    monkeypatch.setattr(K, "source_library", fake_library)
    with pytest.raises(RuntimeError, match="SP_ABLATE=4"):
        K.ScanKernel("fixed").library()
    assert K.ScanKernel("fixed", ablate=4).library() is not None


def test_scaling_probe_cpu():
    out = scaling_probe.main(CPU + ["--rows-per-device", "32",
                                    "--xla-rows-per-device", "32",
                                    "--block-rows", "32", "--reps", "1",
                                    "--sizes", "1,2"])
    assert [(r["probe"], r["entries"]) for r in out] == [
        (p, n) for n in (1, 2) for p in ("sharded", "exchange", "xla")]
    assert all(r["ms"] > 0 for r in out)
    assert all(r["efficiency"] == 1.0 for r in out if r["entries"] == 1)


def test_multihost_bench_two_gloo_processes():
    out = subprocess.run(
        [sys.executable, "-m", "cudasp_tpu_torch.tools.multihost_bench",
         "--spawn", "2", "--device", "cpu", "--rows", "128", "--pool", "4",
         "--repeats", "1", "--batch-size", "128"], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"] == "multihost_scan_throughput"
    assert line["hosts"] == 2 and line["rows"] == 128 and line["value"] > 0


def test_seed_cache_cpu_builds_once(tmp_path):
    first = seed_cache.main(CPU)
    again = seed_cache.main(CPU)
    assert first["gxx_runs"] in (0, 1) and first["nvcc_runs"] == 0
    assert again["gxx_runs"] == again["nvcc_runs"] == 0
    keyfile = tmp_path / "keys"
    keyfile.write_text(V.SCAN_KEY_BIP352.hex() + "\n\n"
                       + V.CASES[1].scan_key_blob.hex() + "\n")
    assert seed_cache.scan_keys(["@" + str(keyfile), "00" * 32]) == [
        V.SCAN_KEY_BIP352, V.CASES[1].scan_key_blob, bytes(32)]
    with pytest.raises(SystemExit):
        seed_cache.scan_keys(["abcd"])
    with pytest.raises(SystemExit):
        seed_cache.main(CPU + ["--scan-key", "00" * 32])


def test_first_contact_cpu_chain():
    out = subprocess.run(
        [sys.executable, "-m", "cudasp_tpu_torch.tools.first_contact",
         "--device", "cpu", "--skip-autotune", "--rows", "64", "--pool",
         "4"], cwd=ROOT, env=_env(), capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(summary["steps"]) == {"seed_cache", "scan"}
    scan = [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith('{"rows"')]
    assert scan and scan[0]["matches"] == 1
    # a failing step stops the chain with its exit code
    bad = subprocess.run(
        [sys.executable, "-m", "cudasp_tpu_torch.tools.first_contact",
         "--device", "cpu", "--skip-autotune", "--scan-key", "00" * 32],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=240)
    assert bad.returncode != 0 and '"steps"' not in bad.stdout
