"""The port's device tuning (cudasp_tpu_torch/runtime/tuning.py) and its
autotune tool on the CPU: the table by device kind (the H100 row, the CPU
row, the fallback), CUDASP_BLOCK_ROWS and CUDASP_TILE over it, an
autotuned row over both, every field of the JAX package's ScanConfig, and
`tools.autotune --device cpu` writing a row that tuning reads back.
ScanConfig(block_rows=None) and tile are held against the JAX package's
scan in tests/test_torch_xla_scan.py, whose process has its golden scans
already."""

import dataclasses
import json
import os

import pytest
import torch

import cudasp_tpu

import cudasp_tpu_torch as ct
from cudasp_tpu_torch.runtime import tuning
from cudasp_tpu_torch.tools import autotune


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker (tests/test_torch_api.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _own_tuning_dir(tmp_path, monkeypatch):
    """No test reads or writes build/'s autotuned rows, or sees the
    operator's variables."""
    monkeypatch.setattr(tuning, "TUNING_DIR", str(tmp_path / "tuning"))
    monkeypatch.delenv("CUDASP_BLOCK_ROWS", raising=False)
    monkeypatch.delenv("CUDASP_TILE", raising=False)


@pytest.mark.parametrize("kind,row", [
    ("NVIDIA H100 80GB HBM3", (256, 262_144, True)),
    ("NVIDIA H100 PCIe", (256, 262_144, True)),
    ("cpu", (256, 1024, False)),
    ("NVIDIA A100-SXM4-80GB", (256, 262_144, False)),
])
def test_table_by_device_kind(kind, row):
    d = tuning.lookup(kind)
    assert (d.block_rows, d.tile, d.measured) == row


def test_device_kind_and_defaults_of_the_cpu(monkeypatch):
    assert tuning.device_kind("cpu") == "cpu"
    assert tuning.defaults("cpu") == tuning.CPU
    assert (tuning.block_rows_default("cpu"), tuning.tile_default("cpu")) \
        == (256, 1024)
    assert ct.api.TILE_CUDA == tuning.H100.tile == 262_144
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tuning.defaults()              # the card, and there is none

    def no_name(device=None):
        raise AssertionError("Torch not compiled with CUDA enabled")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", no_name)
    assert tuning.device_kind() == "unknown"
    assert tuning.defaults() == tuning.lookup("unknown")


def test_environment_overrides_the_row(monkeypatch):
    monkeypatch.setenv("CUDASP_BLOCK_ROWS", "64")
    monkeypatch.setenv("CUDASP_TILE", "512")
    d = tuning.defaults("cpu")
    assert (d.block_rows, d.tile) == (64, 512)
    monkeypatch.delenv("CUDASP_TILE")
    assert tuning.defaults("cpu").tile == 1024


def test_autotuned_row_wins_over_the_table(monkeypatch):
    for kind in ("cpu", "NVIDIA H100 80GB HBM3"):
        path = tuning.save_autotuned(kind, 128, 2048)
        assert path.startswith(tuning.TUNING_DIR)
        assert os.path.basename(path) == "tuning_" + (
            "cpu" if kind == "cpu" else "nvidia_h100_80gb_hbm3") + ".json"
        with open(path) as f:
            assert json.load(f)["device_kind"] == kind
        d = tuning.lookup(kind)
        assert (d.block_rows, d.tile, d.measured) == (128, 2048, True)
    assert tuning.defaults("cpu").tile == 2048
    monkeypatch.setenv("CUDASP_TILE", "4096")        # the variable wins
    assert tuning.defaults("cpu").tile == 4096


def test_scan_config_has_every_field_of_the_jax_package():
    ours = {f.name: f.default for f in dataclasses.fields(ct.ScanConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(
        cudasp_tpu.ScanConfig)}
    assert set(ref) <= set(ours)
    assert {k: ours[k] for k in ref} == ref
    ct.ScanConfig(block_rows=None, backend="xla", fused=True, tile=4096,
                  mesh=None, rebalance=False, ladder="auto",
                  static_key=False, upload="auto")


def test_autotune_on_the_cpu_writes_a_row_tuning_reads(capsys):
    assert autotune.main(["--device", "cpu", "--rows", "128", "--reps",
                          "1", "--dry-run"]) == 0
    assert not os.path.exists(tuning.TUNING_DIR)       # dry run: nothing
    assert autotune.main(["--device", "cpu", "--rows", "256", "--reps",
                          "1"]) == 0
    out = capsys.readouterr().out
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert [(r["block_rows"], r["tile"]) for r in lines] == [
        (128, 128), (128, 256), (256, 256)]
    best = max(lines[1:], key=lambda r: r["rows_per_s"])
    assert f"wrote {tuning.tuned_path('cpu')}" in out
    d = tuning.defaults("cpu")
    assert (d.block_rows, d.tile, d.measured) == (best["block_rows"], 256,
                                                  True)
