"""The port's bench (cudasp_tpu_torch.tools.bench) and bench curve
(tools/bench_curve.py) on the CPU, against the JAX package's root bench.py
and tools/bench_curve.py: the bench's last line has bench.py's keys (read
from its source, not imported: it would build a JAX scan), a table whose
planted value is wrong gives bench.py's error line and exit code 1, and
the curve merges records into its file exactly as the JAX tool does."""

import ast
import importlib.util
import json
import os
import subprocess

import pytest
import torch

from cudasp_tpu_torch.tools import bench, bench_curve, dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--rows", "128", "--pool", "4", "--batch-size",
        "128", "--repeats", "1", "--max-repeats", "1"]


@pytest.fixture(autouse=True)
def _small_cpu_scan(monkeypatch, tmp_path):
    """One torch thread, 32-row blocks (128-lane launches of the plain
    version) and the dataset's pool cache in tmp_path."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("CUDASP_BLOCK_ROWS", "32")
    monkeypatch.setattr(dataset, "POOL_CACHE_DIR", str(tmp_path / "pool"))
    yield
    torch.set_num_threads(threads)


def _bench_py_dicts():
    """(the keys of root bench.py's `out` dict, the keys it adds as
    out[...] (the kernel-only ones), its error line as a dict), from its
    source."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    out_keys, added, error = None, set(), None
    for node in ast.walk(main):
        if isinstance(node, ast.Assign):
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id == "out":
                out_keys = {k.value for k in node.value.keys}
            elif isinstance(t, ast.Subscript) and getattr(
                    t.value, "id", None) == "out":
                added.add(t.slice.value)
        if isinstance(node, ast.Dict) and any(
                getattr(k, "value", None) == "error" for k in node.keys):
            error = ast.literal_eval(node)
    return out_keys, added, error


def _last_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_line_has_bench_py_keys(capsys):
    out_keys, kernel_keys, _ = _bench_py_dicts()
    assert {"value", "link_MBps"} <= out_keys
    assert kernel_keys == {"kernel_rows_per_s", "kernel_rows_per_s_full64",
                           "kernel_rows_per_s_static_full64"}
    assert bench.main(TINY) == 0
    line = _last_line(capsys)
    assert set(line) == out_keys - kernel_keys | {"device"}
    assert line["device"] == {"name": "cpu", "power_limit": None}
    assert line["rows"] == 128 and line["repeats"] == 1 and line["value"] > 0
    assert line["batch_size"] == 128 and line["labels"] == 0


def test_wrong_planted_value_gives_bench_py_error_line(capsys, monkeypatch):
    real = dataset.make_dataset

    def flipped(*a, **kw):
        tweaks, flat, offsets, is_match = real(*a, **kw)
        assert is_match[0]
        flat[offsets[0]] ^= 1           # row 0's planted value, wrong
        return tweaks, flat, offsets, is_match

    monkeypatch.setattr(dataset, "make_dataset", flipped)
    assert bench.main(TINY) == 1
    assert _last_line(capsys) == _bench_py_dicts()[2]


def test_bench_refuses_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--rows", "128"])


# --- the curve ------------------------------------------------------------

def _load_jax_curve():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_curve", os.path.join(ROOT, "tools", "bench_curve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rec(rows, labels, value, src, **kw):
    return {"metric": "scan_throughput", "value": value, "rows": rows,
            "labels": labels, "link_MBps": value / 2.0,
            "engine": {"src": src, "git": "g"}, **kw}


OLD = [_rec(1_000_000, 0, 100.0, "E", history=[{"value": 1.0}]),
       _rec(9_400_000, 0, 10.0, "E"),
       _rec(32_700_000, 0, 5.0, "E"),
       _rec(1_000_000, 1, 7.0, "E")]
NEW = {(1_000_000, 0): 90.0, (9_400_000, 0): 20.0, (1_000_000, 1): 8.0}
ARGS = ["--points", "1000000", "9400000", "--labeled-rows", "1000000"]


@pytest.mark.parametrize("scenario", ["same-engine", "engine-changed",
                                      "no-file", "unreadable-file"])
def test_curve_merge_equals_jax_tool(scenario, tmp_path, monkeypatch, capsys):
    src = "F" if scenario == "engine-changed" else "E"

    def point(rows, labels=0, repeats=3, device=None):
        return {"metric": "scan_throughput", "value": NEW[rows, labels],
                "rows": rows, "link_MBps": 1.5, "labels": labels}

    outs = {}
    for name in ("jax", "port"):
        path = tmp_path / f"{name}.json"
        if scenario == "unreadable-file":
            path.write_text("{not json")
        elif scenario != "no-file":
            path.write_text(json.dumps(OLD, indent=1))
        if name == "jax":
            mod = _load_jax_curve()
            monkeypatch.setattr("sys.argv", ["bench_curve.py", *ARGS,
                                             "--out", str(path)])
            run = mod.main
        else:
            mod = bench_curve
            run = lambda: mod.main([*ARGS, "--out", str(path)])  # noqa: E731
        monkeypatch.setattr(mod, "run_point", point)
        monkeypatch.setattr(mod, "engine_id",
                            lambda: {"src": src, "git": "g"})
        rc = run()
        outs[name] = (path.read_text(), capsys.readouterr().out, rc)
    assert outs["port"][:2] == outs["jax"][:2]
    assert outs["jax"][2] is None and outs["port"][2] == 0
    merged = {(r["rows"], r["labels"]): r for r in json.loads(outs["port"][0])}
    if scenario == "same-engine":
        assert merged[1_000_000, 0]["value"] == 100.0      # the better old
        assert merged[9_400_000, 0]["value"] == 20.0
    if scenario == "engine-changed":
        assert merged[1_000_000, 0]["history"] == [
            {"value": 1.0}, {"value": 100.0, "link_MBps": 50.0,
                             "engine": {"src": "E", "git": "g"}}]
    if scenario in ("same-engine", "engine-changed"):
        assert merged[32_700_000, 0]["value"] == 5.0       # not re-run
    else:
        assert len(merged) == 3


def test_curve_writes_only_its_out_and_defaults_under_build(
        tmp_path, monkeypatch, capsys):
    assert bench_curve.DEFAULT_OUT == os.path.join(
        ROOT, "build", "cudasp_tpu_torch", "bench_curve.json")
    with open(os.path.join(ROOT, "BENCH_CURVE.json"), "rb") as f:
        jax_curve = f.read()
    monkeypatch.setattr(bench_curve, "engine_id", lambda: {"src": "E"})
    monkeypatch.setattr(bench_curve, "run_point",
                        lambda rows, labels=0, device=None: {
                            "value": 3.0, "rows": rows, "labels": labels}
                        if rows == 1000 else {"error": "boom",
                                              "labels": labels})
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    out = tmp_path / "sub" / "curve.json"
    rc = bench_curve.main(["--points", "1000", "2000", "--labeled-rows", "0",
                           "--out", str(out)])
    assert rc == 1                       # the failed point
    written = sorted(str(p.relative_to(tmp_path))
                     for p in tmp_path.rglob("*") if p.is_file())
    assert written == [os.path.join("sub", "curve.json")]
    recs = json.loads(out.read_text())
    assert [r.get("error") for r in recs] == [None, "boom"]
    with open(os.path.join(ROOT, "BENCH_CURVE.json"), "rb") as f:
        assert f.read() == jax_curve
    capsys.readouterr()


def test_run_point_reads_the_bench_process(monkeypatch):
    seen = []
    runs = [{"seconds": 2.0, "batches": 4}, {"seconds": 1.0, "batches": 4}]

    def fake_run(cmd, **kw):
        seen.append(cmd)
        rc = 1 if "--labels" in cmd else 0
        line = json.dumps({"value": 1_989_401.0, "rows": 1_000_000})
        return subprocess.CompletedProcess(
            cmd, rc, "" if rc else f"# note\n{line}\n",
            "".join(f"# run {json.dumps(r)}\n" for r in runs) + "Traceback")

    monkeypatch.setattr(bench_curve.subprocess, "run", fake_run)
    rec = bench_curve.run_point(1_000_000, device="cpu")
    assert rec["vs_reference_point"] == 1.0 and rec["runs"] == runs
    assert seen[0][1:3] == ["-m", "cudasp_tpu_torch.tools.bench"]
    assert "--no-kernel-only" not in seen[0] and "cpu" in seen[0]
    rec = bench_curve.run_point(9_400_000, labels=1)
    assert "--no-kernel-only" in seen[1] and "Traceback" in rec["error"]
    assert rec["labels"] == 1 and "vs_reference_point" not in rec
