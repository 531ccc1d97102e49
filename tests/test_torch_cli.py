"""The port's CLI (python -m cudasp_tpu_torch, --device cpu) against the
JAX package's (cudasp_tpu.cli) on the same files of golden rows: the same
JSONL on stdout from .jsonl and .parquet inputs, with --stream on
parquet, keys given as hex or @file, and the sql subcommand on -e
statements. Without --device the CLI runs on the card, and without one it
raises, on every --backend; --backend xla scans with --device cpu."""

import json

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from cudasp_tpu import cli as jcli
from cudasp_tpu.oracle import vectors as JV

from cudasp_tpu_torch import cli

CASES = {c.name: c for c in JV.CASES}
# a label case: its two rows match through the label; and the BIP-352 one
PICK = ("label_distinct", "bip352_vector")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write(case, path):
    rows = case.rows
    if str(path).endswith(".jsonl"):
        with open(path, "w") as f:
            for r in rows:
                f.write(json.dumps({"txid": bytes(r.txid).hex(),
                                    "height": r.height,
                                    "tweak_key": r.tweak_blob.hex(),
                                    "outputs": list(r.outputs)}) + "\n")
        return
    pq.write_table(pa.table({
        "txid": pa.array([bytes(r.txid) for r in rows], pa.binary()),
        "height": pa.array([r.height for r in rows], pa.int32()),
        "tweak_key": pa.array([r.tweak_blob for r in rows], pa.binary()),
        "outputs": pa.array([list(r.outputs) for r in rows],
                            pa.list_(pa.int64())),
    }), path)


def _args(case, path, *extra):
    args = ["scan", "--input", str(path), "--scan-key",
            case.scan_key_blob.hex(), "--spend-key", case.spend_blob.hex()]
    for lb in case.label_blobs:
        args += ["--label", lb.hex()]
    return args + list(extra)


def _run(main, args, capsys):
    assert main(args) == 0
    out = capsys.readouterr()
    return [json.loads(ln) for ln in out.out.splitlines()], out.err


PORT = ("--device", "cpu", "--block-rows", "32")


@pytest.mark.parametrize("fmt", ["jsonl", "parquet"])
@pytest.mark.parametrize("name", PICK)
def test_scan_prints_the_same_jsonl_as_jax(tmp_path, capsys, fmt, name):
    case = CASES[name]
    path = tmp_path / f"t.{fmt}"
    _write(case, path)
    ours, _ = _run(cli.main, _args(case, path, *PORT), capsys)
    ref, _ = _run(jcli.main, _args(case, path), capsys)
    assert ours == ref
    assert tuple(r["height"] for r in ours) == case.expected_heights


def test_stream_on_parquet_and_metrics(tmp_path, capsys):
    """--stream 1: every row its own chunk; the metrics line on stderr."""
    case = CASES["label_distinct"]
    path = tmp_path / "t.parquet"
    _write(case, path)
    ours, err = _run(cli.main, _args(case, path, *PORT, "--stream", "1",
                                     "--metrics"), capsys)
    ref, _ = _run(jcli.main, _args(case, path, "--stream", "1"), capsys)
    assert ours == ref
    m = json.loads(next(ln for ln in err.splitlines()
                        if ln.startswith("{")))
    assert (m["rows_in"], m["matches"], m["batches"]) == (
        len(case.rows), len(case.expected_heights), len(case.rows))
    assert "wall_seconds" in m and m["batch_retries"] == 0


def test_stream_needs_parquet(tmp_path):
    case = CASES["gecc_case0"]
    path = tmp_path / "t.jsonl"
    _write(case, path)
    with pytest.raises(SystemExit, match="parquet"):
        cli.main(_args(case, path, *PORT, "--stream", "8"))


def test_keys_from_files(tmp_path, capsys):
    """@path: a file of the raw bytes, or of their hex."""
    case = CASES["label_distinct"]
    path = tmp_path / "t.jsonl"
    _write(case, path)
    (tmp_path / "scan.bin").write_bytes(case.scan_key_blob)
    (tmp_path / "spend.hex").write_text(case.spend_blob.hex() + "\n")
    args = ["scan", "--input", str(path),
            "--scan-key", f"@{tmp_path / 'scan.bin'}",
            "--spend-key", f"@{tmp_path / 'spend.hex'}"]
    for k, lb in enumerate(case.label_blobs):
        (tmp_path / f"l{k}.bin").write_bytes(lb)
        args += ["--label", f"@{tmp_path / f'l{k}.bin'}"]
    ours, _ = _run(cli.main, args + list(PORT), capsys)
    ref, _ = _run(jcli.main, args, capsys)
    assert ours == ref and len(ours) == len(case.expected_heights)
    with pytest.raises(SystemExit, match="expected 32 bytes"):
        cli.main(["scan", "--input", str(path), "--scan-key", "00" * 31,
                  "--spend-key", case.spend_blob.hex(), *PORT])


def test_parquet_out(tmp_path, capsys):
    case = CASES["bip352_vector"]
    path = tmp_path / "t.jsonl"
    _write(case, path)
    for main, out, extra in ((cli.main, "ours.parquet", PORT),
                             (jcli.main, "ref.parquet", ())):
        assert main(_args(case, path, "--out", str(tmp_path / out),
                          *extra)) == 0
    ours = pq.read_table(tmp_path / "ours.parquet")
    assert ours.equals(pq.read_table(tmp_path / "ref.parquet"))
    assert ours.column("height").to_pylist() == list(case.expected_heights)


def _blob(b):
    return "BLOB '" + "".join(f"\\x{v:02x}" for v in b) + "'"


def _sql_args(case):
    """CREATE, INSERT and the cudasp_scan SELECT of a golden case, as the
    sql subcommand's -e arguments."""
    stmts = ["CREATE TABLE t (txid BLOB, height INTEGER, tweak_key BLOB, "
             "outputs BIGINT[])"]
    stmts += [f"INSERT INTO t VALUES ({_blob(r.txid)}, {r.height}, "
              f"{_blob(r.tweak_blob)}, [{', '.join(map(str, r.outputs))}])"
              for r in case.rows]
    labels = ", ".join(_blob(lb) for lb in case.label_blobs)
    stmts.append(f"SELECT height, txid FROM cudasp_scan((SELECT * FROM t), "
                 f"{_blob(case.scan_key_blob)}, {_blob(case.spend_blob)}, "
                 f"[{labels}])")
    args = ["sql", "--engine", "builtin"]
    for st in stmts:
        args += ["-e", st]
    return args


def test_sql_subcommand_same_as_jax(capsys):
    case = CASES["label_distinct"]
    args = _sql_args(case)
    assert cli.main(args + ["--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    assert jcli.main(args) == 0
    assert ours == capsys.readouterr().out
    assert [int(ln.split("\t")[0]) for ln in ours.splitlines()] == \
        list(case.expected_heights)


def test_cli_runs_on_the_card_unless_told_cpu(tmp_path, monkeypatch,
                                             capsys):
    """Every backend runs on the card unless --device cpu: --backend xla
    raises like the others without one, and scans with --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case = CASES["gecc_case0"]
    path = tmp_path / "t.jsonl"
    _write(case, path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(_args(case, path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(_sql_args(case))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(_args(case, path, "--backend", "xla"))
    ours, _ = _run(cli.main, _args(case, path, "--backend", "xla",
                                   "--device", "cpu", "--block-rows", "8"),
                   capsys)
    assert tuple(r["height"] for r in ours) == case.expected_heights
