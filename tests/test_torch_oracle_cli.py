"""The port's oracle CLI (python -m cudasp_tpu_torch.oracle) against the JAX
package's (python -m cudasp_tpu.oracle): every subcommand, with
tests/test_oracle_cli.py's arguments and a few more, through both
packages' main(argv) in this process. Standard output must be equal byte
for byte and the exit code (a return value, or SystemExit's code) equal,
for good and for bad arguments."""

import json

import pytest

from cudasp_tpu.oracle import __main__ as jax_cli
from cudasp_tpu.oracle import vectors as V

from cudasp_tpu_torch.oracle import __main__ as port_cli

CASE0, CASE1 = V.CASES[0], V.CASES[1]
LABELED = V.CASES[3]                      # label_equals_spend


def _keys(case):
    args = ["--tweak", case.rows[0].tweak_blob.hex(),
            "--scan-key", case.scan_key_blob.hex(),
            "--spend-key", case.spend_blob.hex()]
    for lb in case.label_blobs:
        args += ["--label", lb.hex()]
    return args


def _sec1(case):
    x = int.from_bytes(case.rows[0].tweak_blob[:32], "little")
    y = int.from_bytes(case.rows[0].tweak_blob[32:], "little")
    return (bytes([0x02 + (y & 1)]) + x.to_bytes(32, "big")).hex()


ARGVS = {
    "compute-expected": ["compute-expected", *_keys(CASE0)],
    "compute-expected/label": ["compute-expected", *_keys(LABELED)],
    "which-case": ["which-case", *_keys(CASE0), "--value",
                   "1714273258699162470"],
    "which-case/no-match": ["which-case", *_keys(CASE0), "--value", "5"],
    "decompress-tweak": ["decompress-tweak", "--sec1", _sec1(CASE0)],
    "decompress-tweak/bad": ["decompress-tweak", "--sec1", "04" * 33],
    "upper64": ["upper64", "--x", f"{0x80 << 248:064x}"],
    "upper64/positive": ["upper64", "--x", "0x" + "7f" * 32],
    "tagged-hash": ["tagged-hash", "--msg", "00" * 37],
    "gen-vectors": ["gen-vectors", "--rows", "6", "--match-every", "3",
                    "--seed", "1"],
    "gen-vectors/outputs": ["gen-vectors", "--rows", "3", "--seed", "9",
                            "--outputs", "2"],
    "decode-blob/scalar": ["decode-blob", "--blob",
                           CASE1.scan_key_blob.hex()],
    "decode-blob/point": ["decode-blob", "--blob",
                          CASE1.rows[0].tweak_blob.hex()],
    "decode-blob/bad": ["decode-blob", "--blob", "00" * 5],
    "convert-vector": ["convert-vector", "--scan-key-be",
                       CASE1.scan_key_blob[::-1].hex(), "--tweak",
                       CASE1.rows[0].tweak_blob.hex(), "--output",
                       str(CASE1.rows[0].outputs[0])],
    "convert-vector/spend": ["convert-vector", "--spend-pub", _sec1(CASE0),
                             "--tweak", "04" + CASE0.rows[0].tweak_blob.hex(),
                             "--height", "7"],
    "convert-vector/bad": ["convert-vector", "--spend-pub", "00" * 3],
    "missing-argument": ["upper64"],
    "unknown-subcommand": ["frobnicate"],
    "bad-int": ["which-case", *_keys(CASE0), "--value", "x"],
}


def _run(main, argv, capsys):
    try:
        rc = main(list(argv))
    except SystemExit as e:
        rc = ("SystemExit", e.code)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_port_cli_equals_jax_cli(name, capsys):
    ref_rc, ref_out = _run(jax_cli.main, ARGVS[name], capsys)
    rc, out = _run(port_cli.main, ARGVS[name], capsys)
    assert out == ref_out
    assert rc == ref_rc
    if name in ("compute-expected", "which-case", "gen-vectors",
                "decode-blob/point", "convert-vector"):
        assert rc == 0 and out      # a good argument prints something
    if name.endswith(("/bad", "/no-match")) or name in (
            "missing-argument", "unknown-subcommand", "bad-int"):
        assert rc not in (0, None)


def test_golden_values_and_gen_vectors_lines(capsys):
    rc, out = _run(port_cli.main, ARGVS["compute-expected"], capsys)
    assert (rc, out) == (0, "base: 1714273258699162470\n")
    rc, out = _run(port_cli.main, ARGVS["gen-vectors"], capsys)
    lines = [json.loads(ln) for ln in out.splitlines()]
    assert set(lines[0]) == {"keys"} and len(lines) == 7
    assert [r["expect_match"] for r in lines[1:]] == [True, False, False] * 2
