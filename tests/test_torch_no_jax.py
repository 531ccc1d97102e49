"""The port stands alone: cudasp_tpu_torch and chip_smoke.py import neither
jax nor anything of cudasp_tpu, even after a whole scan, and chip_smoke.py
fails without printing a result where there is no GPU."""

import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

PROBE = r"""
import importlib, pkgutil, sys
import numpy as np
import cudasp_tpu_torch as ct
mods = [m.name for m in pkgutil.walk_packages(ct.__path__,
                                              "cudasp_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
print("MODS", " ".join(mods))
import chip_smoke
from cudasp_tpu_torch.oracle import vectors as V
case = V.CASES[0]
t = {"tweak_key": np.stack([np.frombuffer(r.tweak_blob, np.uint8)
                            for r in case.rows]),
     "outputs": [list(r.outputs) for r in case.rows]}
res = ct.scan(t, case.scan_key_blob, case.spend_blob, device="cpu",
              config=ct.ScanConfig(block_rows=32))
assert res.indices.tolist() == [0], res.indices
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "cudasp_tpu"))
print("BAD", bad)
"""


# the bench, its curve and the oracle CLI: each is imported above, and
# the oracle CLI imports no torch itself
NEW_ENTRY_POINTS = ("cudasp_tpu_torch.tools.bench",
                    "cudasp_tpu_torch.tools.bench_curve",
                    "cudasp_tpu_torch.oracle.__main__")


def _env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"        # the suite runs several workers
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_and_chip_smoke_never_import_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout
    mods = next(ln for ln in out.stdout.splitlines()
                if ln.startswith("MODS ")).split()[1:]
    assert set(NEW_ENTRY_POINTS) <= set(mods), mods


def test_port_sources_name_no_jax_module():
    for path in list((ROOT / "cudasp_tpu_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            code = line.split("#")[0].strip()
            if code.startswith(("import ", "from ")):
                words = code.replace(",", " ").split()
                assert not {"jax", "jaxlib", "cudasp_tpu"} & {
                    w.split(".")[0] for w in words}, (path, line)


def test_oracle_cli_and_its_oracle_import_no_torch():
    """The oracle CLI and the oracle modules it is built on import the
    standard library and each other only."""
    for path in (ROOT / "cudasp_tpu_torch" / "oracle").glob("*.py"):
        for line in path.read_text().splitlines():
            if line.startswith(("import ", "from ")):
                top = line.split()[1].split(".")[0]
                assert top in ("", "__future__", "argparse", "json", "sys",
                               "typing", "hashlib", "struct",
                               "dataclasses"), (path.name, line)


def test_kernel_sources_and_generated_tu_include_only_port_headers():
    """The CUDA sources, the host packer (pack.cpp) and the per-key
    translation unit that ops/kernels.py generates include the port's own
    headers, the C/CUDA runtime and, in the packer, the C++ thread
    library only: nothing of the JAX package's csrc/."""
    from cudasp_tpu_torch.ops import kernels as TK
    from cudasp_tpu_torch.ops import scalar as TS

    csrc = ROOT / "cudasp_tpu_torch" / "csrc"
    allowed = {p.name for p in csrc.iterdir()} | {
        "stddef.h", "stdint.h", "string.h", "cuda_runtime.h", "thread",
        "vector"}
    texts = [(p.name, p.read_text()) for p in csrc.iterdir()]
    texts.append(("generated", TK.static_source(TS.glv_wnaf_static(77))))
    for name, text in texts:
        includes = [ln.split()[1].strip('"<>') for ln in text.splitlines()
                    if ln.startswith("#include") and "SP_STATIC_TU" not in ln]
        assert includes and set(includes) <= allowed, (name, includes)


def test_chip_smoke_fails_without_gpu_and_alone(tmp_path):
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, shutil.copy(ROOT / "chip_smoke.py",
                                               tmp_path))):
        env = _env()
        env.pop("PYTHONPATH")
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
