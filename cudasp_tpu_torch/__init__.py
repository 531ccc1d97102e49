"""cudasp_tpu_torch: BIP-352 silent-payments scanning in PyTorch and CUDA.

The port of the JAX package `cudasp_tpu` to one NVIDIA H100: the same
`scan` table function, with the fused TPU scan kernel rewritten by hand in
CUDA C++ for sm_90a (csrc/); `scan_stream` with a resumable ScanCursor;
the CLI (`python -m cudasp_tpu_torch scan|sql`) and the SQL front end
(`cudasp_tpu_torch.sql`, the `cudasp_scan` table function);
ScanConfig(backend="xla"), the JAX package's XLA-graph backend as torch
tensor ops (ops/pipeline.py); per-device tuning (runtime/tuning.py,
tools/autotune.py). Entry points run on the GPU unless the caller passes
device="cpu", which runs the kernel's plain-torch version (or the XLA
backend's ops). Imports torch and numpy, never jax and nothing of
cudasp_tpu.
"""

import numpy as np

from .api import ScanConfig, ScanResult, scan, scan_stream
from .ops.field import limbs13_to_words
from .runtime.checkpoint import ScanCursor
from .runtime.errors import BindError, CudaspError, ExecutionError, IngestError


def from_jax_limbs(limbs, axis: int = 0) -> np.ndarray:
    """The JAX package's state in the port's format: 20x13-bit limb arrays
    (pack_query_keys' spend and label planes, comb_table_np's x and y
    halves) -> uint32 words, the 20 limbs on `axis` becoming 8 words."""
    return limbs13_to_words(np.asarray(limbs), axis)


__all__ = ["scan", "scan_stream", "ScanConfig", "ScanResult", "ScanCursor",
           "from_jax_limbs",
           "CudaspError", "BindError", "IngestError", "ExecutionError"]
