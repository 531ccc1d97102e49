"""Typed errors for the scan engine (counterpart of
cudasp_tpu/runtime/errors.py). Every failure is loud and typed."""


class CudaspError(Exception):
    """Base class for scan-engine errors."""


class BindError(CudaspError):
    """Invalid query arguments (sizes, types)."""


class IngestError(CudaspError):
    """Malformed input table."""


class ExecutionError(CudaspError):
    """A batch failed on the device; carries the batch index."""

    def __init__(self, batch_index: int, cause: Exception):
        super().__init__(f"batch {batch_index} failed: {cause!r}")
        self.batch_index = batch_index
        self.cause = cause
