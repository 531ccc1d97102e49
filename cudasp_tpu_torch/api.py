"""Public scan API (counterpart of cudasp_tpu/api.py).

`scan(...)` is the DuckDB-style table function of the system: a table of
(txid, height, tweak_key, outputs) rows in, the rows that pay the wallet
out. Same wire formats and semantics as the JAX package. `scan_stream`
scans an iterator of chunks with bounded host memory and, given a
runtime.checkpoint.ScanCursor, resumes where a dead scan stopped.

Both run on the GPU unless the caller passes device="cpu"; without a
CUDA device they raise instead of falling back. On the GPU every batch goes
through the hand-written scan kernel; on the CPU through its plain-torch
version. ScanConfig(backend="xla") runs the XLA-graph backend's
counterpart instead (ops/pipeline.py, torch tensor ops), on the same
device. With ScanConfig(mesh=parallel.mesh.make_mesh()) each batch is
split over the mesh's entries, one launch each (and, with rebalance=True,
through the row exchange first)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .io import ingest
from .runtime.errors import BindError, IngestError
from .ops.kernels import LADDERS
from .runtime import tuning
from .runtime.executor import BACKENDS, UPLOADS, BatchExecutor
from .runtime.metrics import ScanMetrics, Timer
from .runtime.trace import emit_metrics, trace_scan

DEFAULT_BATCH_SIZE = 300_000       # the reference's default batch size
MAX_BATCH_SIZE = 10_000_000        # the reference's cap
TILE_CUDA = tuning.H100.tile       # rows a launch on the H100 (its row)
MAX_OUTPUTS_CAP = 30               # bits 30/31 of the validity mask are taken


@dataclass
class ScanConfig:
    """Every field of the JAX package's ScanConfig, with its default.

    backend: "auto" and "pallas" run the hand-written scan kernel (its
    plain version under device="cpu"); "xla" runs ops/pipeline.py, the
    XLA-graph backend's counterpart in torch tensor ops, on the literal
    (x, y) of each tweak point with complete point arithmetic, on the card
    unless device="cpu". The reference's "auto" picks "xla" on the CPU;
    the port's never does, since the CPU is its test device for the
    kernel's plain version, not a deployment. On "xla", upload, ladder,
    static_key and rebalance do nothing, as on the reference's, and fused
    gives the same flags either way (ops/pipeline.py)."""
    batch_size: int = DEFAULT_BATCH_SIZE
    max_outputs: int = 8            # padded outputs width (long lists split)
    collect_metrics: bool = True
    # rows per block-skip tile of the kernel's blockmask; None: the
    # device's row in runtime.tuning (CUDASP_BLOCK_ROWS over it)
    block_rows: Optional[int] = None
    # rows a launch at most (the executor's batch width); None: the
    # device's row in runtime.tuning (CUDASP_TILE over it). The reference's
    # XLA backend caps its tile at 8,192 because XLA's compile time grows
    # with the batch; the port compiles nothing, and at 8,192 rows the
    # card would run each of the pipeline's plain ops ~32 times more often
    # for the same rows, so every backend takes the device's tile.
    tile: Optional[int] = None
    backend: str = "auto"           # "auto" | "pallas" | "xla" (above)
    fused: bool = False             # the reference's one-program pipeline
    # Batch upload (per row at 3 outputs): "full64" (92 B: the 64-byte
    # point, the kernel skips the square root), "full" (60 B: 32-byte x +
    # parity bit, the kernel recovers y), "hi32" (48 B), "hi16" (40 B) or
    # "hi8" (36 B; at most 6 outputs a row, else it degrades to hi16, and
    # hi16 above 14 to hi32, with a warning): prefilters on the top 32, 16
    # or 8 bits of each output, whose flagged rows an exact second pass
    # re-scans; or "auto": per batch, the mode with the least modeled
    # time max(bytes / H2D rate, kernel time), both measured on the card
    # with CUDA events ("full" on the CPU). CUDASP_UPLOAD fills "auto"
    # only (an explicit value wins).
    upload: str = "auto"
    # The scan key's ladder: "fixed" (odd-digit windows, 64 adds) or
    # "wnaf" (merged-GLV width-5 wNAF, ~43 adds); both read the key's
    # schedule as data, so one build serves every key. "auto" = fixed;
    # CUDASP_LADDER fills "auto" only (an explicit value wins).
    ladder: str = "auto"
    # static_key=True compiles the key's wNAF schedule into a kernel of
    # its own (ladder "static": one nvcc build per key, about ten
    # seconds, cached on disk under build/cudasp_tpu_torch/static/ and
    # in the process): for a long-lived key over many rows. The cached
    # library encodes the scan key. Overrides `ladder`.
    static_key: bool = False
    # A parallel.mesh.Mesh (make_mesh()): each batch splits into the
    # mesh's lane shards and each entry runs the scan kernel over its own,
    # on its own streams. The mesh's devices decide where the scan runs.
    mesh: object = None
    # With a mesh: send every batch through the row exchange
    # (parallel.exchange) so that skewed per-shard live rows even out
    # before the kernel; it ships the "full" wire whatever `upload` says.
    rebalance: bool = False


@dataclass
class ScanResult:
    """Matching rows, in input order."""
    indices: np.ndarray             # (m,) int64 row indices into the input
    txid: Optional[np.ndarray]      # None when the input had no such column
    height: Optional[np.ndarray]
    tweak_key: Optional[np.ndarray]
    metrics: Optional[ScanMetrics] = None

    def __len__(self) -> int:
        return len(self.indices)


def _normalize_blob_column(col, width: int, name: str):
    """(n, width) uint8 array, list of bytes (None = NULL), or a pyarrow
    array -> (blobs (n, width) uint8, valid (n,) bool). NULL rows come
    back zero-filled and invalid; the scan skips them."""
    if isinstance(col, np.ndarray) and col.dtype == np.uint8 and col.ndim == 2:
        if col.shape[1] != width:
            raise IngestError(
                f"{name}: expected width {width}, got {col.shape[1]}")
        return col, np.ones(col.shape[0], bool)
    if hasattr(col, "is_valid") and hasattr(col, "to_pylist"):   # pyarrow
        valid = np.asarray(col.is_valid())
        rows = [b if v else b"\x00" * width
                for b, v in zip(col.to_pylist(), valid)]
    else:
        try:
            rows = [b"\x00" * width if b is None else bytes(b) for b in col]
        except TypeError as e:
            raise IngestError(
                f"{name}: unsupported column type {type(col)}") from e
        valid = np.array([b is not None for b in col], bool)
    bad = [i for i, b in enumerate(rows) if len(b) != width]
    if bad:
        raise IngestError(f"{name}: row {bad[0]} has {len(rows[bad[0]])} "
                          f"bytes, expected {width}")
    if not rows:
        return np.zeros((0, width), np.uint8), np.zeros(0, bool)
    blobs = np.frombuffer(b"".join(rows), np.uint8).reshape(len(rows), width)
    return blobs, valid


def _normalize_outputs(col) -> Tuple[np.ndarray, np.ndarray]:
    """outputs column -> CSR (flat int64, offsets). Takes (flat, offsets)
    tuples, pyarrow list arrays or sequences of sequences; a NULL list is
    empty and NULL elements are dropped."""
    if isinstance(col, tuple) and len(col) == 2:
        return (np.asarray(col[0], dtype=np.int64),
                np.asarray(col[1], dtype=np.int64))
    values = getattr(col, "values", None)
    offsets = getattr(col, "offsets", None)
    if values is not None and offsets is not None and col.null_count == 0 \
            and getattr(values, "null_count", 0) == 0:
        return (np.asarray(values, dtype=np.int64),
                np.asarray(offsets, dtype=np.int64))
    if hasattr(col, "to_pylist"):
        col = col.to_pylist()
    return ingest.outputs_to_csr(
        [[] if o is None else [v for v in o if v is not None] for o in col])


def _slice_col(col, a: int, b: int):
    """Rows [a, b) of a column of any supported type (numpy, list, pyarrow
    array, CSR outputs tuple): scan_stream's mid-chunk resume and
    runtime.checkpoint's chunks."""
    if isinstance(col, tuple) and len(col) == 2:        # CSR outputs
        flat, offs = col
        offs = np.asarray(offs, np.int64)
        flat = np.asarray(flat, np.int64)
        return (flat[offs[a]:offs[b]], offs[a:b + 1] - offs[a])
    if hasattr(col, "slice"):                           # pyarrow
        return col.slice(a, b - a)
    return col[a:b]


def _table_columns(table) -> Dict[str, object]:
    """dict-like or pyarrow.Table -> column mapping."""
    if hasattr(table, "column_names") and hasattr(table, "column"):
        cols = {}
        for name in table.column_names:
            c = table.column(name)
            if hasattr(c, "combine_chunks"):
                c = c.combine_chunks()
            cols[name] = c
        return cols
    if isinstance(table, dict):
        return table
    raise IngestError(f"unsupported table type {type(table)}")


def resolve_ladder(cfg: ScanConfig) -> str:
    """The kernel ladder a config selects: static_key wins, then an
    explicit ladder, then CUDASP_LADDER, then "fixed"."""
    if cfg.static_key:
        return "static"
    ladder = (cfg.ladder if cfg.ladder != "auto"
              else os.environ.get("CUDASP_LADDER", "auto"))
    ladder = "fixed" if ladder == "auto" else ladder
    if ladder not in LADDERS:
        raise BindError(f"ladder must be 'auto' or one of {LADDERS}, got "
                        f"{ladder!r}")
    return ladder


def resolve_backend(cfg: ScanConfig) -> str:
    """"xla" for the XLA backend's counterpart, else "pallas" (the
    kernel); an unknown backend is a BindError."""
    if cfg.backend not in BACKENDS + ("auto",):
        raise BindError(f"backend must be 'auto', 'pallas' or 'xla', got "
                        f"{cfg.backend!r}")
    return "xla" if cfg.backend == "xla" else "pallas"


def resolve_upload(cfg: ScanConfig) -> str:
    """The upload mode a config selects: an explicit mode, else
    CUDASP_UPLOAD, else "auto". Anything else (a misspelt mode, or full64
    joined to a cut, for which there is no wire) is a BindError."""
    upload = (cfg.upload if cfg.upload != "auto"
              else os.environ.get("CUDASP_UPLOAD", "auto"))
    if upload not in UPLOADS:
        raise BindError(f"upload must be one of {UPLOADS}, got {upload!r}")
    return upload


def _resolve_device(device, mesh=None) -> torch.device:
    if mesh is not None:
        kind = mesh.device_type
        if device is not None and torch.device(device).type != kind:
            raise BindError(f"device {device!r} disagrees with the mesh's "
                            f"{kind} devices {mesh}")
        device = mesh.devices[0]
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("cudasp_tpu_torch.scan runs on a CUDA device and "
                           "none is available; pass device='cpu' to run the "
                           "kernel's plain version on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise BindError(f"unsupported device {dev}")
    return dev


def scan(table, scan_private_key: bytes, spend_public_key: bytes,
         label_keys: Sequence[bytes] = (), *,
         batch_size: Optional[int] = None,
         config: Optional[ScanConfig] = None, device=None) -> ScanResult:
    """Scan `table` for BIP-352 silent-payment matches.

    table: mapping (or pyarrow.Table) with columns
        txid      - arbitrary per-row ids (passed through)
        height    - int (passed through)
        tweak_key - 64-byte blobs (LE x || LE y uncompressed point)
        outputs   - per-row variable-length int64 lists
    scan_private_key: 32-byte LE scalar blob
    spend_public_key: 64-byte LE point blob
    label_keys: 64-byte LE point blobs
    device: "cuda" (default) or "cpu"; with config.mesh, the mesh's
    devices decide, and a device of another type is a BindError.

    Set CUDASP_PROFILE_DIR to write a torch.profiler trace of the scan
    there, and CUDASP_METRICS=1 to print one JSON line of its metrics on
    stderr (runtime.trace)."""
    with trace_scan():
        res = _scan_impl(table, scan_private_key, spend_public_key,
                         label_keys, batch_size=batch_size, config=config,
                         device=device)
    if os.environ.get("CUDASP_METRICS"):
        emit_metrics(res.metrics)
    return res


# ScanMetrics fields a stream adds up over its chunks; of the others, the
# last chunk's value stands (upload_mode: the last that was set)
_SUMMED = ("rows_in", "rows_scanned", "batches", "pack_seconds",
           "device_seconds", "total_seconds", "upload_seconds",
           "upload_bytes", "h2d_seconds", "device_wait_seconds",
           "reverified_rows", "exchange_seconds", "exchange_bytes",
           "batch_retries")
_LAST = ("batch_size", "launch_rows", "n_devices", "ladder",
         "kernel0_seconds", "link_bytes_per_second", "prewarm_failures",
         "warm_variants")


def scan_stream(chunks, scan_private_key: bytes, spend_public_key: bytes,
                label_keys: Sequence[bytes] = (), *,
                config: Optional[ScanConfig] = None, checkpoint=None,
                device=None) -> ScanResult:
    """Scan an iterator of table chunks with bounded host memory.

    Each chunk (a column mapping, or a pyarrow RecordBatch or Table) is
    scanned on its own and only its matching rows are kept; the kernel
    libraries, the process's "auto" memo and the pinned-memory cache
    carry over from chunk to chunk. Returns one ScanResult with indices
    global to the stream; its metrics add up the chunks' (total_seconds:
    the chunks' scans, not the time spent reading them).

    checkpoint: a runtime.checkpoint.ScanCursor, advanced after every
    chunk (the caller saves it, for example from the chunk iterator).
    Chunks the cursor covers are skipped without packing; where it ends
    inside a chunk (another chunking), only the rest of that chunk is
    scanned. A cursor of another query is a BindError. A resumed stream
    returns the full txid / height / tweak_key columns, the earlier run's
    from the cursor's match_rows (indices only from a cursor without
    them). txid and height must be in every chunk or in none
    (IngestError). device: as for scan()."""
    from .runtime.checkpoint import _query_digest

    if checkpoint is not None:
        digest = _query_digest(scan_private_key, spend_public_key,
                               label_keys)
        if checkpoint.query_digest and checkpoint.query_digest != digest:
            raise BindError(
                "checkpoint was written by a different query (key "
                "mismatch); refusing to resume")
        checkpoint.query_digest = digest
    resumed = checkpoint is not None and checkpoint.rows_done > 0
    # before the loop extends checkpoint.matches: the rows that come from
    # the cursor, not from this run
    prior_matches = (sorted({int(m) for m in checkpoint.matches})
                     if resumed else [])

    idx_parts: List[np.ndarray] = []
    txid_parts, height_parts, tweak_parts = [], [], []
    agg = ScanMetrics() if (config is None or config.collect_metrics) else None
    offset = 0
    pt_schema = None       # (has txid, has height), the same in every chunk
    for chunk in chunks:
        if hasattr(chunk, "schema") and hasattr(chunk, "column"):
            chunk = {name: chunk.column(i)
                     for i, name in enumerate(chunk.schema.names)}
        cols = _table_columns(chunk)
        n = len(cols["tweak_key"])
        covered = (max(0, min(checkpoint.rows_done - offset, n))
                   if checkpoint is not None else 0)
        if covered >= n:
            offset += n
            continue
        if covered:
            cols = {name: _slice_col(c, covered, n)
                    for name, c in cols.items()}
        res = _scan_impl(cols, scan_private_key, spend_public_key,
                         label_keys, config=config, device=device)
        have = (res.txid is not None, res.height is not None)
        if pt_schema is None:
            pt_schema = have
        elif pt_schema != have:
            raise IngestError(
                "heterogeneous chunk schema: txid/height columns must be "
                f"present in every chunk or in none (saw {pt_schema} then "
                f"{have})")
        idx_parts.append(res.indices + offset + covered)
        if res.txid is not None:
            txid_parts.append(np.asarray(res.txid, dtype=object))
        if res.height is not None:
            height_parts.append(np.asarray(res.height))
        tweak_parts.append(res.tweak_key)
        m = res.metrics
        if agg is not None and m is not None:
            for name in _SUMMED:
                setattr(agg, name, getattr(agg, name) + getattr(m, name))
            for name in _LAST:
                setattr(agg, name, getattr(m, name))
            if m.upload_mode:
                agg.upload_mode = m.upload_mode
        offset += n
        if checkpoint is not None:
            checkpoint.rows_done = offset
            checkpoint.matches.extend(idx_parts[-1].tolist())
            checkpoint.record_rows(idx_parts[-1], res.txid, res.height,
                                   res.tweak_key)
    cat = (np.concatenate(idx_parts) if idx_parts
           else np.zeros(0, np.int64))
    if agg is not None:
        agg.matches = len(cat)
    if resumed:
        return _merge_resumed(cat, prior_matches, checkpoint, pt_schema,
                              txid_parts, height_parts, tweak_parts, agg)
    return ScanResult(
        indices=cat,
        txid=np.concatenate(txid_parts) if txid_parts else None,
        height=np.concatenate(height_parts) if height_parts else None,
        tweak_key=(np.concatenate(tweak_parts) if tweak_parts
                   else np.zeros((0, 64), np.uint8)),
        metrics=agg)


def _merge_resumed(cat, prior_matches, checkpoint, pt_schema, txid_parts,
                   height_parts, tweak_parts, agg) -> ScanResult:
    """This run's matches and the earlier run's, whose passthrough
    columns come from the cursor's match_rows; indices only where the
    cursor has no such rows."""
    prior = np.asarray(prior_matches, np.int64)
    all_idx = (np.unique(np.concatenate([cat, prior]))
               if len(cat) + len(prior) else np.zeros(0, np.int64))
    if agg is not None:
        agg.matches = len(all_idx)
    prior_rows = checkpoint.take_rows(prior_matches)
    if prior_rows is None:
        return ScanResult(indices=all_idx, txid=None, height=None,
                          tweak_key=None, metrics=agg)
    ptx, phh, ptw = prior_rows

    def presence(vals, what):
        nn = sum(v is not None for v in vals)
        if nn == 0:
            return False
        if nn == len(vals):
            return True
        raise IngestError(
            f"resumed cursor has mixed {what} presence in match_rows")

    if prior_matches:
        prior_schema = (presence(ptx, "txid"), presence(phh, "height"))
        if pt_schema is not None and pt_schema != prior_schema:
            raise IngestError(
                "resumed stream schema mismatch: the prior run recorded "
                f"passthrough columns {prior_schema}, this run saw "
                f"{pt_schema} (txid, height)")
        schema = prior_schema
    else:
        schema = pt_schema or (False, False)

    rowmap = {int(i): (ptx[k], phh[k], ptw[k])
              for k, i in enumerate(prior_matches)}
    fresh_tx = np.concatenate(txid_parts) if txid_parts else None
    fresh_h = np.concatenate(height_parts) if height_parts else None
    fresh_tw = (np.concatenate(tweak_parts) if tweak_parts
                else np.zeros((0, 64), np.uint8))
    for k, i in enumerate(cat):
        rowmap[int(i)] = (fresh_tx[k] if fresh_tx is not None else None,
                          fresh_h[k] if fresh_h is not None else None,
                          fresh_tw[k])
    return ScanResult(
        indices=all_idx,
        txid=(np.asarray([rowmap[int(i)][0] for i in all_idx], object)
              if schema[0] else None),
        height=(np.asarray([rowmap[int(i)][1] for i in all_idx])
                if schema[1] else None),
        tweak_key=(np.stack([rowmap[int(i)][2] for i in all_idx])
                   if len(all_idx) else np.zeros((0, 64), np.uint8)),
        metrics=agg)


def _scan_impl(table, scan_private_key, spend_public_key, label_keys=(), *,
               batch_size=None, config=None, device=None) -> ScanResult:
    cfg = config or ScanConfig()
    if batch_size is not None:
        cfg.batch_size = batch_size
    if not (0 < cfg.batch_size <= MAX_BATCH_SIZE):
        raise BindError(f"batch_size must be in (0, {MAX_BATCH_SIZE}], got "
                        f"{cfg.batch_size}")
    if len(bytes(scan_private_key)) != 32:
        raise BindError("scan_private_key must be exactly 32 bytes")
    if len(bytes(spend_public_key)) != 64:
        raise BindError("spend_public_key must be exactly 64 bytes")
    for i, lk in enumerate(label_keys):
        if len(bytes(lk)) != 64:
            raise BindError(f"label_keys[{i}] must be exactly 64 bytes")
    upload = resolve_upload(cfg)
    ladder = resolve_ladder(cfg)
    backend = resolve_backend(cfg)
    dev = _resolve_device(device, cfg.mesh)
    block_rows = cfg.block_rows or tuning.block_rows_default(dev)
    tile = cfg.tile or tuning.tile_default(dev)

    metrics = (ScanMetrics(batch_size=cfg.batch_size)
               if cfg.collect_metrics else None)
    timer = Timer()
    cols = _table_columns(table)
    for required in ("tweak_key", "outputs"):
        if required not in cols:
            raise IngestError(f"missing required column '{required}'")
    tweaks, row_ok = _normalize_blob_column(cols["tweak_key"], 64,
                                            "tweak_key")
    flat, offsets = _normalize_outputs(cols["outputs"])
    n = tweaks.shape[0]
    if len(offsets) != n + 1:
        raise IngestError(
            f"outputs offsets length {len(offsets)} != rows+1 ({n + 1})")
    # NULL txid/height also skip the row
    for name in ("txid", "height"):
        c = cols.get(name)
        if c is not None and hasattr(c, "is_valid"):
            row_ok &= np.asarray(c.is_valid())
        elif isinstance(c, (list, tuple)):
            row_ok &= np.array([v is not None for v in c], bool)

    row_indices = None
    if not row_ok.all():
        keep = np.flatnonzero(row_ok)
        ln = (offsets[1:] - offsets[:-1])[keep]
        new_off = np.zeros(len(keep) + 1, np.int64)
        np.cumsum(ln, out=new_off[1:])
        flat = flat[np.repeat(offsets[keep] - new_off[:-1], ln)
                    + np.arange(new_off[-1], dtype=np.int64)]
        offsets = new_off
        tweaks_scan = tweaks[keep]
        row_indices = keep
    else:
        tweaks_scan = tweaks

    sched, spend, labels, _ = ingest.pack_query_keys(
        scan_private_key, spend_public_key, label_keys)

    def pow2_at_least(v, lo=128):
        p = lo
        while p < v:
            p *= 2
        return p

    n_scan = tweaks_scan.shape[0]
    eff_batch = max(block_rows,
                    min(pow2_at_least(cfg.batch_size),
                        pow2_at_least(max(n_scan, 1)), tile))
    # adaptive outputs width: never wider than the data needs, at most 30;
    # longer lists split into virtual rows
    lens = offsets[1:] - offsets[:-1]
    max_out = int(min(cfg.max_outputs, MAX_OUTPUTS_CAP,
                      max(int(lens.max()) if n_scan else 1, 1)))
    pack_time = [0.0]
    batches = ingest.iter_packed(tweaks_scan, flat, offsets,
                                 batch_size=eff_batch, max_outputs=max_out,
                                 row_indices=row_indices,
                                 pack_seconds=pack_time)
    if metrics is not None:
        metrics.rows_in = n
        metrics.launch_rows = eff_batch
    executor = BatchExecutor(dev, block_rows=block_rows, upload=upload,
                             ladder=ladder, mesh=cfg.mesh,
                             rebalance=cfg.rebalance, backend=backend,
                             fused=cfg.fused)
    results = executor.run(batches, sched, spend, labels, metrics=metrics)

    matched: List[np.ndarray] = []
    rows_scanned = 0
    for flags, sources in results:
        rows_scanned += int((sources >= 0).sum())
        matched.append(sources[flags & (sources >= 0)])
    # unique and in input order: a split row can match in several parts
    idx = (np.unique(np.concatenate(matched)) if matched
           else np.zeros(0, np.int64))

    def take(name):
        if name not in cols:
            return None
        col = cols[name]
        if isinstance(col, np.ndarray):
            return col[idx]
        if isinstance(col, (list, tuple)):
            # object array: an 'S' array would strip trailing NUL bytes
            arr = np.empty(len(col), object)
            arr[:] = col
            return arr[idx]
        return np.asarray(col)[idx]

    if metrics is not None:
        metrics.rows_scanned = rows_scanned
        metrics.pack_seconds += pack_time[0]
        metrics.matches = len(idx)
        metrics.total_seconds = timer.lap()
    return ScanResult(
        indices=idx, txid=take("txid"), height=take("height"),
        tweak_key=tweaks[idx] if len(idx) else np.zeros((0, 64), np.uint8),
        metrics=metrics)
