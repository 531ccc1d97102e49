"""Resumable scans: a cursor over tables of 100M+ rows (counterpart of
cudasp_tpu/runtime/checkpoint.py).

A scan over a large table goes in chunks; after each chunk the cursor
(rows consumed, matches so far and their passthrough cells) can be saved,
and a restarted scan continues from the last save instead of row 0.

The cursor is small JSON in the JAX package's format, with the same
query digest: a cursor written by either package resumes in the other.
Resuming needs the same table order and query keys (the keys are
checksummed, so a cursor of another query is refused), not the same
process, host or mesh.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


def _query_digest(scan_key: bytes, spend_key: bytes, labels) -> str:
    h = hashlib.sha256()
    h.update(bytes(scan_key))
    h.update(bytes(spend_key))
    for lb in labels:
        h.update(bytes(lb))
    return h.hexdigest()[:16]


def _enc_val(v):
    """JSON form of one passthrough cell (txid or height), tagged so that
    _dec_val restores its Python type; a value it cannot encode becomes
    {"r": null}, and resuming past it gives index-only columns."""
    if v is None:
        return None
    if isinstance(v, (bytes, bytearray, np.bytes_)):
        return {"b": bytes(v).hex()}
    if isinstance(v, (bool, np.bool_, int, np.integer)):
        return {"i": int(v)}
    if isinstance(v, str):
        return {"s": v}
    if isinstance(v, np.ndarray) and v.dtype == np.uint8 and v.ndim == 1:
        return {"b": v.tobytes().hex()}
    return {"r": None}


class _Unencodable:
    __slots__ = ()


_UNENCODABLE = _Unencodable()


def _dec_val(e):
    """Inverse of _enc_val; {"r": null} decodes to _UNENCODABLE."""
    if e is None:
        return None
    if "b" in e:
        return bytes.fromhex(e["b"])
    if "i" in e:
        return e["i"]
    if "s" in e:
        return e["s"]
    return _UNENCODABLE


@dataclass
class ScanCursor:
    """Progress of a resumable scan.

    match_rows holds the passthrough cells (txid, height, tweak_key) of
    every matched row, keyed by the global row index as a string, so that
    a resumed scan_stream returns the same full columns as a fresh run.
    Entries are [txid_enc, height_enc, tweak_hex]."""
    rows_done: int = 0
    matches: List[int] = field(default_factory=list)
    query_digest: str = ""
    match_rows: dict = field(default_factory=dict)

    def record_rows(self, indices, txid, height, tweak_key) -> None:
        """Keep the passthrough cells of matched rows (global indices).
        txid / height may be None (no such column); tweak_key is (m, 64)
        uint8."""
        m = len(indices)
        tx = [None] * m if txid is None else [_enc_val(v) for v in txid]
        hh = [None] * m if height is None else [_enc_val(v) for v in height]
        hexes = np.ascontiguousarray(tweak_key, np.uint8).tobytes().hex()
        for k, idx in enumerate(np.asarray(indices).tolist()):
            self.match_rows[str(idx)] = [tx[k], hh[k],
                                         hexes[128 * k:128 * (k + 1)]]

    def take_rows(self, indices):
        """(txid list, height list, tweak (m, 64) uint8) of `indices`, or
        None if an index has no recorded row or an unencodable cell (a
        cursor that predates match_rows: the caller returns indices
        only)."""
        txids, heights, tweaks = [], [], []
        for idx in indices:
            e = self.match_rows.get(str(int(idx)))
            if e is None:
                return None
            t, h = _dec_val(e[0]), _dec_val(e[1])
            if t is _UNENCODABLE or h is _UNENCODABLE:
                return None
            txids.append(t)
            heights.append(h)
            tweaks.append(np.frombuffer(bytes.fromhex(e[2]), np.uint8))
        tw = np.stack(tweaks) if tweaks else np.zeros((0, 64), np.uint8)
        return txids, heights, tw

    def save(self, path: str) -> None:
        """Write the cursor to `path` atomically (a temporary file in the
        same directory, then os.replace). json.dumps, not json.dump: the
        same text, from the C encoder (json.dump streams through the
        Python one, about 4x slower on a cursor of megabytes)."""
        text = json.dumps({"rows_done": self.rows_done,
                           "matches": self.matches,
                           "query_digest": self.query_digest,
                           "match_rows": self.match_rows})
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "ScanCursor":
        with open(path) as f:
            d = json.load(f)
        return cls(rows_done=int(d["rows_done"]),
                   matches=[int(m) for m in d["matches"]],
                   query_digest=d.get("query_digest", ""),
                   match_rows=d.get("match_rows", {}))

    @classmethod
    def load_or_new(cls, path: Optional[str]) -> "ScanCursor":
        if path and os.path.exists(path):
            return cls.load(path)
        return cls()


def scan_resumable(table, scan_private_key: bytes, spend_public_key: bytes,
                   label_keys=(), *, cursor: Optional[ScanCursor] = None,
                   checkpoint_path: Optional[str] = None,
                   chunk_rows: int = 1 << 20, config=None, device=None):
    """Scan `table` in chunk_rows-row chunks, saving the cursor to
    checkpoint_path (if given) after each.

    Returns (sorted matched row indices, cursor). If `cursor` (or the file
    at checkpoint_path) says N rows are done, the first N rows are skipped
    without packing or device work. A cursor of another query raises
    ValueError, as in the JAX package. device: as for scan()."""
    from ..api import _slice_col, _table_columns, scan

    digest = _query_digest(scan_private_key, spend_public_key, label_keys)
    if cursor is None:
        cursor = ScanCursor.load_or_new(checkpoint_path)
    if cursor.query_digest and cursor.query_digest != digest:
        raise ValueError(
            "checkpoint was written by a different query (key mismatch); "
            "refusing to resume")
    cursor.query_digest = digest

    cols = _table_columns(table)
    n = len(cols["tweak_key"])
    while cursor.rows_done < n:
        a = cursor.rows_done
        b = min(a + chunk_rows, n)
        chunk = {name: _slice_col(c, a, b) for name, c in cols.items()}
        res = scan(chunk, scan_private_key, spend_public_key, label_keys,
                   config=config, device=device)
        cursor.matches.extend((res.indices + a).tolist())
        cursor.record_rows(res.indices + a, res.txid, res.height,
                           res.tweak_key)
        cursor.rows_done = b
        if checkpoint_path:
            cursor.save(checkpoint_path)
    return np.asarray(sorted(set(cursor.matches)), np.int64), cursor
