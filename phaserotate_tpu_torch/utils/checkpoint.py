"""Sweep checkpointing for resumable batch jobs.

Copied verbatim from ``phaserotate_tpu/utils/checkpoint.py`` (numpy only),
so a checkpoint written by either package resumes in the other.  The
reference's only persistence is UI state inside a plugin instance
(src/phaserotate.c:815-826); batch analysis restarts from scratch on every
run.  Here the per-file peak tables — the entire analysis state — are an
explicit array, so fleet jobs checkpoint them to disk and resume
mid-dataset.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["SweepCheckpoint"]


class SweepCheckpoint:
    """Append-only store of per-file peak tables.

    Layout: ``<path>`` is an .npz updated atomically; keys are file ids,
    values are (channels, MAXSAMPLE) float32 tables plus a parallel
    ``<id>//rot0`` entry.
    """

    def __init__(self, path: str, blksiz: Optional[int] = None):
        """``blksiz`` fingerprints the sweep geometry: tables computed
        under a different block size are NOT interchangeable (different
        Hilbert FIR), so a mismatch against a stored fingerprint raises
        instead of silently reusing wrong tables."""
        self.path = path
        self.blksiz = blksiz
        self._tables: Dict[str, np.ndarray] = {}
        self._rot0: Dict[str, np.ndarray] = {}
        if os.path.exists(path):
            has_fingerprint = False
            with np.load(path, allow_pickle=False) as z:
                for k in z.files:
                    if k == "//blksiz":
                        has_fingerprint = True
                        stored = int(z[k])
                        if blksiz is not None and stored != blksiz:
                            raise ValueError(
                                f"checkpoint {path} holds sweeps for "
                                f"blksiz {stored}, analyzer uses "
                                f"{blksiz} — use a separate checkpoint "
                                "per geometry")
                        self.blksiz = stored
                    elif k.endswith("//rot0"):
                        self._rot0[k[: -len("//rot0")]] = z[k]
                    else:
                        self._tables[k] = z[k]
            if blksiz is not None and self._tables and not has_fingerprint:
                # a pre-fingerprint checkpoint can't prove its geometry;
                # surface that instead of silently trusting it
                import warnings

                warnings.warn(
                    f"checkpoint {path} predates geometry fingerprints; "
                    f"its tables cannot be verified against blksiz "
                    f"{blksiz} — delete it if the block size may have "
                    "changed", stacklevel=2)

    def __contains__(self, file_id: str) -> bool:
        return file_id in self._tables

    def __len__(self) -> int:
        return len(self._tables)

    def get(self, file_id: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if file_id not in self._tables:
            return None
        return self._tables[file_id], self._rot0[file_id]

    def put(self, file_id: str, table: np.ndarray, rot0: np.ndarray,
            flush: bool = True) -> None:
        self._tables[file_id] = np.asarray(table, np.float32)
        self._rot0[file_id] = np.asarray(rot0, np.float32)
        if flush:
            self.flush()

    def flush(self) -> None:
        """Atomic write: temp file + rename."""
        payload = dict(self._tables)
        payload.update({k + "//rot0": v for k, v in self._rot0.items()})
        if self.blksiz is not None:
            payload["//blksiz"] = np.int64(self.blksiz)
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
