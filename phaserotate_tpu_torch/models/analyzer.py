"""Angle-analyzer model: resumable fleet analysis (torch).

Counterpart of ``phaserotate_tpu/models/analyzer.py``: the batched sweep,
the CLI-parity selection and sweep checkpointing behind one object.  Point
it at a set of files, get per-file minimum-peak angles, resume after an
interruption.  The sweep runs on ``device`` (``"cpu"`` for the CPU);
without it where the audio tensor lies, or for other input on the CUDA
device: the two CUDA kernels on the card.  Peak tables and results are numpy on the
host.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.angles import SUBSAMPLE
from ..core.device import as_f32
from ..core.sizes import offline_geometry
from ..search.minimize import SearchResult, select_min_peak_angles
from ..search.sweep import apply_angles, sweep_peaks_aux
from ..utils.checkpoint import SweepCheckpoint

__all__ = ["AngleAnalyzer"]


class AngleAnalyzer:
    """Minimum-peak angle analyzer with optional checkpointing.

    Example::

        an = AngleAnalyzer(rate=48000, device="cuda")
        res = an.analyze(audio)                    # one file
        results = an.analyze_many(batch_dict,      # resumable fleet
                                  checkpoint="sweeps.npz")
    """

    def __init__(self, rate: int = 48000, blksiz: int = 0,
                 stride: int = 12 * SUBSAMPLE, link_channels: bool = False,
                 device=None):
        self.geom = offline_geometry(rate, blksiz)
        self.stride = stride
        self.link_channels = link_channels
        self.device = device

    def _audio(self, audio) -> torch.Tensor:
        return torch.atleast_2d(as_f32(audio, self.device))

    def sweep(self, audio) -> tuple:
        """Raw peak tables (table, rot0), numpy, for (channels, n) audio."""
        t, r = sweep_peaks_aux(self._audio(audio), self.geom)
        return t.cpu().numpy(), r.cpu().numpy()

    def select(self, table: np.ndarray, rot0: np.ndarray) -> SearchResult:
        return select_min_peak_angles(
            table, stride=self.stride, link_channels=self.link_channels,
            rot0=rot0)

    def analyze(self, audio) -> SearchResult:
        table, rot0 = self.sweep(audio)
        return self.select(table, rot0)

    def apply(self, audio, result: SearchResult) -> torch.Tensor:
        """The rotated audio, a tensor on the analyzer's device."""
        return apply_angles(self._audio(audio),
                            np.asarray(result.angles_units), self.geom)

    def analyze_many(
        self,
        files: Dict[str, np.ndarray],
        checkpoint: Optional[str] = None,
    ) -> Dict[str, SearchResult]:
        """Analyze a dict of file-id -> (channels, n) arrays or tensors.

        With ``checkpoint`` set, completed sweeps persist after every file
        and are skipped on re-runs — selection is recomputed from stored
        tables (so changing stride/link does not invalidate sweeps).
        """
        ckpt = SweepCheckpoint(checkpoint, blksiz=self.geom.blksiz) \
            if checkpoint else None
        out: Dict[str, SearchResult] = {}
        for fid, audio in files.items():
            if ckpt is not None and fid in ckpt:
                table, rot0 = ckpt.get(fid)
            else:
                table, rot0 = self.sweep(audio)
                if ckpt is not None:
                    ckpt.put(fid, table, rot0)
            out[fid] = self.select(table, rot0)
        return out
