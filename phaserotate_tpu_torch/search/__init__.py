"""Minimum-peak angle search: batched sweep + CLI-parity selection."""

from typing import Optional

import torch

from ..core.angles import SUBSAMPLE
from ..core.device import as_f32
from ..core.sizes import OfflineGeometry, offline_geometry
from .minimize import (
    SearchResult,
    select_min_peak_angles,
    select_min_peak_angles_batch,
)
from .sweep import apply_angles, hilbert_offline, sweep_peaks, sweep_peaks_aux

__all__ = [
    "SearchResult",
    "apply_angles",
    "find_min_peak_angle",
    "hilbert_offline",
    "select_min_peak_angles",
    "select_min_peak_angles_batch",
    "sweep_peaks",
    "sweep_peaks_aux",
]


def find_min_peak_angle(
    audio,
    rate: int = 48000,
    stride: int = 12 * SUBSAMPLE,
    link_channels: bool = False,
    blksiz: int = 0,
    geom: Optional[OfflineGeometry] = None,
    device=None,
) -> SearchResult:
    """Find the phase-rotation angle(s) minimizing the digital peak.

    Mirrors ``phase-rotate <file>`` (cli/phase-rotate.cc:779-948): same
    block geometry, same coarse stride + 7 % candidate tolerance + fine
    refinement + channel unwrapping — evaluated from one batched sweep.

    Args:
      audio: (n,) mono or (channels, n) float array or tensor.
      rate: sample rate (sets the default block size, rate/8 -> pow2).
      stride: coarse step in half-degree units (CLI ``-s``).
      link_channels: minimize the downmixed peak (CLI ``-l``).
      blksiz: explicit block size (CLI ``-f``), 0 = derive from rate.
      device: where ``audio`` goes (``"cpu"`` for the CPU); without it a
        tensor stays on its own device and other input goes to the CUDA
        device.

    Returns a :class:`SearchResult` with per-channel angles in degrees.
    """
    x = torch.atleast_2d(as_f32(audio, device))
    if geom is None:
        geom = offline_geometry(rate, blksiz)
    table, rot0 = sweep_peaks_aux(x, geom)
    return select_min_peak_angles(
        table.cpu().numpy(),
        stride=stride,
        link_channels=link_channels,
        rot0=rot0.cpu().numpy(),
    )


def refine_angle(audio, theta0_units, geom, steps: int = 24, device=None):
    """Continuous sub-grid refinement (lazy import; see
    phaserotate_tpu_torch.search.gradient)."""
    from .gradient import refine_angle as _impl

    return _impl(audio, theta0_units, geom, steps=steps, device=device)


def peak_at_angle(x, theta_units, geom, device=None):
    """Hard peak at a continuous angle (lazy import; see
    phaserotate_tpu_torch.search.gradient)."""
    from .gradient import peak_at_angle as _impl

    return _impl(x, theta_units, geom, device=device)
