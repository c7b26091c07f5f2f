"""Peak scanning (plain torch).

Torch twins of ``phaserotate_tpu/ops/peak.py``: the reference's SIMD peak
scan (cli/dsp_peak_calc.h) and rotated-peak evaluator
(cli/phase-rotate.cc:98-121).  :func:`rotated_peak_sweep` is the plain
version the CUDA sweep kernel (kernels/rotate_peak.py) is held to.
"""

from __future__ import annotations

import torch

__all__ = ["compute_peak", "rotated_peak", "rotated_peak_sweep", "coeff_to_db"]

# elements of one (rows, A, chunk) temporary of the sweep: 64 MiB of f32
_SWEEP_TEMP_ELEMS = 1 << 24


def compute_peak(buf: torch.Tensor, current=0.0) -> torch.Tensor:
    """max(|buf|) over the last axis folded with a running peak
    (dsp_peak_calc.h:27)."""
    peak = buf.abs().amax(dim=-1) if buf.numel() else buf.new_zeros(())
    return torch.clamp(peak, min=float(current))


def rotated_peak(b0: torch.Tensor, b1: torch.Tensor, sa, ca,
                 current=0.0) -> torch.Tensor:
    """Peak of ``ca*b0 + sa*b1`` (cli/phase-rotate.cc:98-121)."""
    return compute_peak(ca * b0 + sa * b1, current)


def rotated_peak_sweep(
    b0: torch.Tensor,
    b1: torch.Tensor,
    cos_sin: torch.Tensor,
) -> torch.Tensor:
    """Peak of ``cos[a]*b0 + sin[a]*b1`` for every angle ``a`` at once.

    Args:
      b0, b1: (..., n) float32 — aligned input and Hilbert signals.
      cos_sin: (2, A) float32 — stacked [cos; sin] rows
        (core/angles.all_angle_cos_sin).

    Returns (..., A) float32 peaks.  Each product and the sum are rounded
    to float32 separately (no fused multiply-add), and max is exact, so
    the CUDA kernel that rounds the same way matches this bit for bit.
    The samples are walked in chunks so the (rows, A, n) rotation tensor
    is never materialized.
    """
    lead = b0.shape[:-1]
    n = b0.shape[-1]
    # rows by count, not -1: an empty signal (n = 0) still has its rows
    rows = b0.reshape(lead.numel(), n)
    hil = b1.reshape(lead.numel(), n)
    a = cos_sin.shape[-1]
    c = cos_sin[0][None, :, None]
    s = cos_sin[1][None, :, None]
    chunk = max(1, _SWEEP_TEMP_ELEMS // max(1, rows.shape[0] * a))
    peaks = rows.new_zeros(rows.shape[0], a)
    for i in range(0, n, chunk):
        p = c * rows[:, None, i : i + chunk] + s * hil[:, None, i : i + chunk]
        peaks = torch.maximum(peaks, p.abs().amax(dim=-1))
    return peaks.reshape(*lead, a)


def coeff_to_db(coeff) -> torch.Tensor:
    """Linear coefficient -> dBFS; -inf below 1e-15
    (cli/phase-rotate.cc:76-83)."""
    coeff = torch.as_tensor(coeff, dtype=torch.float32)
    return torch.where(
        coeff < 1e-15,
        coeff.new_full((), -float("inf")),
        20.0 * torch.log10(torch.clamp(coeff, min=1e-30)),
    )
