"""Gradient-based continuous angle refinement (torch).

Counterpart of ``phaserotate_tpu/search/gradient.py``.  The reference's
resolution floor is the 0.5 degree grid (SUBSAMPLE,
cli/phase-rotate.cc:38); the peak-vs-angle objective is differentiable in
the angle, so it can be descended *continuously*: starting from the table
argmin, a few damped gradient steps on a softmax-smoothed peak polish the
angle to arbitrary precision.

The objective matches the full sweep evaluation map (sweep.aligned_pair):

    peak(theta) = max( max_m |cos t * x_d[m] + sin t * h[m]|,
                       |sin t| * h_start )

including the start-block term, so the reported value is the realized
output peak.  Descent runs on the smoothed ``softpeak_T`` with a
temperature annealed toward the hard max; steps are kept only when the
hard peak improves, so the result is always <= the starting grid point.

The operands ``x_d``, ``h`` and ``h_start`` are constants of the descent
(on a CUDA tensor the Hilbert signal comes from the stream_conv kernel,
once per call); only ``theta`` carries a gradient.  ``theta``, the step
size and the accepted peak stay 0-d tensors on the device for the whole
loop and are selected with ``torch.where``: the host reads them once, at
the end.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.device import as_f32
from ..core.sizes import OfflineGeometry

__all__ = ["refine_angle", "peak_at_angle"]

# half-degree units -> radians (negated where it is used), rounded to
# float32 as the JAX package's constant is
_RAD = float(np.float32(np.pi / 360.0))


def _operands(x: torch.Tensor, geom: OfflineGeometry):
    from .sweep import aligned_pair

    with torch.no_grad():
        b0, b1, h_start, _ = aligned_pair(x, geom)
    return b0, b1, h_start


def _hard_peak(theta_units, b0, b1, h_start):
    rad = theta_units * _RAD * -1.0
    sa = torch.sin(rad)
    aligned = (torch.cos(rad) * b0 + sa * b1).abs().amax()
    return torch.maximum(aligned, sa.abs() * h_start)


def _softpeak(theta_units, temp: float, b0, b1, h_start):
    """Log-mean-exp of the objective's terms around their max, at
    temperature ``temp``.  ``abs`` at 0 has gradient 0 and ``amax`` shares
    its gradient between ties, so degenerate inputs stay finite."""
    rad = theta_units * _RAD * -1.0
    sa = torch.sin(rad)
    y = (torch.cos(rad) * b0 + sa * b1).abs()
    y = torch.cat([y, (sa.abs() * h_start)[None]])
    m = y.amax()
    return m + temp * torch.log(torch.mean(torch.exp((y - m) / temp)))


def _temperatures(steps: int) -> list:
    """The annealing schedule ``1e-3 * exp(-i / (steps/3))`` in float32."""
    i = np.arange(steps, dtype=np.float32)
    t = np.float32(1e-3) * np.exp(-i / np.float32(steps / 3.0))
    return [float(v) for v in t.astype(np.float32)]


def peak_at_angle(x, theta_units, geom: OfflineGeometry,
                  device=None) -> torch.Tensor:
    """Hard peak at a *continuous* angle (half-degree units, float),
    over the complete sweep evaluation map incl. the start block.

    ``x`` is one channel ``(n,)``; numpy input goes to the CUDA device
    unless ``device="cpu"``.  Returns a 0-d tensor.
    """
    x = as_f32(x, device)
    b0, b1, h_start = _operands(x, geom)
    theta = torch.as_tensor(theta_units, dtype=torch.float32,
                            device=x.device)
    with torch.no_grad():
        return _hard_peak(theta, b0, b1, h_start)


def _refine_impl(x: torch.Tensor, theta0: float, geom: OfflineGeometry,
                 steps: int):
    b0, b1, h_start = _operands(x, geom)
    theta = torch.tensor(theta0, dtype=torch.float32, device=x.device)
    lr = torch.tensor(2.0, dtype=torch.float32, device=x.device)
    with torch.no_grad():
        cur = _hard_peak(theta, b0, b1, h_start)
    for temp in _temperatures(steps):
        # a fresh leaf each step: the graph of one step is freed with it
        leaf = theta.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(
            _softpeak(leaf, temp, b0, b1, h_start), leaf)
        with torch.no_grad():
            theta_new = theta - lr * g
            # backtrack: keep the step only if the hard peak improved
            # (one hard evaluation per step, no host readback)
            new_peak = _hard_peak(theta_new, b0, b1, h_start)
            improved = new_peak < cur
            theta = torch.where(improved, theta_new, theta)
            cur = torch.where(improved, new_peak, cur)
            lr = torch.where(improved, lr * 1.1, lr * 0.5)
    return theta, cur


def refine_angle(
    audio,
    theta0_units: float,
    geom: OfflineGeometry,
    steps: int = 24,
    device=None,
) -> Tuple[float, float]:
    """Polish a candidate angle continuously.

    Args:
      audio: (n,) one channel.
      theta0_units: starting angle in half-degree units (e.g. the table
        argmin from the grid sweep).
      steps: descent iterations.
      device: where ``audio`` goes (``"cpu"`` for the CPU); without it a
        tensor stays on its own device and other input goes to the CUDA
        device.

    Returns (theta_units_float, peak): the refined sub-grid angle and its
    realized peak — always <= the starting grid point's peak.
    """
    x = as_f32(audio, device)
    t, p = _refine_impl(x, float(theta0_units), geom, steps)
    both = torch.stack([t, p]).cpu()  # the one readback
    return float(both[0]), float(both[1])
