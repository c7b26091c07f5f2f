"""Offline (whole-buffer) phase rotation (torch).

Same semantics as ``phaserotate_tpu/ops/rotate.py``: rotating by ``d``
degrees multiplies every positive-frequency component by ``e^{-j*theta}``
(``theta = 2*pi*d/360``), i.e. ``cos(w t) -> cos(w t - theta)``.

* ``spectral`` — exact, zero latency: one whole-signal real FFT, per-bin
  complex rotation, inverse FFT.  DC and Nyquist scale by cos(theta).
* ``fir`` — the plugin's windowed-FIR filter (src/phaserotate.c:374-401 +
  640-717), time-aligned.  On CUDA it runs the stream_conv kernel in mix
  mode for every FIR that kernel can frame, and the fused_conv kernel for
  the other FIRs up to 16384 taps.

Both take batched input ``(..., n)`` and ``degrees`` broadcastable to the
leading dims.

Dispatch follows the JAX package's: where JAX on a TPU takes a Pallas
kernel the port on CUDA takes its CUDA kernel, and where JAX takes plain
XLA the port takes plain torch.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import angles as _angles
from ..core import sizes as _sizes
from ..core.device import as_f32
from ..core.fir import partition_fir_spectra
from ..kernels.fused_conv import (
    fused_hilbert,
    fused_parsiz_for,
    fused_rotate_fir,
    mix_supported,
    supported_parsiz,
)
from ..kernels.stream_conv import rotate_small, stream_mix_supported
from .convolve import partitioned_convolve

__all__ = ["rotate", "rotate_spectral", "rotate_fir", "hilbert_fir"]


def _theta(degrees, device) -> torch.Tensor:
    """Degrees -> rotation angle theta (radians), via the reference's
    clamped negated-turns representation (src/phaserotate.c:564-571)."""
    turns = _angles.degrees_to_turns(degrees, device=device)
    return -_angles.turns_to_radians(turns)


def rotate_spectral(audio, degrees, device=None) -> torch.Tensor:
    """Exact spectral phase rotation of ``audio`` (..., n) by ``degrees``
    (scalar or broadcastable to the leading dims)."""
    x = as_f32(audio, device)
    n = x.shape[-1]
    theta = _theta(degrees, x.device)[..., None]
    X = torch.fft.rfft(x, dim=-1)  # (..., n//2+1)
    nbins = X.shape[-1]
    rot = torch.polar(torch.ones_like(theta), -theta)
    # DC (and Nyquist for even n) are their own conjugate mirror: the
    # rotation operator cos*I + sin*H degenerates to cos there.
    k = torch.arange(nbins, device=x.device)
    edge = (k == 0) | ((n % 2 == 0) & (k == nbins - 1))
    coef = torch.where(edge, torch.cos(theta).to(torch.complex64), rot)
    return torch.fft.irfft(X * coef, n=n, dim=-1)


def hilbert_fir(audio, firlen: int, device=None) -> torch.Tensor:
    """Apply the reference's windowed Hilbert FIR, time-aligned.

    Returns ``g(x)``, the *negative* Hilbert transformer's approximation
    (core/fir.py) with its group delay of ``firlen/2`` compensated.
    On CUDA the fused_conv kernel runs every FIR up to 16384 taps;
    elsewhere, and above that, the single-partition OLA on ``torch.fft``
    (as the JAX package leaves those to plain XLA).
    """
    x = as_f32(audio, device)
    lat = firlen // 2
    if x.device.type == "cuda" and supported_parsiz(fused_parsiz_for(firlen)):
        full = fused_hilbert(x, firlen)
        return full[..., lat : lat + x.shape[-1]]
    spectra = partition_fir_spectra(firlen, firlen, x.device)
    full = partitioned_convolve(x, spectra, firlen)
    return full[..., lat : lat + x.shape[-1]]


def _rotate_fir_impl(x: torch.Tensor, turns: torch.Tensor, firlen: int):
    if stream_mix_supported(firlen):
        return rotate_small(x, turns, firlen)
    if x.device.type == "cuda" and mix_supported(firlen):
        return fused_rotate_fir(x, turns, firlen)
    sa, ca = _angles.sin_cos_turns(turns)
    h = hilbert_fir(x, firlen)
    return ca[..., None] * x + sa[..., None] * h


def rotate_fir(audio, degrees, rate: float = 48000.0,
               firlen: Optional[int] = None, device=None) -> torch.Tensor:
    """FIR phase rotation with the plugin's filter (parity path).

    Matches the steady-state output of the LV2 plugin at sample rate
    ``rate`` after its ``parsiz + firlen/2`` latency is trimmed
    (src/phaserotate.c:297).
    """
    x = as_f32(audio, device)
    if firlen is None:
        firlen = _sizes.stream_geometry_for_rate(rate).firlen
    turns = _angles.degrees_to_turns(degrees, device=x.device)
    return _rotate_fir_impl(x, turns, firlen)


def rotate(audio, degrees, method: str = "spectral", rate: float = 48000.0,
           firlen: Optional[int] = None, device=None) -> torch.Tensor:
    """Rotate the phase of every frequency component of ``audio`` by
    ``degrees``.

    Args:
      audio: (..., n) float array or tensor — any leading batch dims.
      degrees: scalar or broadcastable to ``audio.shape[:-1]``; positive
        values delay component phases (+90 turns sin into -cos).
      method: ``"spectral"`` (exact, default) or ``"fir"`` (plugin parity).
      rate: sample rate, used only to pick the FIR geometry for ``"fir"``.
      firlen: explicit FIR length override for ``"fir"``.
      device: where ``audio`` goes (``"cpu"`` for the CPU); without it a
        tensor stays on its own device and other input goes to the CUDA
        device.

    Returns the rotated signal, float32, same shape, time-aligned.
    """
    if method == "spectral":
        return rotate_spectral(audio, degrees, device=device)
    if method == "fir":
        return rotate_fir(audio, degrees, rate=rate, firlen=firlen,
                          device=device)
    raise ValueError(f"unknown method {method!r}; expected 'spectral' or 'fir'")
