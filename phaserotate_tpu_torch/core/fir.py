"""Hilbert-transformer FIR design (torch).

The numpy designers are copied verbatim from ``phaserotate_tpu/core/fir.py``
so the taps and partition spectra are bit-equal to the JAX package's.  The
design (src/phaserotate.c:374-401, cli/phase-rotate.cc:144-164) reduces to

    fir[n] = irfft(j * (-1)^k, n=L)[n] * 0.5 * (1 - cos(2*pi*n/L))

the *negative* of the ideal Hilbert transformer delayed by L/2; the
rotation mixer's negated-angle convention (core/angles.py) compensates.

Spectra are complex64 tensors, ``(n_segm, parsiz+1)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .sizes import OfflineGeometry, StreamGeometry

__all__ = [
    "design_hilbert_fir",
    "partition_fir_spectra",
    "stream_fir_spectra",
    "offline_fir_spectrum",
]


@functools.lru_cache(maxsize=32)
def _design_hilbert_fir_np(length: int) -> np.ndarray:
    """Hann-windowed Hilbert FIR of ``length`` taps, float32, as numpy.

    Computed once per length in float64 and rounded to float32, matching the
    reference's double-precision windowing (src/phaserotate.c:387-391 does
    the window math in double).
    """
    if length % 2:
        raise ValueError(f"FIR length must be even, got {length}")
    half = length // 2
    k = np.arange(half + 1)
    # Ideal response: purely imaginary, alternating sign (src/phaserotate.c:375-379).
    spec = 1j * np.where(k & 1, -1.0, 1.0)
    # Imaginary parts of DC/Nyquist bins are discarded by the real inverse
    # transform, exactly as FFTW's c2r does.
    fir = np.fft.irfft(spec, n=length)
    n = np.arange(length)
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / length))
    return (fir * hann).astype(np.float32)


def design_hilbert_fir(length: int, device=None) -> torch.Tensor:
    """Return the windowed Hilbert FIR (``length`` taps, float32).

    Group delay is ``length/2`` samples.  Convolving ``x`` with it yields
    ``-H(x)`` delayed, where ``H(cos) = sin``.
    """
    return torch.tensor(_design_hilbert_fir_np(length), device=device)


@functools.lru_cache(maxsize=32)
def _partition_fir_spectra_np(length: int, parsiz: int) -> np.ndarray:
    """FIR split into uniform partitions, each zero-padded to ``2*parsiz``
    and forward-FFT'd: shape ``(n_segm, parsiz+1)`` complex64.

    Equivalent to the reference's per-segment r2c transforms
    (src/phaserotate.c:396-401), minus FFTW's normalization constant which
    cancels against the inverse transform in the convolution engine.
    """
    fir = _design_hilbert_fir_np(length)
    if length % parsiz:
        raise ValueError(f"FIR length {length} not divisible by parsiz {parsiz}")
    n_segm = length // parsiz
    segments = fir.reshape(n_segm, parsiz)
    padded = np.concatenate(
        [segments, np.zeros((n_segm, parsiz), np.float32)], axis=1
    )
    return np.fft.rfft(padded, axis=1).astype(np.complex64)


def partition_fir_spectra(length: int, parsiz: int,
                          device=None) -> torch.Tensor:
    """Partitioned FIR spectra, complex64 ``(n_segm, parsiz+1)``."""
    return torch.tensor(_partition_fir_spectra_np(length, parsiz),
                        device=device)


def stream_fir_spectra(geom: StreamGeometry, device=None) -> torch.Tensor:
    """Partitioned spectra for the streaming engine's geometry."""
    return partition_fir_spectra(geom.firlen, geom.parsiz, device)


def offline_fir_spectrum(geom: OfflineGeometry, device=None) -> torch.Tensor:
    """Single-partition FIR spectrum ``(parsiz+1,)`` for the offline engine.

    The offline FIR support is ``parsiz`` taps with group delay ``parsiz/2``
    (cli/phase-rotate.cc:144-164); one partition of the full FFT size.
    """
    return partition_fir_spectra(geom.parsiz, geom.parsiz, device)[0]
