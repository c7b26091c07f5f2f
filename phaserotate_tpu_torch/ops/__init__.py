"""Whole-buffer ops: rotation, convolution, peak reductions."""

from .convolve import fft_convolve, next_pow2, partitioned_convolve
from .peak import compute_peak, coeff_to_db, rotated_peak, rotated_peak_sweep
from .rotate import hilbert_fir, rotate, rotate_fir, rotate_spectral

__all__ = [
    "coeff_to_db",
    "compute_peak",
    "fft_convolve",
    "hilbert_fir",
    "next_pow2",
    "partitioned_convolve",
    "rotate",
    "rotate_fir",
    "rotate_spectral",
    "rotated_peak",
    "rotated_peak_sweep",
]
