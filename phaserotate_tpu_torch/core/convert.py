"""The parameters carried across from the JAX package.

This system has no trained weights.  Its parameters are the Hilbert FIR
taps, the partition spectra of that FIR, and the two angle tables.  The
JAX package keeps spectra in a real/imag ("ri") float32 layout
``(n_segm, P+1, 2)``; the port keeps complex64 ``(n_segm, P+1)``.

:func:`constants_from_jax` turns the JAX package's numpy arrays into the
port's tensors; :func:`port_constants` builds the same dictionary from the
port's own designers.  The two agree bit for bit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .angles import _all_angle_cos_sin_np, _sincos_lut_np
from .fir import _design_hilbert_fir_np, _partition_fir_spectra_np

__all__ = ["constants_from_jax", "port_constants"]


def _real(a: np.ndarray, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _ri_to_complex(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    if a.shape[-1] != 2:
        raise ValueError(f"expected ri layout (..., 2), got {a.shape}")
    return torch.complex(_real(a[..., 0], device), _real(a[..., 1], device))


# key -> converter; the keys are the entries of port_constants()
_CONVERTERS = {
    "fir": _real,                  # (taps,) float32
    "fir_spectra": _ri_to_complex,  # (n_segm, P+1, 2) ri -> complex64
    "sincos_lut": _real,           # (2, MAXSAMPLE) [sin; cos]
    "cos_sin": _real,              # (2, MAXSAMPLE) [cos; sin]
}


def constants_from_jax(np_dict: Dict[str, np.ndarray],
                       device=None) -> Dict[str, torch.Tensor]:
    """JAX-package numpy arrays -> the port's tensors on ``device``.

    ``np_dict`` holds any of: ``fir`` (``design_hilbert_fir``),
    ``fir_spectra`` (``partition_fir_spectra``, ri layout), ``sincos_lut``
    (``np.stack(sincos_lut())``) and ``cos_sin`` (``all_angle_cos_sin``).
    """
    unknown = set(np_dict) - set(_CONVERTERS)
    if unknown:
        raise KeyError(f"unknown constants {sorted(unknown)}")
    return {k: _CONVERTERS[k](v, device) for k, v in np_dict.items()}


def port_constants(fir_taps: int, parsiz: int,
                   device=None) -> Dict[str, torch.Tensor]:
    """The same dictionary from the port's own designers."""
    return {
        "fir": torch.tensor(_design_hilbert_fir_np(fir_taps), device=device),
        "fir_spectra": torch.tensor(
            _partition_fir_spectra_np(fir_taps, parsiz), device=device),
        "sincos_lut": torch.tensor(np.stack(_sincos_lut_np()), device=device),
        "cos_sin": torch.tensor(_all_angle_cos_sin_np(), device=device),
    }
