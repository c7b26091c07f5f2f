"""The parameters carried across from the JAX package.

This system has no trained weights.  Its parameters are the Hilbert FIR
taps, the partition spectra of that FIR, and the two angle tables.  The
JAX package keeps spectra in a real/imag ("ri") float32 layout
``(n_segm, P+1, 2)``; the port keeps complex64 ``(n_segm, P+1)``.

:func:`constants_from_jax` turns the JAX package's numpy arrays into the
port's tensors; :func:`port_constants` builds the same dictionary from the
port's own designers.  The two agree bit for bit.

The streaming and meter states cross over the same way:
:func:`stream_state_from_jax` / :func:`meter_state_from_jax` take the JAX
package's state fields as numpy arrays (``spec_hist`` in the ri layout)
and return the port's dataclasses; :func:`stream_state_to_jax` /
:func:`meter_state_to_jax` are their inverses (the checkpoint format).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .angles import _all_angle_cos_sin_np, _sincos_lut_np
from .fir import _design_hilbert_fir_np, _partition_fir_spectra_np

__all__ = ["constants_from_jax", "meter_state_from_jax",
           "meter_state_to_jax", "port_constants", "stream_state_from_jax",
           "stream_state_to_jax"]


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


def stream_state_from_jax(arrays: Mapping[str, np.ndarray], device=None):
    """The JAX package's ``StreamState`` fields (numpy; ``spec_hist``
    (..., n_segm, P+1, 2) ri) -> the port's ``StreamState`` on
    ``device`` (``spec_hist`` complex64)."""
    from ..stream.engine import StreamState

    return StreamState(
        spec_hist=_ri_to_complex(arrays["spec_hist"], device),
        time_hist=_real(arrays["time_hist"], device),
        tail=_real(arrays["tail"], device),
        angle=_real(arrays["angle"], device),
    )


def stream_state_to_jax(state) -> Dict[str, np.ndarray]:
    """Inverse of :func:`stream_state_from_jax`: numpy fields in the JAX
    package's layout."""
    spec = state.spec_hist.detach().cpu()
    return {
        "spec_hist": np.stack([spec.real.numpy(), spec.imag.numpy()],
                              axis=-1).astype(np.float32),
        "time_hist": state.time_hist.detach().cpu().numpy(),
        "tail": state.tail.detach().cpu().numpy(),
        "angle": state.angle.detach().cpu().numpy(),
    }


_METER_INT_FIELDS = ("holdcnt", "reset_delay")
_METER_FIELDS = ("momentary", "peak", "holdcnt", "diff", "reset_delay",
                 "dly")


def meter_state_from_jax(arrays: Mapping[str, np.ndarray], device=None):
    """The JAX package's ``MeterState`` fields (numpy) -> the port's
    ``MeterState`` on ``device``."""
    from ..meter.meter import MeterState

    def conv(name):
        dtype = np.int32 if name in _METER_INT_FIELDS else np.float32
        return torch.tensor(np.asarray(arrays[name], dtype), device=device)

    return MeterState(**{f: conv(f) for f in _METER_FIELDS})


def meter_state_to_jax(state) -> Dict[str, np.ndarray]:
    """Inverse of :func:`meter_state_from_jax`."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in _METER_FIELDS}
