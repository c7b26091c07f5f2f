"""Angle conventions, wrapping, and the sin/cos tables (torch).

Same conventions as ``phaserotate_tpu/core/angles.py``: angles are stored
as *negated turns*, ``angle = degrees / -360`` clamped to [-0.5, 0.5]
(src/phaserotate.c:564-571), and ``sin_cos(angle)`` is
``sin/cos(2*pi*angle)`` (src/phaserotate.c:122-133).  The rotation mix
``out = ca*x + sa*fir(x)`` with the negated Hilbert FIR composes to

    out = cos(theta)*x - sin(theta)*H(x),  theta = 2*pi*degrees/360.

The CLI discretizes angles to half degrees: ``SUBSAMPLE = 2`` units per
degree and a ``MAXSAMPLE = 360`` entry table over 180 degrees
(cli/phase-rotate.cc:38-74).  The numpy table builders are copied
verbatim from the JAX package so the tables are bit-equal.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = [
    "SUBSAMPLE",
    "MAXSAMPLE",
    "degrees_to_turns",
    "turns_to_radians",
    "wrap_turns_delta",
    "sin_cos_turns",
    "angle_units_from_degrees",
    "wrap_angle_units",
    "sincos_lut",
    "degrees_to_turns_np",
    "sin_cos_units",
    "all_angle_cos_sin",
]

SUBSAMPLE = 2  # angle-units per degree (cli/phase-rotate.cc:38)
MAXSAMPLE = 180 * SUBSAMPLE  # table length: 180 deg span (cli/phase-rotate.cc:39)

_TWO_PI = np.float32(2.0 * np.pi)


def degrees_to_turns(degrees, device=None) -> torch.Tensor:
    """Port-value degrees -> negated turns, clamped to [-0.5, 0.5]
    (src/phaserotate.c:564-571).

    The float32 quotient is formed in float64 and rounded once: that is
    the correctly rounded float32 division of the JAX twin, whatever
    reciprocal trick a backend applies to division by a scalar.
    """
    d = torch.as_tensor(degrees, dtype=torch.float32, device=device)
    t = (d.double() / -360.0).float()
    return torch.clamp(t, -0.5, 0.5)


def degrees_to_turns_np(degrees) -> "np.ndarray":
    """Numpy twin of :func:`degrees_to_turns` for host-side real-time
    paths: identical float32 arithmetic, zero device involvement."""
    t = np.asarray(degrees, np.float32) / np.float32(-360.0)
    return np.clip(t, np.float32(-0.5), np.float32(0.5)).astype(
        np.float32)


def turns_to_radians(turns) -> torch.Tensor:
    return torch.as_tensor(turns, dtype=torch.float32) * float(_TWO_PI)


def wrap_turns_delta(da) -> torch.Tensor:
    """Shortest-path angle delta in turns: wrap |da| > 0.5 around +-180 deg
    (src/phaserotate.c:676-683)."""
    da = torch.as_tensor(da, dtype=torch.float32)
    return torch.where(da.abs() > 0.5, da - torch.sign(da), da)


def sin_cos_turns(turns):
    """(sin, cos) of an angle given in turns (src/phaserotate.c:122-133)."""
    rad = turns_to_radians(turns)
    return torch.sin(rad), torch.cos(rad)


def angle_units_from_degrees(degrees: float) -> int:
    """Degrees -> integer half-degree units (cli/phase-rotate.cc:730).

    C ``round()`` semantics — halves round *away from zero*, unlike
    Python's banker's rounding: 10.25 deg -> 21 units (10.5 deg), not 20.
    """
    x = degrees * SUBSAMPLE
    return int(math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5))


def wrap_angle_units(a: int) -> int:
    """Wrap an angle-unit index into [0, MAXSAMPLE)
    (cli/phase-rotate.cc:281-284, 463)."""
    return (a + MAXSAMPLE) % MAXSAMPLE


@functools.lru_cache(maxsize=1)
def _sincos_lut_np() -> tuple[np.ndarray, np.ndarray]:
    """(sin, cos) tables over all MAXSAMPLE angle units.

    Entry ``a`` is sin/cos of ``-pi*a/360`` — the negated-degrees convention
    of ``SinCosLut`` (cli/phase-rotate.cc:44-55).  float64 evaluation rounded
    to float32 (the C library's sincosf is correctly rounded for these args).
    """
    mp = 2.0 * np.pi / SUBSAMPLE / -360.0
    idx = np.arange(MAXSAMPLE)
    return (
        np.sin(mp * idx).astype(np.float32),
        np.cos(mp * idx).astype(np.float32),
    )


def sincos_lut(device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The CLI's 0.5-degree-resolution (sin, cos) LUT as tensors."""
    s, c = _sincos_lut_np()
    return torch.tensor(s, device=device), torch.tensor(c, device=device)


def sin_cos_units(a, device=None):
    """(sin, cos) for integer angle units, via table lookup.  The tables
    live where ``a`` does (a tensor), else on ``device`` (default CPU)."""
    if device is None and isinstance(a, torch.Tensor):
        device = a.device
    s, c = sincos_lut(device)
    a = torch.as_tensor(a, dtype=torch.int64, device=device)
    a = torch.remainder(a + MAXSAMPLE, MAXSAMPLE)
    return s[a], c[a]


@functools.lru_cache(maxsize=1)
def _all_angle_cos_sin_np() -> np.ndarray:
    """(2, MAXSAMPLE) float32 matrix of [cos; sin] over every angle unit:
    the candidate rotations of the angle sweep (cli/phase-rotate.cc:409-428).
    """
    s, c = _sincos_lut_np()
    return np.stack([c, s], axis=0)


def all_angle_cos_sin(device=None) -> torch.Tensor:
    return torch.tensor(_all_angle_cos_sin_np(), device=device)
