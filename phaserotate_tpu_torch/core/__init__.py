"""Core DSP math: FIR design, sizing tables, angle conventions."""

from .angles import (
    MAXSAMPLE,
    SUBSAMPLE,
    all_angle_cos_sin,
    angle_units_from_degrees,
    degrees_to_turns,
    degrees_to_turns_np,
    sin_cos_turns,
    sin_cos_units,
    sincos_lut,
    turns_to_radians,
    wrap_angle_units,
    wrap_turns_delta,
)
from .device import resolve_device
from .fir import (
    design_hilbert_fir,
    offline_fir_spectrum,
    partition_fir_spectra,
    stream_fir_spectra,
)
from .sizes import (
    MAX_BLKSIZ,
    MIN_BLKSIZ,
    OfflineGeometry,
    StreamGeometry,
    default_blksiz,
    offline_geometry,
    stream_geometry_for_rate,
)

__all__ = [
    "MAXSAMPLE",
    "SUBSAMPLE",
    "MAX_BLKSIZ",
    "MIN_BLKSIZ",
    "OfflineGeometry",
    "StreamGeometry",
    "all_angle_cos_sin",
    "angle_units_from_degrees",
    "default_blksiz",
    "degrees_to_turns",
    "degrees_to_turns_np",
    "design_hilbert_fir",
    "offline_fir_spectrum",
    "offline_geometry",
    "partition_fir_spectra",
    "resolve_device",
    "sin_cos_turns",
    "sin_cos_units",
    "sincos_lut",
    "stream_fir_spectra",
    "stream_geometry_for_rate",
    "turns_to_radians",
    "wrap_angle_units",
    "wrap_turns_delta",
]
