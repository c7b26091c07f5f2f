"""Hand-written Hopper kernels (``csrc/``) and their plain PyTorch twins."""

from ._build import launches, reset_launches
from .rotate_peak import rotate_peak_sweep_kernel, rotate_peak_sweep_plain
from .stream_conv import (
    hilbert_small,
    hilbert_small_plain,
    rotate_small,
    rotate_small_plain,
)

__all__ = [
    "hilbert_small",
    "hilbert_small_plain",
    "launches",
    "reset_launches",
    "rotate_peak_sweep_kernel",
    "rotate_peak_sweep_plain",
    "rotate_small",
    "rotate_small_plain",
]
