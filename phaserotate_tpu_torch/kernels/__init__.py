"""Hand-written Hopper kernels (``csrc/``) and their plain PyTorch twins."""

from ._build import launches, reset_launches
from .fused_conv import (
    fused_hilbert,
    fused_ola_conv,
    fused_ola_conv_plain,
    fused_rotate_fir,
    fused_rotate_fir_plain,
)
from .hilbert32k import hilbert_32k, hilbert_32k_plain
from .pcm24 import pcm24_widen, pcm24_widen_plain
from .rotate_peak import (
    peak_kernel,
    peak_plain,
    rotate_peak_sweep_kernel,
    rotate_peak_sweep_plain,
)
from .stream_conv import (
    fused_stream_mix,
    fused_stream_mix_plain,
    hilbert_small,
    hilbert_small_plain,
    rotate_small,
    rotate_small_plain,
)
from .unpack import wire_unpack, wire_unpack_plain

__all__ = [
    "fused_hilbert",
    "fused_ola_conv",
    "fused_ola_conv_plain",
    "fused_rotate_fir",
    "fused_rotate_fir_plain",
    "fused_stream_mix",
    "fused_stream_mix_plain",
    "hilbert_32k",
    "hilbert_32k_plain",
    "hilbert_small",
    "hilbert_small_plain",
    "launches",
    "peak_kernel",
    "peak_plain",
    "pcm24_widen",
    "pcm24_widen_plain",
    "reset_launches",
    "rotate_peak_sweep_kernel",
    "rotate_peak_sweep_plain",
    "rotate_small",
    "rotate_small_plain",
    "wire_unpack",
    "wire_unpack_plain",
]
