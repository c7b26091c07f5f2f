"""The all-angle rotated-peak sweep and the peak scan: CUDA kernel
wrappers and plain twins.

Counterpart of ``phaserotate_tpu/kernels/rotate_peak.py``
``rotate_peak_sweep_kernel`` and ``peak_kernel``; the kernels are in
``csrc/rotate_peak.cu``.  On a CPU tensor each wrapper runs its plain
PyTorch version (:func:`rotate_peak_sweep_plain`, :func:`peak_plain`); on
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..ops.peak import rotated_peak_sweep as rotate_peak_sweep_plain
from . import _build

__all__ = ["peak_kernel", "peak_plain", "rotate_peak_sweep_kernel",
           "rotate_peak_sweep_plain"]

# The sweep kernel's thread map, mirrored by csrc/rotate_peak.cu kSweep*
# (edit both together).  Angles u and SWEEP_ANGLES - u of the canonical
# table form unit u (1 <= u < SWEEP_ANGLES / 2), angles 0 and
# SWEEP_ANGLES / 2 unit 0; group g of a block holds units
# SWEEP_UNITS * g .. SWEEP_UNITS * (g + 1) - 1, and its lane l walks the
# tile's samples i = l (mod SWEEP_LANES).
SWEEP_ANGLES = 360
SWEEP_GROUPS = 20
SWEEP_LANES = 8
SWEEP_UNITS = 9

# The general map (any other table, and any tile the pair units refuse),
# mirrored by csrc/rotate_peak.cu kGeneralSlots and its host choice of K:
# each thread holds K = general_slots(A) angles, slot j of group g in
# chunk c being angle c * SWEEP_GROUPS * K + g * K + j, chunks over the
# same staged tile until the table is covered.
GENERAL_SLOTS = 9


def general_slots(a_count: int) -> int:
    """K, the general map's angles per thread for an ``a_count``-angle
    table: every group full where ``a_count`` allows."""
    return min(-(-a_count // SWEEP_GROUPS), GENERAL_SLOTS)

_MAX_ANGLES = 512  # the kernel's limit on any table (kMaxAngles)
_MAX_TILE = 4096   # (b0, b1) tile in 32 KiB of shared memory


def _rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) -> (rows, n) with unit sample stride, a view if possible
    (rows by count: an empty signal, n = 0, still has its rows)."""
    t = t.reshape(t.shape[:-1].numel(), n)
    return t if t.stride(-1) == 1 else t.contiguous()


def rotate_peak_sweep_kernel(
    b0: torch.Tensor,
    b1: torch.Tensor,
    cos_sin: torch.Tensor,
    tile_len: int = 4096,
) -> torch.Tensor:
    """``peaks[..., a] = max_m |cos[a]*b0[..., m] + sin[a]*b1[..., m]|``.

    Args:
      b0, b1: (..., n) float32 aligned dry/Hilbert signals (strided views
        with a unit sample stride are read in place).
      cos_sin: (2, A) float32 stacked [cos; sin], A <= 512.
      tile_len: samples per block, a multiple of 4 up to 4096.

    Returns (..., A) float32, bit-equal to the plain version (NaN where
    it has NaN).  The canonical 360-angle table runs the kernel's
    mirror-pair units, any other table (and a tile with a NaN or an inf)
    its general map of :func:`general_slots` angles per thread; the
    kernel tells them apart on the device.
    """
    if b0.device.type == "cpu":
        return rotate_peak_sweep_plain(b0, b1, cos_sin)
    if b0.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {b0.device}")
    if b0.shape != b1.shape:
        raise ValueError(f"b0 {tuple(b0.shape)} != b1 {tuple(b1.shape)}")
    for t in (b0, b1, cos_sin):
        if t.dtype != torch.float32 or t.device != b0.device:
            raise TypeError("b0, b1 and cos_sin must be float32 on one device")
    a = cos_sin.shape[-1]
    if cos_sin.shape != (2, a) or not 0 < a <= _MAX_ANGLES:
        raise ValueError(f"cos_sin must be (2, A<={_MAX_ANGLES}), "
                         f"got {tuple(cos_sin.shape)}")
    if tile_len % 4 or not 0 < tile_len <= _MAX_TILE:
        raise ValueError(f"tile_len must be a multiple of 4 in "
                         f"(0, {_MAX_TILE}], got {tile_len}")
    lead = b0.shape[:-1]
    n = b0.shape[-1]
    r0, r1 = _rows(b0, n), _rows(b1, n)
    rows = r0.shape[0]
    cs = cos_sin.contiguous()
    out = torch.zeros((rows, a), dtype=torch.float32, device=b0.device)
    if rows == 0 or n == 0:
        return out.reshape(*lead, a)
    lib = _build.lib()
    with torch.cuda.device(b0.device):  # the C launch goes to the current one
        err = lib.prt_rotate_peak_sweep(
            r0.data_ptr(), r1.data_ptr(), r0.stride(0), r1.stride(0),
            cs.data_ptr(), out.data_ptr(), rows, n, a, tile_len,
            torch.cuda.current_stream(b0.device).cuda_stream)
    _build.check(err, "rotate_peak_sweep")
    _build.count_launch("rotate_peak_sweep")
    return out.reshape(*lead, a)


def peak_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`peak_kernel`: ``max|x|``, +0 for no samples."""
    return x.abs().max() if x.numel() else x.new_zeros(())


def peak_kernel(x: torch.Tensor) -> torch.Tensor:
    """``max(|x|)`` of a 1-D float32 signal as a 0-d tensor (the
    reference's dsp_compute_peak, cli/dsp_peak_calc.h:27).

    Bit-equal to ``x.abs().max()``; a NaN anywhere gives NaN.
    """
    if x.ndim != 1:
        raise ValueError(f"expected a 1-D signal, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return peak_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    x = x.contiguous()
    out = torch.zeros((), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out
    lib = _build.lib()
    with torch.cuda.device(x.device):  # the C launch goes to the current one
        err = lib.prt_peak(
            x.data_ptr(), x.numel(), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "peak")
    _build.count_launch("peak")
    return out
