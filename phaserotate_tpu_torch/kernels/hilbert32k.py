"""The offline Hilbert signal at blksiz 32768: CUDA kernel wrapper and
plain twin.

No counterpart in the JAX package, which convolves at this blksiz (176.4
and 192 kHz) with plain XLA: no kernel of either package frames a
32768-tap FIR (``stream_conv`` takes up to 64 partitions of 256,
``fused_conv`` up to parsiz 16384).  :func:`hilbert_32k` computes the
one-partition overlap-add of the offline FIR (``core.fir.
offline_fir_spectrum`` at ``OfflineGeometry(32768)``) at an FFT length of
65,536, as ``search.sweep.hilbert_offline`` returns it.  The kernel is
``csrc/hilbert32k.cu``: a cluster of two blocks shares each frame.  On a
CPU tensor the wrapper runs :func:`hilbert_32k_plain`, the plain
``ops.convolve.partitioned_convolve`` route; on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.fir import offline_fir_spectrum
from ..core.sizes import OfflineGeometry
from ..ops.convolve import partitioned_convolve
from . import _build
from .fused_conv import _product_tables, _stage_twiddles, _twiddles_np

__all__ = ["BLKSIZ", "hilbert_32k", "hilbert_32k_plain", "kernel_geometry",
           "out_len"]

BLKSIZ = 32768
_GEOM = OfflineGeometry(BLKSIZ)


def out_len(n: int) -> int:
    """Samples a row of the output: the row's ``ceil(n / 32768)`` blocks
    and one flush block."""
    return (-(-n // BLKSIZ) + 1) * BLKSIZ


def hilbert_32k_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`hilbert_32k` on ``torch.fft``."""
    spectra = offline_fir_spectrum(_GEOM, x.device)[None]  # (1, 32769)
    return partitioned_convolve(x, spectra, BLKSIZ)[..., :out_len(x.shape[-1])]


@functools.lru_cache(maxsize=4)
def kernel_geometry(device: torch.device | str = "cuda") -> dict:
    """The CUDA kernel's launch on ``device``: ``clusters`` of two blocks
    (as many as the card holds at once: the persistent grid), ``threads``
    per block, ``registers`` and ``local_bytes`` (spills) per thread, and
    ``shared_bytes`` per block."""
    info = (ctypes.c_int * 5)()
    with torch.cuda.device(torch.device(device)):
        _build.check(_build.lib().prt_hilbert32k_grid(info), "hilbert_32k")
    return dict(zip(("clusters", "threads", "registers", "local_bytes",
                     "shared_bytes"), info))


@functools.lru_cache(maxsize=4)
def _tables(device: torch.device):
    """The kernel's read-only tables on ``device``: the 16384-point
    transform's stage-major twiddles, W_M^p for p < M/2 (M = 32768), and
    the FIR spectrum and product twiddles in the product's order."""
    spec, wp = _product_tables(offline_fir_spectrum(_GEOM, device), BLKSIZ)
    w_split = torch.tensor(_twiddles_np(BLKSIZ // 2), device=device)
    return _stage_twiddles(BLKSIZ // 2, device), w_split, spec, wp


def hilbert_32k(x: torch.Tensor) -> torch.Tensor:
    """(..., n) float32 -> (..., (ceil(n / 32768) + 1) * 32768) float32:
    the linear convolution ``h[m] = (fir * x)[m]`` with the 32768-tap
    offline Hilbert FIR, through the last flush block.  Within float32
    roundoff of the plain version."""
    if x.device.type == "cpu":
        return hilbert_32k_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    lead, n = x.shape[:-1], x.shape[-1]
    n_out = out_len(n)
    if n == 0 or x.numel() == 0:  # nothing to convolve: the flush block
        return x.new_zeros((*lead, n_out))
    rows_x = x.reshape(-1, n)
    if rows_x.stride(-1) != 1:
        rows_x = rows_x.contiguous()
    rows = rows_x.shape[0]
    out = torch.empty((rows, n_out), dtype=torch.float32, device=x.device)
    dev = x.device
    frames = rows * (n_out // BLKSIZ)
    clusters = min(kernel_geometry(dev)["clusters"], frames)
    run_tails = torch.empty((clusters - 1, BLKSIZ), dtype=torch.float32,
                            device=dev)
    tws, w_split, spec, wp = _tables(dev)
    x_stride = rows_x.stride(0) if rows > 1 else n
    aligned = x_stride % 4 == 0 and rows_x.data_ptr() % 16 == 0
    lib = _build.lib()
    with torch.cuda.device(dev):  # the C launch goes to the current one
        err = lib.prt_hilbert32k(
            rows_x.data_ptr(), x_stride, n, int(aligned), tws.data_ptr(),
            w_split.data_ptr(), spec.data_ptr(), wp.data_ptr(),
            run_tails.data_ptr(), out.data_ptr(), rows, n_out // BLKSIZ,
            clusters, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "hilbert_32k")
    _build.count_launch("hilbert_32k")
    return out.reshape(*lead, n_out)
