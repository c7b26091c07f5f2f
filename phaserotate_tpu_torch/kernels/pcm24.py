"""24-bit PCM widening: CUDA kernel wrapper and plain twin.

No counterpart in the JAX package, which reads 24-bit files through its
float reader on the host.  The fleet ships a 24-bit WAV's data payload
as the file holds it (``io/pcm24.py``) and :func:`pcm24_widen` turns it
into float32 on the device; the kernel is ``csrc/pcm24.cu``.  On a CPU
tensor the wrapper runs :func:`pcm24_widen_plain`; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["pcm24_widen", "pcm24_widen_plain"]


def _check(raw: torch.Tensor) -> None:
    if raw.dtype != torch.uint8:
        raise TypeError(f"expected uint8 bytes, got {raw.dtype}")
    if raw.ndim != 4 or raw.shape[3] != 3:
        raise ValueError("expected (rows, frames, channels, 3) bytes, got "
                         f"{tuple(raw.shape)}")


def pcm24_widen_plain(raw: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`pcm24_widen`."""
    _check(raw)
    b = raw.to(torch.int32)
    v = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
    v = v - ((v >> 23) << 24)  # sign-extend bit 23
    x = v.to(torch.float32) * (1.0 / 8388608.0)
    return x.transpose(1, 2).contiguous()


def pcm24_widen(raw: torch.Tensor) -> torch.Tensor:
    """(rows, n, channels, 3) uint8 -> (rows, channels, n) float32.

    Each row holds ``n`` frames of ``channels`` interleaved little-endian
    3-byte samples, as a 24-bit PCM WAV's data chunk does; the result is
    each sample sign-extended over 2^23, exact (a 24-bit integer over a
    power of two is a float32), deinterleaved by channel.  Bit-equal to
    the plain version.
    """
    if raw.device.type == "cpu":
        return pcm24_widen_plain(raw)
    if raw.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {raw.device}")
    _check(raw)
    raw = raw.contiguous()
    rows, n, channels, _ = raw.shape
    out = torch.empty((rows, channels, n), dtype=torch.float32,
                      device=raw.device)
    if out.numel() == 0:
        return out
    lib = _build.lib()
    with torch.cuda.device(raw.device):  # the C launch goes to the current one
        err = lib.prt_pcm24_widen(
            raw.data_ptr(), out.data_ptr(), rows, channels, n,
            torch.cuda.current_stream(raw.device).cuda_stream)
    _build.check(err, "pcm24_widen")
    _build.count_launch("pcm24_widen")
    return out
