"""Batched fast convolution on ``torch.fft`` (the plain versions).

Torch twins of ``phaserotate_tpu/ops/convolve.py``; both realize the
reference's uniformly-partitioned overlap-add engine
(src/phaserotate.c:615-662) and agree to float32 roundoff:

* :func:`fft_convolve` — one large real FFT over the whole signal.
* :func:`partitioned_convolve` — frames of ``parsiz`` samples, batched
  small FFTs over all frames at once, the per-partition complex products
  accumulated with a shift-and-add over the frame axis, inverse FFTs and
  overlap-add.

These run on the CPU and serve as the references the CUDA convolution
kernel (kernels/stream_conv.py) is held to.
"""

from __future__ import annotations

import torch

__all__ = ["fft_convolve", "partitioned_convolve", "next_pow2"]


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def fft_convolve(x: torch.Tensor, fir: torch.Tensor) -> torch.Tensor:
    """Linear convolution of ``x`` (..., n) with ``fir`` (taps,) via one FFT.

    Returns shape (..., n + taps - 1), float32.
    """
    n = x.shape[-1]
    taps = fir.shape[-1]
    out_len = n + taps - 1
    fftlen = next_pow2(out_len)
    X = torch.fft.rfft(x, n=fftlen, dim=-1)
    F = torch.fft.rfft(fir, n=fftlen)
    y = torch.fft.irfft(X * F, n=fftlen, dim=-1)
    return y[..., :out_len].to(x.dtype)


def _frame(x: torch.Tensor, parsiz: int, extra: int) -> torch.Tensor:
    """Split (..., n) into (..., ceil(n/parsiz) + extra, parsiz), zero
    padding the tail and appending ``extra`` zero frames."""
    n = x.shape[-1]
    n_frames = -(-n // parsiz) + extra
    xp = torch.nn.functional.pad(x, (0, n_frames * parsiz - n))
    return xp.reshape(*x.shape[:-1], n_frames, parsiz)


def partitioned_convolve(
    x: torch.Tensor,
    fir_spectra: torch.Tensor,
    parsiz: int,
) -> torch.Tensor:
    """Uniformly-partitioned OLA convolution.

    Args:
      x: (..., n) float32 signal.
      fir_spectra: (n_segm, parsiz+1) complex64 partitioned FIR spectra
        from :func:`phaserotate_tpu_torch.core.fir.partition_fir_spectra`.
      parsiz: partition size (FFT length is 2*parsiz).

    Returns (..., (ceil(n/parsiz) + n_segm)*parsiz + parsiz): the full
    linear convolution of ``x`` with the ``n_segm*parsiz``-tap FIR, zero
    padded to whole frames (callers slice to the alignment they need).
    """
    n_segm = fir_spectra.shape[0]
    fftlen = 2 * parsiz
    # flush frames so delayed partitions drain: full linear convolution
    frames = _frame(x, parsiz, n_segm)  # (..., B, parsiz)
    n_frames = frames.shape[-2]

    X = torch.fft.rfft(frames, n=fftlen, dim=-1)  # (..., B, parsiz+1)

    # freq_sum[b] = sum_s X[b-s] * F[s]  (src/phaserotate.c:640-655)
    freq_sum = X * fir_spectra[0]
    for s in range(1, n_segm):
        freq_sum[..., s:, :] += X[..., : n_frames - s, :] * fir_spectra[s]

    y = torch.fft.irfft(freq_sum, n=fftlen, dim=-1)  # (..., B, fftlen)

    # Overlap-add: out[b*parsiz + i] = y[b, i] + y[b-1, parsiz + i]
    # (src/phaserotate.c:633, 660-662).
    lead = y.shape[:-2]
    out = y.new_zeros(*lead, (n_frames + 1) * parsiz)
    out[..., : n_frames * parsiz] = y[..., :parsiz].reshape(
        *lead, n_frames * parsiz)
    out[..., parsiz:] += y[..., parsiz:].reshape(*lead, n_frames * parsiz)
    return out.to(x.dtype)
