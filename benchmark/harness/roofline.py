"""The card's peaks and the operations and bytes each kernel's function
needs, counted from a call's shapes, so that a roofline share reads the
same work whatever kernel computes it.

Peaks: NVIDIA's data sheet for one H100 SXM (3.35 TB/s of HBM, 67
TFLOP/s of FP32 outside the tensor cores), at its full 700 W limit."""

from __future__ import annotations

import math

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound_ms(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the FP32 rate."""
    return max(1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOPS_PER_S)


def fft_flops(m: int) -> float:
    """5 M log2 M, an M-point complex FFT."""
    return 5.0 * m * math.log2(m)


def one_partition_parsiz(firlen: int) -> int:
    """The overlap-add partition that holds a ``firlen``-tap FIR: the next
    power of two from 2048."""
    p = 2048
    while p < firlen:
        p <<= 1
    return p


def one_partition_flops(n_frames: int, parsiz: int, mix_ops: int) -> float:
    """A one-partition FFT overlap-add per frame: two parsiz-point complex
    FFTs, the untangling and packing (32 operations per pair of bins
    each), the spectrum product (6 per bin) and the overlap-add (1 per
    sample) with ``mix_ops`` more per sample."""
    return n_frames * (2 * fft_flops(parsiz) + 2 * 32 * (parsiz // 2)
                       + 6 * parsiz + (1 + mix_ops) * parsiz)


def fir_conv_flops(rows: int, n: int, firlen: int, mix_ops: int) -> float:
    """The operations a convolution of ``rows`` signals of ``n`` samples
    with a ``firlen``-tap FIR needs, whichever kernel computes it: the
    one-partition overlap-add over the ``n + firlen/2`` input samples of
    a time-aligned output."""
    parsiz = one_partition_parsiz(firlen)
    n_frames = rows * -(-(n + firlen // 2) // parsiz)
    return one_partition_flops(n_frames, parsiz, mix_ops)


def conv_bound_ms(rows: int, n: int, n_out: int, firlen: int,
                  mix_ops: int = 0) -> float:
    """A float32 convolution's bound: its input and output moved once."""
    return bound_ms(4.0 * rows * (n + n_out),
                    fir_conv_flops(rows, n, firlen, mix_ops))


def sweep_flops_per_sample(cos_sin: np.ndarray) -> int:
    """Operations per sample of the peak sweep on the (2, A) table: two
    angles whose cos bits differ only in the sign and whose sin bits are
    equal share their products (|p + q| and |q - p|), 6 operations for
    the pair; every other angle takes 4 (two products, a sum and a
    running max).  The CLI's 360-angle table: 179 x 6 + 8 = 1082."""
    c, s = np.ascontiguousarray(cos_sin, np.float32).view(np.uint32).tolist()
    waiting: dict = {}
    pairs = 0
    for key in zip(c, s):
        mirror = (key[0] ^ 0x80000000, key[1])
        if waiting.get(mirror):
            waiting[mirror] -= 1
            pairs += 1
        else:
            waiting[key] = waiting.get(key, 0) + 1
    return 6 * pairs + 4 * (len(c) - 2 * pairs)


def sweep_bound_ms(rows: int, n: int, angles: int,
                   flops_per_sample: int) -> float:
    """The sweep over (rows, n) dry and Hilbert signals with a table of
    ``angles``: both signals, the table and the (rows, angles) peaks moved
    once, and ``flops_per_sample`` operations for every sample."""
    return bound_ms(4.0 * (2 * rows * n + 2 * angles + rows * angles),
                    flops_per_sample * rows * n)
