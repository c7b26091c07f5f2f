"""Single-partition OLA convolution: CUDA kernel wrappers and plain twins.

Counterpart of ``phaserotate_tpu/kernels/fused_conv.py``; the kernel is
``csrc/fused_conv.cu``.  Per ``parsiz``-sample block it computes

    h = OLA( irfft( rfft(pad(block, 2*parsiz)) * H ) )

with the Hilbert FIR zero-padded to one ``parsiz``-tap partition, in
conv-only mode (:func:`fused_ola_conv`, :func:`fused_hilbert`) and with the
rotation mix fused in (:func:`fused_rotate_fir`).  The FIR arrives as a
plain complex64 half spectrum (:func:`hilbert_fir_spectrum`): the TPU
kernel's ``[k1][k2]`` matrix layout has no counterpart here; the wrapper
hands the CUDA kernel that spectrum, and the twiddles of its spectrum
product, permuted into the order in which the kernel walks them
(:func:`_product_tables`).  It also hands it the pass twiddles
stage-major (:func:`_stage_twiddles_np`), and sizes its persistent grid
from the card (:func:`kernel_geometry`).  The support tables are the JAX
package's, so dispatch is the same.

On a CPU tensor each wrapper runs its plain twin (``torch.fft``); on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.angles import sin_cos_turns
from ..core.fir import _design_hilbert_fir_np
from . import _build

__all__ = [
    "fused_hilbert",
    "fused_ola_conv",
    "fused_ola_conv_plain",
    "fused_parsiz_for",
    "fused_rotate_fir",
    "fused_rotate_fir_plain",
    "hilbert_fir_spectrum",
    "kernel_geometry",
    "mix_supported",
    "supported_parsiz",
]

# the TPU kernel's lane factor: its 4-step split of every supported
# fftlen (2*parsiz, 4096..32768) puts 64 samples in a row
# (fused_conv.py _split); mix_supported's row rule is stated in it
_N2 = 64


def supported_parsiz(parsiz: int) -> bool:
    """Power-of-two partition sizes in [2048, 16384] (the JAX kernel's
    range; the CUDA kernel holds one 2*parsiz-point frame, 128 KiB at
    16384, in shared memory)."""
    return (2048 <= parsiz <= 16384
            and (parsiz & (parsiz - 1)) == 0)


def fused_parsiz_for(firlen: int) -> int:
    """Single-partition size hosting a ``firlen``-tap FIR: the FIR is
    zero-padded up to the next power of two from 2048 (3072 -> 4096; the
    padded taps are zeros, so the convolution is unchanged)."""
    p = 2048
    while p < firlen:
        p <<= 1
    return p


def mix_supported(firlen: int, parsiz: int | None = None) -> bool:
    """True where the JAX package fuses the rotation mix into the
    kernel: a supported partition size and a FIR group delay of a whole
    number of 8-row groups of 64 samples, shorter than the partition."""
    if parsiz is None:
        parsiz = fused_parsiz_for(firlen)
    if not supported_parsiz(parsiz) or firlen > parsiz:
        return False
    rows = (firlen // 2) // _N2
    return (firlen // 2) % _N2 == 0 and rows % 8 == 0 and rows < parsiz // _N2


@functools.lru_cache(maxsize=16)
def _hilbert_fir_spectrum_np(firlen: int, parsiz: int) -> np.ndarray:
    fir = np.pad(_design_hilbert_fir_np(firlen), (0, parsiz - firlen))
    return np.fft.rfft(np.pad(fir, (0, parsiz))).astype(np.complex64)


def hilbert_fir_spectrum(firlen: int, parsiz: int,
                         device=None) -> torch.Tensor:
    """(parsiz+1,) complex64: rfft of the ``firlen``-tap Hilbert FIR
    zero-padded to ``parsiz`` taps, then to ``2*parsiz`` points."""
    if firlen > parsiz:
        raise ValueError(f"firlen {firlen} exceeds parsiz {parsiz}")
    return torch.tensor(_hilbert_fir_spectrum_np(firlen, parsiz),
                        device=device)


@functools.lru_cache(maxsize=4)
def _twiddles_np(parsiz: int) -> np.ndarray:
    """(parsiz, 2) float32 e^{-2*pi*j*i/(2*parsiz)}, i < parsiz, computed
    in float64."""
    ang = -np.pi * np.arange(parsiz, dtype=np.float64) / parsiz
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _stage_twiddles_np(parsiz: int) -> np.ndarray:
    """((parsiz-1)//3, 4) float32: the kernel's pass twiddles, stage-major.
    For each radix-4 pass of span h, in the forward transform's pass order
    (h = parsiz/2, parsiz/8, ...), the rows ``{W_2h^j, W_h^j}`` for
    j < h/2, from row ``(parsiz - 2h)/3``; W_2h^j = W_N^(j*M/h) and
    W_h^j = W_N^(2j*M/h), N = 2M, M = parsiz, are copied from
    :func:`_twiddles_np`, not recomputed."""
    tw = _twiddles_np(parsiz)
    log2m = parsiz.bit_length() - 1
    parts = []
    for log2h in range(log2m - 1, 0, -2):
        j = np.arange(1 << (log2h - 1))
        shift = log2m - log2h
        parts.append(np.concatenate([tw[j << shift], tw[(2 * j) << shift]],
                                    axis=1))
    return np.concatenate(parts)


@functools.lru_cache(maxsize=8)
def _stage_twiddles(parsiz: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(_stage_twiddles_np(parsiz), device=device)


@functools.lru_cache(maxsize=16)
def kernel_geometry(parsiz: int, mix: bool = False,
                    device: torch.device | str = "cuda") -> dict:
    """The CUDA kernel's launch on ``device`` for ``parsiz`` in conv or mix
    mode: ``blocks`` (as many as the card holds at once: the persistent
    grid), ``threads`` per block, ``registers`` per thread and
    ``local_bytes`` per thread (spilled registers)."""
    import ctypes

    if not supported_parsiz(parsiz):
        raise ValueError(f"unsupported parsiz {parsiz}")
    info = (ctypes.c_int * 4)()
    with torch.cuda.device(torch.device(device)):
        _build.check(_build.lib().prt_fused_conv_grid(parsiz, int(mix), info),
                     "fused_conv")
    return dict(zip(("blocks", "threads", "registers", "local_bytes"), info))


def _bitrev(i: np.ndarray, bits: int) -> np.ndarray:
    out = np.zeros_like(i)
    for b in range(bits):
        out |= ((i >> b) & 1) << (bits - 1 - b)
    return out


@functools.lru_cache(maxsize=4)
def _product_order(
        parsiz: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's walk of the spectrum product, item u in [0, parsiz/2]:
    the bit-reversed positions ``pk`` of X[k] and ``pmk`` of X[M - k],
    M = parsiz, and ``k = bitrev(pk)`` <= M/2.  u = 0 is k = 0, u = M/2 is
    k = M/2; otherwise the pair sits at ``u + hb`` and
    ``(u + hb) ^ (2*hb - 1)``, hb the highest set bit of u, and k at the
    even one of the two (csrc/fused_conv.cu ``spectrum_product``)."""
    half = parsiz // 2
    u = np.arange(half + 1, dtype=np.int64)
    hb = np.left_shift(1, np.frexp(np.maximum(u, 1))[1] - 1)
    flip = 2 * hb - 1
    pk = u + hb
    pk ^= (pk & 1) * flip
    pmk = pk ^ flip
    pk[0] = pmk[0] = 0
    pk[half] = pmk[half] = 1
    return pk, pmk, _bitrev(pk, parsiz.bit_length() - 1)


@functools.lru_cache(maxsize=8)
def _position_tables(parsiz: int, device: torch.device):
    """The gather index of the FIR spectrum in bit-reversed position order
    (``idx[p] = bitrev(p)``, p < M, and ``idx[M] = M``), and the product's
    twiddles W_N^k in item order, (parsiz/2 + 1, 2) float32."""
    pos = np.arange(parsiz + 1, dtype=np.int64)
    idx = np.append(_bitrev(pos[:-1], parsiz.bit_length() - 1), parsiz)
    wp = _twiddles_np(parsiz)[_product_order(parsiz)[2]]
    return torch.tensor(idx, device=device), torch.tensor(wp, device=device)


def _product_tables(spectrum: torch.Tensor,
                    parsiz: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The two tables the kernel's spectrum product reads, on the
    spectrum's device: (parsiz+1, 2) float32 H in bit-reversed position
    order (``H[M]`` last) and (parsiz/2 + 1, 2) float32 W_N^k in the
    order of :func:`_product_order`.  Values are copied, not recomputed."""
    idx, wp = _position_tables(parsiz, spectrum.device)
    spec = torch.view_as_real(spectrum.to(torch.complex64).resolve_conj())
    return spec[idx], wp


def _check_frames(frames: torch.Tensor, spectrum: torch.Tensor,
                  parsiz: int) -> None:
    if not supported_parsiz(parsiz):
        raise ValueError(f"unsupported parsiz {parsiz}")
    if frames.ndim != 3 or frames.shape[-1] != parsiz:
        raise ValueError(f"frames must be (B, n_blocks, {parsiz}), got "
                         f"{tuple(frames.shape)}")
    if spectrum.shape != (parsiz + 1,):
        raise ValueError(f"spectrum must be ({parsiz + 1},), got "
                         f"{tuple(spectrum.shape)}")


def _launch(frames: torch.Tensor, spectrum: torch.Tensor, parsiz: int,
            cs: torch.Tensor | None, lat: int) -> torch.Tensor:
    """Run csrc/fused_conv.cu on (B, n_blocks, parsiz) frames; with ``cs``
    (B, 2) the output is mixed against the input delayed by ``lat``."""
    dev = frames.device
    if frames.dtype != torch.float32 or spectrum.device != dev:
        raise TypeError("frames must be float32 on the spectrum's device")
    b, n_blocks, _ = frames.shape
    frames = frames.contiguous()
    spec, wp = _product_tables(spectrum, parsiz)
    # one block per run of frames; each but the last leaves one tail
    grid = min(kernel_geometry(parsiz, cs is not None, dev)["blocks"],
               b * n_blocks)
    run_tails = torch.empty((grid - 1, parsiz), dtype=torch.float32,
                            device=dev)
    out = torch.empty((b, n_blocks * parsiz), dtype=torch.float32,
                      device=dev)
    lib = _build.lib()
    with torch.cuda.device(dev):  # the C launch goes to the current one
        err = lib.prt_fused_conv(
            frames.data_ptr(), spec.data_ptr(),
            _stage_twiddles(parsiz, dev).data_ptr(), wp.data_ptr(),
            None if cs is None else cs.data_ptr(), run_tails.data_ptr(),
            out.data_ptr(), b, n_blocks, parsiz, lat, grid,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_conv")
    return out


def fused_ola_conv_plain(frames: torch.Tensor, spectrum: torch.Tensor,
                         parsiz: int) -> torch.Tensor:
    """Plain twin of :func:`fused_ola_conv` on ``torch.fft``."""
    b, n_blocks, _ = frames.shape
    y = torch.fft.irfft(torch.fft.rfft(frames, n=2 * parsiz) * spectrum,
                        n=2 * parsiz)
    h = y[..., :parsiz].clone()
    h[:, 1:] += y[:, :-1, parsiz:]
    return h.reshape(b, n_blocks * parsiz)


def fused_ola_conv(frames: torch.Tensor, spectrum: torch.Tensor,
                   parsiz: int) -> torch.Tensor:
    """Single-partition OLA convolution of framed signals.

    Args:
      frames: (B, n_blocks, parsiz) float32 consecutive input blocks
        (each implicitly zero-padded to 2*parsiz).
      spectrum: (parsiz+1,) complex64 FIR half spectrum
        (:func:`hilbert_fir_spectrum`).
      parsiz: partition size, :func:`supported_parsiz`.

    Returns (B, n_blocks*parsiz) float32: the linear convolution stream
    ``h[m] = (fir * x)[m]`` for m < n_blocks*parsiz (run one extra zero
    block through for the tail).
    """
    _check_frames(frames, spectrum, parsiz)
    if frames.device.type == "cpu":
        return fused_ola_conv_plain(frames, spectrum, parsiz)
    if frames.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {frames.device}")
    out = _launch(frames, spectrum, parsiz, None, 0)
    _build.count_launch("fused_hilbert")
    return out


def _framed(x: torch.Tensor, n_frames: int, parsiz: int) -> torch.Tensor:
    """(..., n) -> (rows, n_frames, parsiz), zero padded."""
    n = x.shape[-1]
    xp = torch.nn.functional.pad(x.reshape(-1, n),
                                 (0, n_frames * parsiz - n))
    return xp.reshape(-1, n_frames, parsiz)


def fused_hilbert(x: torch.Tensor, firlen: int,
                  parsiz: int | None = None) -> torch.Tensor:
    """Full linear convolution of ``x`` (..., n) with the ``firlen``-tap
    Hilbert FIR through one partition of ``parsiz`` taps.

    Returns (..., n_frames*parsiz) with ``n_frames = ceil(n/parsiz) + 1``:
    the head of the convolution stream, covering every index of
    ``fir * x`` up to at least ``n + parsiz`` (the extra flush frame
    drains the OLA tail).
    """
    if parsiz is None:
        parsiz = fused_parsiz_for(firlen)
    if not supported_parsiz(parsiz) or firlen > parsiz:
        raise ValueError(f"unsupported (firlen={firlen}, parsiz={parsiz})")
    lead, n = x.shape[:-1], x.shape[-1]
    n_frames = -(-n // parsiz) + 1
    h = fused_ola_conv(_framed(x, n_frames, parsiz),
                       hilbert_fir_spectrum(firlen, parsiz, x.device), parsiz)
    return h.reshape(*lead, n_frames * parsiz)


def _rotate_operands(x: torch.Tensor, turns, firlen: int):
    parsiz = fused_parsiz_for(firlen)
    if not mix_supported(firlen, parsiz):
        raise ValueError(f"mix not supported for firlen {firlen}")
    lead, n = x.shape[:-1], x.shape[-1]
    lat = firlen // 2
    n_frames = -(-(n + lat) // parsiz)  # stream must cover n + lat
    t = torch.as_tensor(turns, dtype=torch.float32, device=x.device)
    sa, ca = sin_cos_turns(t.broadcast_to(lead).reshape(-1))
    return (_framed(x, n_frames, parsiz), torch.stack([ca, sa], dim=-1),
            hilbert_fir_spectrum(firlen, parsiz, x.device), parsiz, lat)


def fused_rotate_fir_plain(x: torch.Tensor, turns, firlen: int):
    """Plain twin of :func:`fused_rotate_fir`: the single-partition OLA
    on ``torch.fft``, then ``ca*x + sa*h`` rounded like the kernel."""
    frames, cs, spec, parsiz, lat = _rotate_operands(x, turns, firlen)
    n = x.shape[-1]
    h = fused_ola_conv_plain(frames, spec, parsiz)[:, lat : lat + n]
    xr = frames.reshape(frames.shape[0], -1)[:, :n]
    out = cs[:, :1] * xr + cs[:, 1:] * h
    return out.reshape(x.shape)


def fused_rotate_fir(x: torch.Tensor, turns, firlen: int) -> torch.Tensor:
    """Complete FIR phase rotation in one kernel pass:

        out[m] = cos(2*pi*turns)*x[m] + sin(2*pi*turns)*(fir*x)[m + lat]

    with ``lat = firlen/2`` (group delay compensated, time-aligned).

    Args:
      x: (..., n) float32.
      turns: negated-turns angle, broadcastable to ``x.shape[:-1]``.
    """
    if x.device.type == "cpu":
        return fused_rotate_fir_plain(x, turns, firlen)
    if x.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {x.device}")
    frames, cs, spec, parsiz, lat = _rotate_operands(x, turns, firlen)
    n = x.shape[-1]
    out = _launch(frames, spec, parsiz, cs.contiguous(), lat)
    _build.count_launch("fused_rotate_fir")
    return out[:, lat : lat + n].reshape(x.shape)
