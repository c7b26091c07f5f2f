"""Small-geometry Hilbert convolution: CUDA kernel wrappers, plain twins.

Counterpart of ``phaserotate_tpu/kernels/stream_conv.py``; the kernel is
``csrc/stream_conv.cu``.  Internal framing is fixed at P = 256 samples: the
partitioned convolution of one FIR is framing-invariant (it is the linear
convolution ``(fir * x)[m]``), so every FIR of 512..16384 taps in steps of
256 maps onto one kernel shape with ``n_segm = fir_taps / 256`` partitions.

* :func:`hilbert_small` — conv-only mode, the Hilbert half of the
  analyzer's sweep and apply (``fused_hilbert_small``, also exported
  under that name).
* :func:`rotate_small` — steady-angle mix mode, the FIR rotate
  (``fused_rotate_small``, also exported under that name).
* :func:`fused_stream_mix` — mix mode with the per-sample angle ramp from
  per-frame (angle, slope) pairs, the streaming engine's whole block body
  (``fused_stream_mix``).

On a CPU tensor each wrapper runs its plain twin; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.angles import _TWO_PI
from ..core.fir import _partition_fir_spectra_np, partition_fir_spectra
from ..ops.convolve import partitioned_convolve
from . import _build
from .fused_conv import _bitrev

__all__ = [
    "P",
    "fused_stream_mix",
    "fused_hilbert_small",
    "fused_rotate_small",
    "fused_stream_mix_plain",
    "small_conv_supported",
    "stream_mix_supported",
    "hilbert_small",
    "hilbert_small_plain",
    "kernel_geometry",
    "rotate_small",
    "rotate_small_plain",
]

P = 256          # internal frame (samples consumed/produced per step)
FFTK = 2 * P     # zero-padded transform length
_BINS = P + 2    # the kernel's spectrum row: P positions, Nyquist, a pad


def small_conv_supported(fir_taps: int) -> bool:
    """FIR supports P-divisible tap counts with 2..64 partitions — covers
    every plugin FIR (3072/4096/8192, src/phaserotate.c:278-290) and the
    offline MIN_BLKSIZ FIR (1024 taps, cli/phase-rotate.cc:128-141)."""
    return fir_taps % P == 0 and 2 <= fir_taps // P <= 64


def stream_mix_supported(firlen: int) -> bool:
    """The fused rotation mix additionally needs the FIR group delay to
    be a whole number of internal frames (true for all plugin FIRs)."""
    return small_conv_supported(firlen) and (firlen // 2) % P == 0


@functools.lru_cache(maxsize=8)
def _twiddles(device: torch.device) -> torch.Tensor:
    """(FFTK, 2) float32 [cos, sin](2*pi*j/FFTK), computed in float64: the
    twiddles of the kernel's FFTs (W_FFTK^j is the conjugate of entry j)
    and the values of the JAX kernel's DFT matrices (stream_conv.py
    _dft_consts)."""
    ang = 2.0 * np.pi * np.arange(FFTK, dtype=np.float64) / FFTK
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return torch.tensor(tw, device=device)


def _row_order() -> np.ndarray:
    """The bin held by each entry of the kernel's spectrum rows: entry
    p < P holds bin bitrev(p) (the bit-reversed order in which the forward
    FFT leaves its output), entry P the Nyquist bin P; entry P+1 is an
    unused zero pad."""
    return np.append(_bitrev(np.arange(P), P.bit_length() - 1), P)


@functools.lru_cache(maxsize=16)
def _fir_parts(fir_taps: int, device: torch.device) -> torch.Tensor:
    """(n_segm + 2, _BINS, 2) float32 partition spectra of the FIR at P
    (the reference's per-segment r2c transforms, src/phaserotate.c:396-401),
    each row in the kernel's position order (:func:`_row_order`), and two
    zero rows that the kernel's look-ahead loads may read past the last."""
    spec = _partition_fir_spectra_np(fir_taps, P)[:, _row_order()]
    out = np.zeros((spec.shape[0] + 2, _BINS, 2), np.float32)
    out[: spec.shape[0], : P + 1, 0] = spec.real
    out[: spec.shape[0], : P + 1, 1] = spec.imag
    return torch.tensor(out, device=device)


def _require_cuda_f32(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")


@functools.lru_cache(maxsize=32)
def kernel_geometry(ns: int, mix: bool = False,
                    device: torch.device | None = None) -> dict:
    """The kernel's launch geometry on ``device`` (the current CUDA device
    by default) for ``ns`` partitions: ``blocks`` resident on the whole
    card at once (the persistent grid), ``threads`` per block,
    ``registers`` per thread, ``local_bytes`` per thread (spills) and
    ``smem_bytes`` of dynamic shared memory per block."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    return _geometry(_build.lib(), ns, mix, dev)


def _geometry(lib, ns: int, mix: bool, dev: torch.device) -> dict:
    info = (ctypes.c_int * 5)()
    with torch.cuda.device(dev):
        _build.check(lib.prt_stream_conv_grid(ns, int(mix), info),
                     "stream_conv geometry")
    return dict(zip(("blocks", "threads", "registers", "local_bytes",
                     "smem_bytes"), info))


def _launch(x: torch.Tensor, fir_taps: int, n_out: int, out: torch.Tensor,
            out_len: int, d_out: int = 0, angs: torch.Tensor | None = None,
            ang_fs: int = 0, grid: int | None = None, lib=None) -> bool:
    """Run csrc/stream_conv.cu on the rows of ``x`` (rows, n), read in
    place at its row stride, into ``out`` (rows, >= out_len) at its row
    stride: ``n_out`` output frames per row, output frame o the stream's
    frame o + ``d_out``, samples below ``out_len`` written.  With ``angs``
    (rows, ..., 2) (angle, slope) pairs, its frame stride ``ang_fs``, the
    output is mixed against the input delayed by fir_taps/2.  ``grid``
    blocks (default: the blocks resident on the card) each take one run
    of the rows' frames; any grid gives the same output.  ``lib``: the
    loaded library to launch from (the port's own by default; another
    build of the source, to compare).  Returns whether it launched (not
    for zero frames)."""
    rows, n = x.shape
    dev = x.device
    ns = fir_taps // P
    fir = _fir_parts(fir_taps, dev)
    total = rows * n_out
    if total == 0:
        return False
    mix = angs is not None
    if grid is None:
        geometry = (kernel_geometry(ns, mix, dev) if lib is None
                    else _geometry(lib, ns, mix, dev))
        grid = min(geometry["blocks"], total)
    lib = _build.lib() if lib is None else lib
    with torch.cuda.device(dev):  # the C launch goes to the current one
        err = lib.prt_stream_conv(
            x.data_ptr(), x.stride(0), n, fir.data_ptr(),
            _twiddles(dev).data_ptr(),
            None if angs is None else angs.data_ptr(),
            0 if angs is None else angs.stride(0) // 2, ang_fs,
            out.data_ptr(), out.stride(0), out_len, rows, n_out, ns, d_out,
            (fir_taps // 2) // P if mix else 0, grid,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "stream_conv")
    return True


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(..., n) -> (rows, n), a view where the strides allow one, with
    unit sample stride (rows by count: an empty signal, n = 0, still has
    its rows)."""
    x2 = x.reshape(x.shape[:-1].numel(), x.shape[-1])
    return x2 if x2.shape[-1] <= 1 or x2.stride(-1) == 1 else x2.contiguous()


def hilbert_small_plain(x: torch.Tensor, fir_taps: int) -> torch.Tensor:
    """Plain twin of :func:`hilbert_small` on ``torch.fft``."""
    n_frames = -(-x.shape[-1] // P) + fir_taps // P
    spectra = partition_fir_spectra(fir_taps, P, x.device)
    return partitioned_convolve(x, spectra, P)[..., : n_frames * P]


def hilbert_small(x: torch.Tensor, fir_taps: int) -> torch.Tensor:
    """Linear convolution stream ``h[m] = (fir * x)[m]`` of ``x`` (..., n)
    with the ``fir_taps``-tap Hilbert FIR.

    Returns (..., n_frames*P) with ``n_frames = ceil(n/P) + fir_taps/P``
    — the full convolution support.
    """
    if not small_conv_supported(fir_taps):
        raise ValueError(f"unsupported fir_taps {fir_taps}")
    if x.device.type == "cpu":
        return hilbert_small_plain(x, fir_taps)
    _require_cuda_f32(x)
    out = _hilbert_small_kernel(_rows(x), fir_taps)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def _hilbert_small_kernel(x2: torch.Tensor, fir_taps: int) -> torch.Tensor:
    """:func:`hilbert_small`'s launch on (rows, n): (rows, n_frames*P)."""
    n_frames = -(-x2.shape[-1] // P) + fir_taps // P
    out = torch.empty((x2.shape[0], n_frames * P), dtype=torch.float32,
                      device=x2.device)
    if _launch(x2, fir_taps, n_frames, out, n_frames * P):
        _build.count_launch("hilbert_small")
    return out


def rotate_small_plain(x: torch.Tensor, turns: torch.Tensor,
                       firlen: int) -> torch.Tensor:
    """Plain twin of :func:`rotate_small` on ``torch.fft``."""
    lat = firlen // 2
    n = x.shape[-1]
    spectra = partition_fir_spectra(firlen, P, x.device)
    h = partitioned_convolve(x, spectra, P)[..., lat : lat + n]
    rad = torch.as_tensor(turns, dtype=torch.float32, device=x.device)
    rad = (rad * float(_TWO_PI))[..., None]
    return torch.cos(rad) * x + torch.sin(rad) * h


def rotate_small(x: torch.Tensor, turns, firlen: int) -> torch.Tensor:
    """Steady-angle FIR rotation:

        out[m] = cos(2*pi*turns)*x[m] + sin(2*pi*turns)*(fir*x)[m + lat]

    with ``lat = firlen/2`` (group delay compensated, time-aligned).

    Args:
      x: (..., n) float32.
      turns: negated-turns angle, broadcastable to ``x.shape[:-1]``.
    """
    if not stream_mix_supported(firlen):
        raise ValueError(f"unsupported firlen {firlen}")
    if x.device.type == "cpu":
        return rotate_small_plain(x, turns, firlen)
    _require_cuda_f32(x)
    t = torch.as_tensor(turns, dtype=torch.float32, device=x.device)
    t = t.broadcast_to(x.shape[:-1]).reshape(-1)
    return _rotate_small_kernel(_rows(x), t, firlen).reshape(x.shape)


def _rotate_small_kernel(x2: torch.Tensor, t: torch.Tensor,
                         firlen: int) -> torch.Tensor:
    """:func:`rotate_small`'s launch on (rows, n) with (rows,) turns:
    (rows, n), written time-aligned."""
    b, n = x2.shape
    # one (angle, 0) pair per row, the same for every frame (stride 0)
    angs = torch.stack([t, torch.zeros_like(t)], dim=-1)
    out = torch.empty((b, n), dtype=torch.float32, device=x2.device)
    # output frame o is the stream's frame o + lat/P: samples [lat, lat + n)
    if _launch(x2, firlen, -(-n // P), out, n, d_out=(firlen // 2) // P,
               angs=angs, ang_fs=0):
        _build.count_launch("rotate_small")
    return out


# the JAX package's names of the two wrappers above
fused_hilbert_small = hilbert_small
fused_rotate_small = rotate_small


def fused_stream_mix_plain(frames: torch.Tensor, angle_params: torch.Tensor,
                           firlen: int) -> torch.Tensor:
    """Plain twin of :func:`fused_stream_mix`: ``partitioned_convolve`` at
    P, the dry signal delayed by ``firlen/2``, and the per-sample ramp
    ``rad = (angle + slope*i) * 2*pi`` rounded like the kernel."""
    b, n_frames, _ = frames.shape
    x = frames.reshape(b, n_frames * P)
    spectra = partition_fir_spectra(firlen, P, frames.device)
    h = partitioned_convolve(x, spectra, P)[:, : n_frames * P]
    lat = firlen // 2
    dry = torch.nn.functional.pad(x, (lat, 0))[:, : n_frames * P]
    idx = torch.arange(P, dtype=torch.float32, device=frames.device)
    a = angle_params.to(torch.float32)
    rad = (a[..., :1] + a[..., 1:] * idx) * float(_TWO_PI)
    h = h.reshape(b, n_frames, P)
    dry = dry.reshape(b, n_frames, P)
    return torch.cos(rad) * dry + torch.sin(rad) * h


def fused_stream_mix(frames: torch.Tensor, angle_params: torch.Tensor,
                     firlen: int) -> torch.Tensor:
    """The complete streaming block body in one kernel pass:

        out[m] = cos(rad_m)*x[m - firlen/2] + sin(rad_m)*(fir*x)[m]

    with the per-sample angle ramp ``rad_m`` from per-frame
    ``angle_params`` (src/phaserotate.c:664-717).

    Args:
      frames: (B, n_frames, P) float32, the internal 256-sample framing of
        the input stream (plugin parsiz blocks are exact multiples).
      angle_params: (B, n_frames, 2) float32 per-frame (pre-frame angle in
        negated turns, per-sample slope), as
        ``stream.engine._internal_angle_params`` makes them.
      firlen: plugin FIR length (3072/4096/8192).

    Returns (B, n_frames, P) mixed output frames.
    """
    if not stream_mix_supported(firlen):
        raise ValueError(f"mix unsupported for firlen {firlen}")
    if frames.ndim != 3 or frames.shape[-1] != P:
        raise ValueError(f"frames must be (B, n_frames, {P}), got "
                         f"{tuple(frames.shape)}")
    if angle_params.shape != (*frames.shape[:2], 2):
        raise ValueError(f"angle_params must be {(*frames.shape[:2], 2)}, "
                         f"got {tuple(angle_params.shape)}")
    if frames.device.type == "cpu":
        return fused_stream_mix_plain(frames, angle_params, firlen)
    _require_cuda_f32(frames)
    if angle_params.dtype != torch.float32 or \
            angle_params.device != frames.device:
        raise TypeError("angle_params must be float32 on the frames' device")
    return _stream_mix_kernel(frames, angle_params, firlen)


def _stream_mix_kernel(frames: torch.Tensor, angle_params: torch.Tensor,
                       firlen: int) -> torch.Tensor:
    """:func:`fused_stream_mix`'s launch: the frames read in place as
    (B, n_frames*P) rows."""
    b, n_frames, _ = frames.shape
    x2 = _rows(frames.reshape(b, n_frames * P))
    angs = angle_params.contiguous().view(b, n_frames * 2)
    out = torch.empty((b, n_frames, P), dtype=torch.float32,
                      device=frames.device)
    if _launch(x2, firlen, n_frames, out.view(b, n_frames * P),
               n_frames * P, angs=angs, ang_fs=1):
        _build.count_launch("stream_mix")
    return out
