"""Batched min-peak angle sweep (torch).

Counterpart of ``phaserotate_tpu/search/sweep.py``.  The whole file's
Hilbert signal comes from one batched convolution (the stream_conv kernel
on CUDA) and all candidate angles are evaluated together by the sweep
kernel (kernels/rotate_peak.py): no serial angle loop, no serial block
loop, no (samples x angles) tensor.

Alignment map (derived from cli/phase-rotate.cc:181-232, 389-428):

* stream position ``m`` of block ``k``, offset ``i``: ``m = k*parsiz + i``
* Hilbert output ``hil[i]`` of block ``k`` is the linear convolution
  ``(fir * x)[m]`` (fir support ``parsiz`` taps, group delay ``firlen =
  parsiz/2``)
* the paired "dry" sample is ``x[m - firlen]`` (``&tdc[firlen]``)
* evaluated sample set per angle != 0:
  - first block (``start`` flag): pairs ``hil[firlen..parsiz)`` with
    *pre-file zeros*, i.e. contributes ``|sa|*max|h[m]|, m in [firlen,
    parsiz)``
  - all later blocks (including one final all-zero flush block,
    cli/phase-rotate.cc:585-586): aligned pairs for
    ``m in [parsiz, (B+1)*parsiz)``
* angle == 0 is special-cased to the raw input peak
  (cli/phase-rotate.cc:413-414).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.angles import MAXSAMPLE, all_angle_cos_sin, sincos_lut
from ..core.device import as_f32, resolve_device
from ..core.sizes import OfflineGeometry
from ..kernels.hilbert32k import hilbert_32k
from ..kernels.pcm24 import pcm24_widen
from ..kernels.rotate_peak import rotate_peak_sweep_kernel
from ..kernels.stream_conv import hilbert_small, small_conv_supported
from ..utils.profiling import span

__all__ = ["sweep_peaks", "sweep_peaks_aux", "sweep_peaks_aux_pcm16",
           "sweep_peaks_aux_pcm24", "apply_angles", "hilbert_offline",
           "aligned_pair"]


def _offline_frames(x: torch.Tensor, parsiz: int) -> int:
    """Number of data blocks the CLI would read (silence-padded)."""
    return -(-x.shape[-1] // parsiz)


def _pad_last(x: torch.Tensor, right: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, right))


def hilbert_offline(x: torch.Tensor, geom: OfflineGeometry) -> torch.Tensor:
    """Full-stream Hilbert-FIR signal ``h[m] = (fir * x)[m]`` with the
    offline geometry, length ``(B+1)*parsiz`` (one flush block).

    Identical arithmetic to PhaseRotateProc::hilbert
    (cli/phase-rotate.cc:181-212).  Every offline parsiz the small kernel
    can frame (1024..16384) goes through it; blksiz 32768 (176.4 and 192
    kHz) goes through ``kernels.hilbert32k.hilbert_32k``, the plain
    single-partition OLA on the CPU, under the span
    ``hilbert.one_partition`` (attributes ``rows``, ``n`` input samples a
    row and ``n_out``; its device time on a card).
    """
    parsiz = geom.parsiz
    want = (_offline_frames(x, parsiz) + 1) * parsiz
    if small_conv_supported(parsiz):
        h = hilbert_small(x, fir_taps=parsiz)
        if h.shape[-1] < want:  # conv support ends before the flush
            # block boundary: the missing tail is exactly zero
            h = _pad_last(h, want - h.shape[-1])
        return h[..., :want]
    n = x.shape[-1]
    with span("hilbert.one_partition", device=x.device,
              rows=x.numel() // max(n, 1), n=n, n_out=want):
        return hilbert_32k(x)


def aligned_pair(x: torch.Tensor, geom: OfflineGeometry):
    """The evaluation operands of the CLI sweep (alignment map in the
    module docstring): returns ``(b0, b1, h_start, x_peak)`` where
    ``(b0, b1)`` are the aligned dry/Hilbert pairs for the post-start
    stream positions, ``h_start`` the start-block Hilbert peak and
    ``x_peak`` the raw input peak over every read block."""
    parsiz = geom.parsiz
    firlen = geom.firlen
    n_blocks = _offline_frames(x, parsiz)
    total = (n_blocks + 1) * parsiz

    x_pad = _pad_last(x, total - x.shape[-1])
    h = hilbert_offline(x, geom)  # (..., total)

    # aligned pairs for m in [parsiz, total)
    b0 = x_pad[..., parsiz - firlen : total - firlen]  # x[m - firlen]
    b1 = h[..., parsiz:total]
    # start-block region: |sin| * max|h[firlen:parsiz]|
    # (cli/phase-rotate.cc:418-419)
    h_start = h[..., firlen:parsiz].abs().amax(dim=-1)
    x_peak = x_pad.abs().amax(dim=-1)
    return b0, b1, h_start, x_peak


def _sweep_impl(x: torch.Tensor, geom: OfflineGeometry, chunk: int):
    b0, b1, h_start, x_peak = aligned_pair(x, geom)
    cs = all_angle_cos_sin(x.device)  # (2, 360)
    peaks = rotate_peak_sweep_kernel(b0, b1, cs, tile_len=chunk)
    peaks = torch.maximum(peaks, cs[1].abs() * h_start[..., None])
    # aux: the "rotated by 0" peak (max|b0| over the aligned region) —
    # what a fine window crossing 360 writes into table slot 0 via the
    # non-special-cased path (cli/phase-rotate.cc:415-422 with a == 0)
    rot0 = peaks[..., 0].clone()
    # angle 0 proper: raw input peak over every read block incl.
    # silence pad (cli/phase-rotate.cc:413-414)
    peaks[..., 0] = x_peak
    return peaks, rot0


def sweep_peaks(audio, geom: OfflineGeometry, chunk: int = 4096,
                device=None) -> torch.Tensor:
    """Peak level per candidate rotation angle.

    Args:
      audio: (..., n) float32 — channels/files in leading dims.
      geom: offline geometry (CLI block size).
      chunk: samples per sweep-kernel block.
      device: where a non-tensor ``audio`` goes (default: the CUDA
        device; ``"cpu"`` for the CPU).

    Returns (..., MAXSAMPLE) float32: ``peaks[..., a]`` is the digital peak
    after rotating by ``a`` half-degrees — the table the CLI accumulates
    per block and per angle (cli/phase-rotate.cc:409-428).
    """
    x = as_f32(audio, device)
    return _sweep_impl(x, geom, chunk)[0]


def sweep_peaks_aux(audio, geom: OfflineGeometry, chunk: int = 4096,
                    device=None):
    """Like :func:`sweep_peaks` but also returns the (...,) "rotated at 0"
    aux peak needed for bit-exact fine-pass parity (see minimize.py)."""
    x = as_f32(audio, device)
    return _sweep_impl(x, geom, chunk)


def sweep_peaks_aux_pcm16(audio_i16, geom: OfflineGeometry,
                          chunk: int = 4096, device=None):
    """:func:`sweep_peaks_aux` over raw int16 PCM.

    Ingest path for 16-bit files: the int16 samples go to the device as
    they are, half the bytes of float32 over the host->device link, and
    are dequantized there (int16/32768, the PCM convention of
    ``_pcm_to_float`` in io/wav.py).  Pair with ``io.read_audio_pcm16`` so
    a 16-bit file goes disk -> device without ever materializing host
    floats.
    """
    if not isinstance(audio_i16, torch.Tensor):
        audio_i16 = np.asarray(audio_i16)
    if audio_i16.dtype not in (torch.int16, np.int16):
        raise TypeError(f"expected int16 PCM, got {audio_i16.dtype}")
    x16 = torch.as_tensor(audio_i16,
                          device=resolve_device(device, audio_i16))
    x = x16.to(torch.float32) * (1.0 / 32768.0)
    return _sweep_impl(x, geom, chunk)


def sweep_peaks_aux_pcm24(payload, geom: OfflineGeometry, device=None):
    """:func:`sweep_peaks_aux` over 24-bit PCM as the files hold it.

    Ingest path for 24-bit WAVs: ``payload`` is (files, n_pad, channels,
    3) uint8, each row one file's interleaved little-endian 3-byte
    samples, zero-padded (``io.pcm24.read_pcm24_into`` fills the rows).
    It goes to the device as it is, 3 bytes a sample, and
    ``kernels.pcm24.pcm24_widen`` turns it there into (files, channels,
    n_pad) float32 ``int24 / 2^23``, which is exact, under the span
    ``pcm24.widen`` (attributes ``samples`` and ``batch``; its device time
    on a card).
    """
    raw = torch.as_tensor(payload, device=resolve_device(device, payload))
    with span("pcm24.widen", device=raw.device) as widening:
        x = pcm24_widen(raw)
        widening.set(samples=x.numel(), batch=x.shape[0])
    return _sweep_impl(x, geom, 4096)


def apply_angles(audio, angle_units, geom: OfflineGeometry,
                 device=None) -> torch.Tensor:
    """Apply per-channel rotations with the CLI's offline engine semantics.

    ``angle_units`` are integer half-degrees, broadcastable to the leading
    dims of ``audio``; negative values wrap modulo 180 degrees exactly like
    PhaseRotate::thr_apply (cli/phase-rotate.cc:463) — i.e. -10 deg applies
    as 170 deg (the peak-equivalent negated waveform).

    Returns the rotated file, same length, latency already compensated:
    ``y[m] = cos*x[m] + sin*h[m + firlen]`` (the write path skips blksiz/2
    frames, cli/phase-rotate.cc:963-991).
    """
    x = as_f32(audio, device)
    n = x.shape[-1]
    firlen = geom.firlen
    h = hilbert_offline(x, geom)
    a = torch.as_tensor(angle_units, dtype=torch.int64, device=x.device)
    a = torch.remainder(a + MAXSAMPLE, MAXSAMPLE)
    sin_t, cos_t = sincos_lut(x.device)
    return (cos_t[a][..., None] * x
            + sin_t[a][..., None] * h[..., firlen : firlen + n])
