"""Streaming phase-rotation engine (torch).

Counterpart of ``phaserotate_tpu/stream/engine.py``: the plugin's
real-time path (src/phaserotate.c:538-772) as an explicit state carried
from block to block.  The engine keeps a frequency delay line: each input
frame is transformed once and its spectrum kept for the next ``n_segm``
blocks, so a block costs one forward and one inverse FFT plus ``n_segm``
complex multiply-adds.

Latency and block semantics match the plugin: output lags input by
``parsiz + firlen/2`` samples, the mix happens one ``parsiz`` block after
the input completes, and per-sample angle interpolation follows
src/phaserotate.c:673-709 (rate clamp ``parsiz*1e-6`` turns/sample,
wrap-around at +-180 deg).

Where the JAX package scans (``lax.scan``) the port loops over frames, and
where it maps over channels (``vmap``) the port broadcasts over leading
dims.  The per-block engine runs plain torch on every device, as the JAX
package runs plain XLA there; the whole-signal :func:`rotate_streamed` on
CUDA runs the stream_conv kernel (:func:`fused_stream_mix`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..core.angles import _TWO_PI, degrees_to_turns
from ..core.device import as_f32
from ..core.fir import partition_fir_spectra
from ..core.sizes import StreamGeometry, stream_geometry_for_rate
from ..kernels.stream_conv import P, fused_stream_mix, stream_mix_supported

__all__ = [
    "StreamState",
    "angle_sequence",
    "host_angle_step",
    "init_state",
    "rotate_streamed",
    "stream_process",
    "stream_process_batched",
    "stream_process_bulk",
    "stream_step",
    "stream_step_batched",
]


@dataclasses.dataclass
class StreamState:
    """Per-channel streaming carry; leading dims are channels.

    Attributes:
      spec_hist: (..., n_segm, parsiz+1) complex64 — spectra of the last
        n_segm input frames, newest first (frequency delay line).  The JAX
        package keeps them as real/imag float32 pairs; checkpoints use
        that layout (stream/checkpoint.py).
      time_hist: (..., n_segm//2 + 1, parsiz) float32 — recent input
        frames, newest first; row n_segm//2 is the FIR-group-delay-aligned
        input (src/phaserotate.c:664-670).
      tail: (..., parsiz) float32 — overlap-add tail of the previous
        inverse FFT (src/phaserotate.c:633).
      angle: (...) float32 — current angle in negated turns.
    """

    spec_hist: torch.Tensor
    time_hist: torch.Tensor
    tail: torch.Tensor
    angle: torch.Tensor


def init_state(geom: StreamGeometry, channels: Tuple[int, ...] = (),
               device=None) -> StreamState:
    """Zeroed state — the plugin's ``activate`` (src/phaserotate.c:511-520).

    ``channels`` prepends batch dims, e.g. ``(2,)`` for stereo."""
    shape = tuple(channels)
    f32 = dict(dtype=torch.float32, device=device)
    return StreamState(
        spec_hist=torch.zeros((*shape, geom.n_segm, geom.parsiz + 1),
                              dtype=torch.complex64, device=device),
        time_hist=torch.zeros((*shape, geom.n_segm // 2 + 1, geom.parsiz),
                              **f32),
        tail=torch.zeros((*shape, geom.parsiz), **f32),
        angle=torch.zeros(shape, **f32),
    )


def _angle_step(angle: torch.Tensor, target: torch.Tensor,
                geom: StreamGeometry):
    """One block's angle-ramp bookkeeping (src/phaserotate.c:673-709).

    Returns ``(new_angle, da, interpolating)``: the post-block angle, the
    per-sample slope (0 when steady) and whether the block ramps."""
    da = target - angle
    # wrap around at +-180 deg (src/phaserotate.c:676-683)
    da = torch.where(da.abs() > 0.5, da - torch.sign(da), da)
    da = da * float(np.float32(geom.interp_nm))
    thresh = float(np.float32(geom.interp_th))
    clipped = da.abs() > thresh
    da = torch.clamp(da, -thresh, thresh)
    interpolating = target != angle
    new_angle = torch.where(
        interpolating,
        torch.where(clipped, angle + da * float(geom.parsiz), target),
        angle)
    return new_angle, torch.where(interpolating, da, 0.0), interpolating


def _angle_step_np(angle, target, geom: StreamGeometry):
    """:func:`_angle_step` in numpy float32 (the same operations, so the
    same bits)."""
    angle = np.asarray(angle, np.float32)
    target = np.asarray(target, np.float32)
    da = (target - angle).astype(np.float32)
    da = np.where(np.abs(da) > np.float32(0.5),
                  (da - np.sign(da)).astype(np.float32), da)
    da = (da * np.float32(geom.interp_nm)).astype(np.float32)
    thresh = np.float32(geom.interp_th)
    clipped = np.abs(da) > thresh
    da = np.clip(da, -thresh, thresh).astype(np.float32)
    interpolating = target != angle
    stepped = (angle + da * np.float32(geom.parsiz)).astype(np.float32)
    new_angle = np.where(interpolating, np.where(clipped, stepped, target),
                         angle).astype(np.float32)
    return new_angle, np.where(interpolating, da, np.float32(0.0)), \
        interpolating


def host_angle_step(angle: np.ndarray, target: np.ndarray,
                    geom: StreamGeometry) -> np.ndarray:
    """Numpy twin of the angle recursion: a host shell tracks the
    per-block angle without reading ``state.angle`` back from the
    device."""
    return _angle_step_np(angle, target, geom)[0]


def _mix_apply(delayed_in: torch.Tensor, hilb: torch.Tensor,
               angle: torch.Tensor, da: torch.Tensor,
               interpolating: torch.Tensor, parsiz: int) -> torch.Tensor:
    """Apply the rotation mix given each block's angle/slope
    (src/phaserotate.c:700, 710-717); angle, da and interpolating carry
    the leading dims of the (..., parsiz) blocks."""
    twopi = float(_TWO_PI)
    idx = torch.arange(parsiz, dtype=torch.float32, device=hilb.device)
    rad = (angle[..., None] + da[..., None] * idx) * twopi
    out_interp = torch.cos(rad) * delayed_in + torch.sin(rad) * hilb
    # steady state: constant coefficients (src/phaserotate.c:710-717)
    rad0 = (angle * twopi)[..., None]
    out_const = torch.cos(rad0) * delayed_in + torch.sin(rad0) * hilb
    return torch.where(interpolating[..., None], out_interp, out_const)


@functools.lru_cache(maxsize=16)
def _fir_spectra_on(firlen: int, parsiz: int,
                    device: torch.device) -> torch.Tensor:
    return partition_fir_spectra(firlen, parsiz, device)


def _fir_spectra(geom: StreamGeometry, device) -> torch.Tensor:
    """The geometry's partition spectra on ``device``, made once."""
    return _fir_spectra_on(geom.firlen, geom.parsiz, torch.device(device))


def stream_step(state: StreamState, frame: torch.Tensor, target_degrees,
                geom: StreamGeometry) -> Tuple[StreamState, torch.Tensor]:
    """Process one ``parsiz``-sample input frame (..., parsiz); returns the
    output frame the plugin would emit while the next frame streams in.

    Leading dims of ``state``, ``frame`` and ``target_degrees`` are
    channels, so one call advances every channel (also exported as
    :func:`stream_step_batched`, the JAX package's vmapped name).  The
    block body mirrors src/phaserotate.c:629-719 with the FFT schedule
    hoisted into the frequency delay line."""
    dev = state.tail.device
    frame = torch.as_tensor(frame, dtype=torch.float32, device=dev)
    target = degrees_to_turns(target_degrees, device=dev)
    fir = _fir_spectra(geom, dev)

    spec = torch.fft.rfft(frame, n=geom.fftlen)
    spec_hist = torch.cat([spec[..., None, :], state.spec_hist[..., :-1, :]],
                          dim=-2)
    time_hist = torch.cat([frame[..., None, :], state.time_hist[..., :-1, :]],
                          dim=-2)

    # sum_s X[s] * FIR[s]  (src/phaserotate.c:640-655); one reduction,
    # not n_segm launches: the per-frame step is launch-bound on a card
    freq_sum = (spec_hist * fir).sum(dim=-2)
    y = torch.fft.irfft(freq_sum, n=geom.fftlen)

    hilb = state.tail + y[..., : geom.parsiz]  # overlap-add (:660-662)
    delayed_in = time_hist[..., geom.n_segm // 2, :]  # firlen/2 (:664-670)
    new_angle, da, interp = _angle_step(state.angle, target, geom)
    out = _mix_apply(delayed_in, hilb, state.angle, da, interp, geom.parsiz)
    return StreamState(spec_hist=spec_hist, time_hist=time_hist,
                       tail=y[..., geom.parsiz :], angle=new_angle), out


def stream_step_batched(state: StreamState, frames: torch.Tensor,
                        target_degrees, geom: StreamGeometry
                        ) -> Tuple[StreamState, torch.Tensor]:
    """:func:`stream_step` under the JAX package's vmapped name and its
    parameter names: ``frames`` (channels, parsiz), one frame per channel
    of a batched ``state``."""
    return stream_step(state, frames, target_degrees, geom)


def stream_process(state: StreamState, frames: torch.Tensor, target_degrees,
                   geom: StreamGeometry) -> Tuple[StreamState, torch.Tensor]:
    """Loop :func:`stream_step` over ``frames`` (..., n_frames, parsiz).

    ``target_degrees`` is per frame (..., n_frames): the control-port
    value the plugin reads at each block boundary."""
    dev = state.tail.device
    frames = torch.as_tensor(frames, dtype=torch.float32, device=dev)
    targets = torch.as_tensor(target_degrees, dtype=torch.float32,
                              device=dev)
    outs = []
    for i in range(frames.shape[-2]):
        # contiguous: each step sees the layout a single host frame has
        state, y = stream_step(state, frames[..., i, :].contiguous(),
                               targets[..., i], geom)
        outs.append(y)
    if not outs:
        return state, frames.clone()
    return state, torch.stack(outs, dim=-2)


def stream_process_batched(state: StreamState, frames: torch.Tensor,
                           target_degrees, geom: StreamGeometry):
    """Loop over frames for every channel at once.

    Args:
      state: batched state from ``init_state(geom, (channels,))``.
      frames: (channels, n_frames, parsiz) float32.
      target_degrees: (channels,) — one control read per host block,
        shared by every frame in it (src/phaserotate.c:564).

    Returns (new_state, (channels, n_frames, parsiz) outputs), the same
    per-frame arithmetic as :func:`stream_step_batched`.
    """
    dev = state.tail.device
    frames = torch.as_tensor(frames, dtype=torch.float32, device=dev)
    targets = torch.as_tensor(target_degrees, dtype=torch.float32,
                              device=dev)
    return stream_process(state, frames,
                          targets[..., None].expand(frames.shape[:-1]), geom)


def angle_sequence(angle0, target_degrees, geom: StreamGeometry):
    """Unroll the per-block angle-ramp recursion for a frame sequence.

    The angle carry is the only sequential dependency of the engine that
    feeds the output values, and it is scalar, so the host resolves it in
    numpy float32 (the same operations as the device step).  Steady runs
    (angle equal to a constant target) are filled without iterating.

    Returns numpy ``(angles, das, interpolating, final_angle)``: the
    pre-block angle and slope each frame mixes with.
    """
    targets = degrees_to_turns(
        torch.as_tensor(np.asarray(target_degrees, np.float32))).numpy()
    n = targets.shape[0]
    angles = np.empty(n, np.float32)
    das = np.zeros(n, np.float32)
    interps = np.zeros(n, bool)
    angle = np.float32(np.asarray(angle0, np.float32))
    # where the target changes: a steady run ends only there
    change = np.flatnonzero(np.diff(targets)) + 1
    i = 0
    while i < n:
        if targets[i] == angle:
            j = change[np.searchsorted(change, i, side="right")] \
                if change.size and change[-1] > i else n
            angles[i:j] = angle
            i = j
            continue
        new, da, interp = _angle_step_np(angle, targets[i], geom)
        angles[i], das[i], interps[i] = angle, da, interp
        angle = np.float32(new)
        i += 1
    return angles, das, interps, angle


def stream_process_bulk(state: StreamState, frames: torch.Tensor,
                        target_degrees, geom: StreamGeometry):
    """Vectorized equivalent of :func:`stream_process` for one channel:
    every frame's FFT in one batched transform instead of a loop.

    The frequency delay line only reads past spectra, the OLA tail
    reaches back one block, and the angle carry is scalar (resolved by
    :func:`angle_sequence` up front), so the call is one batched rfft, a
    block-axis FIR MAC over slices of the extended spectrum sequence, one
    batched irfft, a shifted add and the rotation mix.  Returns the same
    mid-stream state as :func:`stream_process`.

    Args:
      state: unbatched state (``init_state(geom)``).
      frames: (n_frames, parsiz) float32.
      target_degrees: (n_frames,) per-frame targets.
    """
    parsiz, n_segm = geom.parsiz, geom.n_segm
    dev = state.tail.device
    frames = torch.as_tensor(frames, dtype=torch.float32, device=dev)
    fir = _fir_spectra(geom, dev)
    n_frames = frames.shape[0]

    angles, das, interps, final_angle = angle_sequence(
        state.angle.cpu(), target_degrees, geom)

    spec = torch.fft.rfft(frames, n=geom.fftlen)  # (n_frames, nbins)
    # E[j] = spectrum of global frame j - (n_segm-1); history is
    # newest-first in the state
    hist = state.spec_hist[: n_segm - 1].flip(0)
    ext = torch.cat([hist, spec], dim=0)

    # frequency delay line MAC (src/phaserotate.c:640-655)
    freq_sum = ext[n_segm - 1 : n_segm - 1 + n_frames] * fir[0]
    for s in range(1, n_segm):
        freq_sum = freq_sum + (
            ext[n_segm - 1 - s : n_segm - 1 - s + n_frames] * fir[s])
    y = torch.fft.irfft(freq_sum, n=geom.fftlen)  # (n_frames, fftlen)

    tails = torch.cat([state.tail[None], y[:-1, parsiz:]], dim=0)
    hilb = y[:, :parsiz] + tails

    # group-delay-aligned dry signal (src/phaserotate.c:664-670)
    t_hist = state.time_hist[: n_segm // 2].flip(0)
    ext_time = torch.cat([t_hist, frames], dim=0)
    delayed_in = ext_time[:n_frames]

    out = _mix_apply(delayed_in, hilb, torch.from_numpy(angles).to(dev),
                     torch.from_numpy(das).to(dev),
                     torch.from_numpy(interps).to(dev), parsiz)
    new_state = StreamState(
        spec_hist=ext.flip(0)[:n_segm].clone(),
        time_hist=ext_time.flip(0)[: n_segm // 2 + 1].clone(),
        tail=y[-1, parsiz:].clone(),
        angle=torch.tensor(final_angle, device=dev),
    )
    return new_state, out


def _internal_angle_params(angles: np.ndarray, das: np.ndarray,
                           geom: StreamGeometry) -> np.ndarray:
    """Expand per-plugin-block (angle, slope) to the kernel's internal
    256-sample framing: frame j of a block starts ``256*j`` samples into
    its ramp.  Returns (n_frames * parsiz/256, 2) float32."""
    r = geom.parsiz // P
    offs = np.float32(P) * np.arange(r, dtype=np.float32)
    a = (angles[:, None] + das[:, None] * offs[None, :]).astype(np.float32)
    d = np.broadcast_to(das[:, None], a.shape)
    return np.stack([a.reshape(-1), d.reshape(-1)], axis=-1)


def _rotate_streamed_fused(frames: torch.Tensor, targets,
                           geom: StreamGeometry,
                           chunk_frames: int) -> torch.Tensor:
    """Whole-stream rotation through the stream_conv kernel's ramp mode
    (:func:`fused_stream_mix`): a fresh plugin instance's exact stream.

    Chunking contract: the kernel's cross-frame state (spectrum history,
    OLA tail, dry delay) reaches back at most ``firlen`` samples, so each
    chunk re-feeds its previous ``firlen/256`` internal frames as a
    prelude and drops their outputs; older history contributes exact
    zeros, so the result equals the unchunked run.
    """
    angles, das, _, _ = angle_sequence(np.float32(0.0), targets, geom)
    params = torch.from_numpy(
        _internal_angle_params(angles, das, geom)).to(frames.device)[None]
    fr256 = frames.reshape(1, -1, P)
    total_int = fr256.shape[1]
    pre = geom.firlen // P
    chunk_int = chunk_frames * (geom.parsiz // P)
    if total_int <= chunk_int:
        return fused_stream_mix(fr256, params, geom.firlen)[0].reshape(-1)
    outs = []
    for start in range(0, total_int, chunk_int):
        lead = min(pre, start)
        end = min(start + chunk_int, total_int)
        out = fused_stream_mix(fr256[:, start - lead : end],
                               params[:, start - lead : end], geom.firlen)
        outs.append(out[0, lead:].reshape(-1))
    return torch.cat(outs)


def rotate_streamed(audio, degrees, rate: float = 48000.0,
                    geom: StreamGeometry | None = None,
                    trim_latency: bool = True, chunk_frames: int = 16384,
                    device=None) -> torch.Tensor:
    """Rotate a whole mono signal (n,) through the streaming engine.

    Reproduces what an LV2 host pushing the whole file through the plugin
    gets.  With ``trim_latency`` the ``parsiz + firlen/2`` delay is
    removed so the result aligns with :func:`phaserotate_tpu_torch.rotate`.

    On CUDA, for the plugin FIRs (``stream_mix_supported``), it runs the
    stream_conv kernel with the per-sample angle ramp; elsewhere the
    vectorized bulk engine in ``chunk_frames`` slices with the exact state
    carry between them.  A non-tensor ``audio`` goes to ``device`` (default:
    the CUDA device; ``"cpu"`` for the CPU).
    """
    if geom is None:
        geom = stream_geometry_for_rate(rate)
    x = as_f32(audio, device)
    n = x.shape[-1]
    parsiz = geom.parsiz
    # pad with latency worth of silence so the tail flushes
    pad_frames = -(-(n + geom.latency) // parsiz)
    total = pad_frames * parsiz
    frames = torch.nn.functional.pad(x, (0, total - n)).reshape(
        pad_frames, parsiz)
    targets = np.full((pad_frames,), np.float32(degrees), np.float32)

    if x.device.type == "cuda" and stream_mix_supported(geom.firlen):
        y = _rotate_streamed_fused(frames, targets, geom, chunk_frames)
    else:
        state = init_state(geom, device=x.device)
        outs = []
        for start in range(0, pad_frames, chunk_frames):
            state, out_frames = stream_process_bulk(
                state, frames[start : start + chunk_frames],
                targets[start : start + chunk_frames], geom)
            outs.append(out_frames.reshape(-1))
        y = torch.cat(outs)
    if trim_latency:
        # frame k of the output is computed from input frame k; only the
        # FIR group delay remains
        return y[geom.firlat : geom.firlat + n]
    return torch.cat([x.new_zeros(parsiz), y])[: n + geom.latency]
