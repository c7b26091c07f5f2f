"""Metering subsystem: peak / momentary / gain-diff ballistics (torch).

Counterpart of ``phaserotate_tpu/meter/meter.py``, the plugin's meter state
machine (src/phaserotate.c:451-509, 573-611, 832-838):

* momentary meter: rises instantly, holds 0.5 s, then falls at 15 dB/s
  (hold time src/phaserotate.c:303, falloff :832-838);
* peak-hold meter: all-time max until an explicit reset;
* gain-diff meter: running min/max of the momentary out/in ratio
  (:730-739), with a delayed reset `latency` samples after an angle change
  so the ratio never mixes pre/post-change audio (:497-509, 611);
* the input meter is time-aligned to the output through a `latency`-sample
  delay line (:575-609).

State is a dataclass of small tensors updated by plain functions.  Leading
dims are channels: one call meters every channel, where the JAX package
maps over them.  This is plain torch on every device, as the JAX package
runs plain XLA here.

``host_meter_state``, ``host_meter_block`` and ``host_reset_peaks`` are
numpy twins, bit for bit, for meters kept on the host CPU (the plugin's):
every torch op hands the GIL to another thread and back, and a daemon
serving many sessions from many threads pays that handoff per op (PERF.md
§6 "PR 10"); a numpy block of a few thousand samples keeps it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "DIFF_GATE",
    "FALL_DB_PER_S",
    "HOLD_SECONDS",
    "MeterConfig",
    "MeterState",
    "MeterLevels",
    "init_meter_state",
    "meter_falloff",
    "meter_block",
    "reset_peaks",
    "delay_line_update",
    "host_meter_block",
    "host_meter_state",
    "host_reset_peaks",
]

FALL_DB_PER_S = 15.0  # src/phaserotate.c:834
HOLD_SECONDS = 0.5  # src/phaserotate.c:303
DIFF_GATE = 0.001  # src/phaserotate.c:731


@dataclasses.dataclass(frozen=True)
class MeterConfig:
    """Static meter configuration."""

    rate: float
    latency: int

    @property
    def hold_samples(self) -> int:
        """Momentary hold time in samples (src/phaserotate.c:303)."""
        return int(HOLD_SECONDS * self.rate + 0.5)


@dataclasses.dataclass
class MeterState:
    """Per-channel meter carry; leading dims are channels.

    Index 0 of each pair is the input meter, 1 the output meter
    (src/phaserotate.c:67-72).
    """

    momentary: torch.Tensor  # (..., 2) f32
    peak: torch.Tensor  # (..., 2) f32
    holdcnt: torch.Tensor  # (..., 2) i32
    diff: torch.Tensor  # (..., 2) f32: [min, max] ratio
    reset_delay: torch.Tensor  # (...) i32
    dly: torch.Tensor  # (..., latency) f32 input delay line


@dataclasses.dataclass
class MeterLevels:
    """One block's meter outputs — the 9 fields of the `levels` atom
    (src/phaserotate.c:749-768)."""

    in_cur: torch.Tensor
    in_mom: torch.Tensor
    in_peak: torch.Tensor
    out_cur: torch.Tensor
    out_mom: torch.Tensor
    out_peak: torch.Tensor
    diff_cur: torch.Tensor
    diff_min: torch.Tensor
    diff_max: torch.Tensor


def init_meter_state(cfg: MeterConfig, channels: Tuple[int, ...] = (),
                     device=None) -> MeterState:
    """Fresh meters (channel_init + activate,
    src/phaserotate.c:147-157, 489-495, 511-519).

    ``reset_delay`` starts at ``latency`` like activate() does (:518)."""
    shape = tuple(channels)
    f32 = dict(dtype=torch.float32, device=device)
    return MeterState(
        momentary=torch.zeros((*shape, 2), **f32),
        peak=torch.zeros((*shape, 2), **f32),
        holdcnt=torch.zeros((*shape, 2), dtype=torch.int32, device=device),
        diff=torch.ones((*shape, 2), **f32),
        reset_delay=torch.full(shape, cfg.latency, dtype=torch.int32,
                               device=device),
        dly=torch.zeros((*shape, cfg.latency), **f32),
    )


def meter_falloff(rate: float, n_samples: int, device=None) -> torch.Tensor:
    """Per-block momentary decay multiplier for a 15 dB/s fall
    (src/phaserotate.c:832-838), float32."""
    tme = np.float32(n_samples) / np.float32(rate)
    expo = np.float32(-0.05 * FALL_DB_PER_S) * tme
    return torch.pow(torch.tensor(10.0, dtype=torch.float32, device=device),
                     torch.tensor(expo, device=device))


def _meter_proc(mom, peak, holdcnt, new_peak, hold_samples: int, fpp: int,
                falloff):
    """One meter's ballistics step (src/phaserotate.c:451-470)."""
    new_peak = torch.where(torch.isfinite(new_peak), new_peak, 0.0)
    peak = torch.maximum(peak, new_peak)
    rises = new_peak > mom
    holding = holdcnt > 0
    mom_next = torch.where(
        rises, new_peak, torch.where(holding, mom, mom * falloff + 1e-20))
    holdcnt_next = torch.where(
        rises, torch.full_like(holdcnt, hold_samples),
        torch.where(holding, holdcnt - fpp, holdcnt))
    return mom_next, peak, holdcnt_next, new_peak


def delay_line_update(dly: torch.Tensor, block: torch.Tensor):
    """Push ``block`` through the delay line; returns (delayed_block, dly').

    The plugin's input-meter alignment buffer (src/phaserotate.c:575-608)
    reduces to this concat/split."""
    combined = torch.cat([dly, block], dim=-1)
    n = block.shape[-1]
    return combined[..., :n], combined[..., n:]


def _abs_max(x: torch.Tensor) -> torch.Tensor:
    if x.shape[-1] == 0:
        return x.new_zeros(x.shape[:-1])
    return x.abs().amax(dim=-1)


def meter_block(
    state: MeterState,
    in_block: torch.Tensor,
    out_block: torch.Tensor,
    falloff: torch.Tensor,
    hold_samples: int,
    angle_changed,
) -> Tuple[MeterState, MeterLevels]:
    """Process one host block's metering.

    Args:
      state: current meters (leading dims are channels).
      in_block: (..., n) the channels' raw input this block.
      out_block: (..., n) the rotated output this block.
      falloff: per-block decay factor (:func:`meter_falloff` — recompute
        when the host block size changes, src/phaserotate.c:833).
      hold_samples: momentary hold in samples.
      angle_changed: bool per channel — target angle != current angle
        this block; schedules the delayed diff reset
        (src/phaserotate.c:611).

    Returns (new_state, levels-for-this-block).
    """
    dev = state.dly.device
    in_block = torch.as_tensor(in_block, dtype=torch.float32, device=dev)
    out_block = torch.as_tensor(out_block, dtype=torch.float32, device=dev)
    changed = torch.as_tensor(angle_changed, dtype=torch.bool, device=dev)
    n = in_block.shape[-1]
    latency = state.dly.shape[-1]

    delayed, dly = delay_line_update(state.dly, in_block)
    lvl_in_raw = _abs_max(delayed)
    lvl_out_raw = _abs_max(out_block)

    mom0, peak0, hold0, lvl_in = _meter_proc(
        state.momentary[..., 0], state.peak[..., 0], state.holdcnt[..., 0],
        lvl_in_raw, hold_samples, n, falloff)

    # delayed meter reset runs BEFORE the output meter ballistics
    # (src/phaserotate.c:611 precedes :728): while the reset window is
    # open, diff pins to 1 and the output momentary restarts from 0 so the
    # block's own output peak re-seeds it immediately (:497-509).
    resetting = state.reset_delay > 0
    diff_min = torch.where(resetting, 1.0, state.diff[..., 0])
    diff_max = torch.where(resetting, 1.0, state.diff[..., 1])
    mom1_pre = torch.where(resetting, 0.0, state.momentary[..., 1])
    reset_delay = torch.where(resetting, state.reset_delay - n,
                              state.reset_delay)
    reset_delay = torch.where(changed, torch.full_like(reset_delay,
                                                       latency + n),
                              reset_delay)

    mom1, peak1, hold1, lvl_out = _meter_proc(
        mom1_pre, state.peak[..., 1], state.holdcnt[..., 1],
        lvl_out_raw, hold_samples, n, falloff)

    # gain-diff ratio (src/phaserotate.c:730-739)
    gated = (mom0 > DIFF_GATE) & (mom1 > DIFF_GATE)
    ratio = torch.where(gated, mom1 / torch.clamp(mom0, min=1e-30), 1.0)
    diff_min = torch.where(gated & (ratio < diff_min), ratio, diff_min)
    diff_max = torch.where(gated & (ratio > diff_max), ratio, diff_max)

    new_state = MeterState(
        momentary=torch.stack([mom0, mom1], dim=-1),
        peak=torch.stack([peak0, peak1], dim=-1),
        holdcnt=torch.stack([hold0, hold1], dim=-1),
        diff=torch.stack([diff_min, diff_max], dim=-1),
        reset_delay=reset_delay,
        dly=dly,
    )
    levels = MeterLevels(
        in_cur=lvl_in, in_mom=mom0, in_peak=peak0,
        out_cur=lvl_out, out_mom=mom1, out_peak=peak1,
        diff_cur=ratio, diff_min=diff_min, diff_max=diff_max,
    )
    return new_state, levels


def reset_peaks(state: MeterState) -> MeterState:
    """GUI 'reset_peaks' message (src/phaserotate.c:489-495)."""
    return dataclasses.replace(
        state,
        peak=torch.zeros_like(state.peak),
        diff=torch.ones_like(state.diff),
        momentary=torch.zeros_like(state.momentary),
    )


def host_meter_state(cfg: MeterConfig, channels: Tuple[int, ...] = ()
                     ) -> MeterState:
    """:func:`init_meter_state` with numpy arrays, for the host twins."""
    state = init_meter_state(cfg, channels, "cpu")
    return MeterState(**{f.name: getattr(state, f.name).numpy()
                         for f in dataclasses.fields(MeterState)})


def _meter_proc_np(mom, peak, holdcnt, new_peak, hold_samples: int,
                   fpp: int, falloff):
    """:func:`_meter_proc` in numpy float32 (the same operations, so the
    same bits)."""
    new_peak = np.where(np.isfinite(new_peak), new_peak, np.float32(0.0))
    peak = np.maximum(peak, new_peak)
    rises = new_peak > mom
    holding = holdcnt > 0
    mom_next = np.where(rises, new_peak,
                        np.where(holding, mom, mom * falloff
                                 + np.float32(1e-20)))
    holdcnt_next = np.where(rises, np.int32(hold_samples),
                            np.where(holding, holdcnt - np.int32(fpp),
                                     holdcnt))
    return mom_next, peak, holdcnt_next, new_peak


def host_meter_block(state: MeterState, in_block: np.ndarray,
                     out_block: np.ndarray, falloff, hold_samples: int,
                     angle_changed) -> Tuple[MeterState, MeterLevels]:
    """:func:`meter_block` on a :func:`host_meter_state` in numpy float32,
    bit-equal to it; the levels are numpy arrays."""
    falloff = np.float32(falloff)
    in_block = np.asarray(in_block, np.float32)
    out_block = np.asarray(out_block, np.float32)
    changed = np.asarray(angle_changed, bool)
    n = in_block.shape[-1]
    latency = state.dly.shape[-1]
    combined = np.concatenate([state.dly, in_block], axis=-1)
    delayed, dly = combined[..., :n], combined[..., n:]

    def abs_max(x):
        return (np.abs(x).max(axis=-1) if n
                else np.zeros(x.shape[:-1], np.float32))

    mom0, peak0, hold0, lvl_in = _meter_proc_np(
        state.momentary[..., 0], state.peak[..., 0], state.holdcnt[..., 0],
        abs_max(delayed), hold_samples, n, falloff)
    # the delayed reset before the output ballistics, as in meter_block
    resetting = state.reset_delay > 0
    one, zero = np.float32(1.0), np.float32(0.0)
    diff_min = np.where(resetting, one, state.diff[..., 0])
    diff_max = np.where(resetting, one, state.diff[..., 1])
    mom1_pre = np.where(resetting, zero, state.momentary[..., 1])
    reset_delay = np.where(resetting, state.reset_delay - np.int32(n),
                           state.reset_delay)
    reset_delay = np.where(changed, np.int32(latency + n), reset_delay)
    mom1, peak1, hold1, lvl_out = _meter_proc_np(
        mom1_pre, state.peak[..., 1], state.holdcnt[..., 1],
        abs_max(out_block), hold_samples, n, falloff)
    gated = (mom0 > np.float32(DIFF_GATE)) & (mom1 > np.float32(DIFF_GATE))
    ratio = np.where(gated, mom1 / np.maximum(mom0, np.float32(1e-30)), one)
    diff_min = np.where(gated & (ratio < diff_min), ratio, diff_min)
    diff_max = np.where(gated & (ratio > diff_max), ratio, diff_max)
    new_state = MeterState(
        momentary=np.stack([mom0, mom1], axis=-1),
        peak=np.stack([peak0, peak1], axis=-1),
        holdcnt=np.stack([hold0, hold1], axis=-1),
        diff=np.stack([diff_min, diff_max], axis=-1),
        reset_delay=reset_delay,
        dly=dly,
    )
    levels = MeterLevels(
        in_cur=lvl_in, in_mom=mom0, in_peak=peak0,
        out_cur=lvl_out, out_mom=mom1, out_peak=peak1,
        diff_cur=ratio, diff_min=diff_min, diff_max=diff_max,
    )
    return new_state, levels


def host_reset_peaks(state: MeterState) -> MeterState:
    """:func:`reset_peaks` on a :func:`host_meter_state`."""
    return dataclasses.replace(
        state,
        peak=np.zeros_like(state.peak),
        diff=np.ones_like(state.diff),
        momentary=np.zeros_like(state.momentary),
    )
