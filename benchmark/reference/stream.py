"""The plugin's streaming engine and meters, as the daemon serves them.

Output (src/phaserotate.c:615-725): the engine runs in ``parsiz``-sample
frames.  Frame ``k`` mixes ``cos(2 pi r) x[kP + i - firlen/2] + sin(2 pi r)
h[kP + i]`` with ``h = fir * x`` (the ``firlen``-tap Hilbert FIR) and
``r = a_k + da_k i``, the angle ramp of src/phaserotate.c:673-709 in
negated turns.  The host emits frame ``k`` one frame after it completes,
and a daemon that pipelines ``D`` frames emits it ``D`` frames later
still, so the served sample ``p`` is frame ``p // P - 1 - D``'s sample
``p % P`` and the reported latency is ``P + firlen/2 + D P``.  Frame ``k``
takes the angle of the host block in which it completes.

Meters (src/phaserotate.c:451-509, 573-611, 728-771, 832-838): per host
block and channel, an input meter on the input delayed by the latency and
an output meter on the served block (momentary: rise at once, hold 0.5 s,
fall 15 dB/s; peak hold), and the gain ratio of the two momentaries with a
delayed reset after an angle change; float32, as the plugin keeps them.
"""

from __future__ import annotations

import numpy as np
import torch

from .dsp import angle_step, degrees_to_turns, hilbert_fir, plugin_geometry

LEVEL_FIELDS = ("in_cur", "in_mom", "in_peak", "out_cur", "out_mom",
                "out_peak", "diff_cur", "diff_min", "diff_max")


def frame_angles(targets_deg: np.ndarray, n_frames: int, block: int,
                 parsiz: int):
    """Per frame and channel: (angle, slope) in turns, float32.

    ``targets_deg`` is (blocks, C): the angle port of each host block."""
    C = targets_deg.shape[1]
    ang = np.zeros((C, n_frames), np.float32)
    slope = np.zeros((C, n_frames), np.float32)
    for c in range(C):
        a = np.float32(0.0)
        for k in range(n_frames):
            t = degrees_to_turns(targets_deg[((k + 1) * parsiz - 1) // block,
                                             c])
            nxt, da, _ = angle_step(a, t, parsiz)
            ang[c, k], slope[c, k] = a, da
            a = nxt
    return ang, slope


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def served(x: np.ndarray, targets_deg: np.ndarray, block: int, rate: float,
           depth: int, precision: str = "float64") -> np.ndarray:
    """The served stream for input ``x`` (C, N), N a whole number of host
    blocks of ``block`` samples; ``precision`` ``"bfloat16"`` rounds the
    samples, the Hilbert signal and the output to bfloat16 (the control)."""
    g = plugin_geometry(rate)
    P, firlat = g["parsiz"], g["firlat"]
    C, N = x.shape
    n_frames = N // P
    fir = hilbert_fir(g["firlen"]).astype(np.float64)
    xd = x.astype(np.float64)
    if precision == "bfloat16":
        xd = _bf16(x).astype(np.float64)
        fir = _bf16(fir).astype(np.float64)
    size = 1 << (N + len(fir)).bit_length()
    h = np.fft.irfft(np.fft.rfft(xd, size) * np.fft.rfft(fir, size),
                     size)[:, :N]
    if precision == "bfloat16":
        h = _bf16(h).astype(np.float64)
    ang, slope = frame_angles(targets_deg, n_frames, block, P)
    i = np.arange(P, dtype=np.float64)
    r = (ang.astype(np.float64)[..., None]
         + slope.astype(np.float64)[..., None] * i).reshape(C, -1)
    dry = np.zeros_like(xd[:, : n_frames * P])
    dry[:, firlat:] = xd[:, : n_frames * P - firlat]
    mix = (np.cos(2 * np.pi * r) * dry
           + np.sin(2 * np.pi * r) * h[:, : n_frames * P])
    if precision == "bfloat16":
        mix = _bf16(mix).astype(np.float64)
    out = np.zeros((C, N), np.float64)
    lag = (1 + depth) * P
    out[:, lag:] = mix[:, : N - lag]
    return out


def _falloff(rate: float, n: int) -> np.float32:
    expo = np.float32(-0.05 * 15.0) * (np.float32(n) / np.float32(rate))
    return np.float32(np.power(np.float32(10.0), np.float32(expo)))


def _ballistics(mom, peak, hold, new_peak, hold_samples, n, falloff):
    new_peak = np.where(np.isfinite(new_peak), new_peak, np.float32(0.0))
    peak = np.maximum(peak, new_peak)
    rises = new_peak > mom
    holding = hold > 0
    mom2 = np.where(rises, new_peak, np.where(
        holding, mom, mom * falloff + np.float32(1e-20))).astype(np.float32)
    hold2 = np.where(rises, np.int32(hold_samples),
                     np.where(holding, hold - np.int32(n), hold))
    return mom2, peak.astype(np.float32), hold2.astype(np.int32), new_peak


def levels(x: np.ndarray, y: np.ndarray, targets_deg: np.ndarray,
           block: int, rate: float, latency: int) -> np.ndarray:
    """(blocks, C, 9) meter levels for input ``x`` and served output ``y``
    (C, N) in host blocks of ``block`` samples."""
    g = plugin_geometry(rate)
    P = g["parsiz"]
    C, N = x.shape
    x = x.astype(np.float32)
    y = y.astype(np.float32)
    hold_samples = int(0.5 * rate + 0.5)
    mom = np.zeros((C, 2), np.float32)
    peak = np.zeros((C, 2), np.float32)
    hold = np.zeros((C, 2), np.int32)
    diff = np.ones((C, 2), np.float32)
    reset = np.full(C, latency, np.int32)
    dly = np.zeros((C, latency), np.float32)
    shadow = np.zeros(C, np.float32)
    offset = 0
    out = []
    one, zero = np.float32(1.0), np.float32(0.0)
    for j in range(N // block):
        xb = x[:, j * block : (j + 1) * block]
        yb = y[:, j * block : (j + 1) * block]
        n = xb.shape[1]
        falloff = _falloff(rate, n)
        tgt = degrees_to_turns(targets_deg[j])
        changed = tgt != shadow
        for _ in range((offset + n) // P):
            shadow = np.array([angle_step(shadow[c], tgt[c], P)[0]
                               for c in range(C)], np.float32)
        offset = (offset + n) % P
        comb = np.concatenate([dly, xb], axis=1)
        delayed, dly = comb[:, :n], comb[:, n:]
        m0, p0, h0, l_in = _ballistics(mom[:, 0], peak[:, 0], hold[:, 0],
                                       np.abs(delayed).max(axis=1),
                                       hold_samples, n, falloff)
        resetting = reset > 0
        dmin = np.where(resetting, one, diff[:, 0])
        dmax = np.where(resetting, one, diff[:, 1])
        m1_pre = np.where(resetting, zero, mom[:, 1])
        reset = np.where(resetting, reset - np.int32(n), reset)
        reset = np.where(changed, np.int32(latency + n), reset)
        m1, p1, h1, l_out = _ballistics(m1_pre, peak[:, 1], hold[:, 1],
                                        np.abs(yb).max(axis=1),
                                        hold_samples, n, falloff)
        gated = (m0 > np.float32(0.001)) & (m1 > np.float32(0.001))
        ratio = np.where(gated, m1 / np.maximum(m0, np.float32(1e-30)),
                         one).astype(np.float32)
        dmin = np.where(gated & (ratio < dmin), ratio, dmin)
        dmax = np.where(gated & (ratio > dmax), ratio, dmax)
        mom = np.stack([m0, m1], axis=1)
        peak = np.stack([p0, p1], axis=1)
        hold = np.stack([h0, h1], axis=1)
        diff = np.stack([dmin, dmax], axis=1).astype(np.float32)
        out.append(np.stack([l_in, m0, p0, l_out, m1, p1, ratio, dmin,
                             dmax], axis=1))
    return np.asarray(out, np.float32)
