"""The FIR, the angle conventions and the geometries, from the reference.

* Hilbert FIR (src/phaserotate.c:374-401, cli/phase-rotate.cc:144-164):
  ``fir[n] = irfft(j * (-1)^k, n=L)[n] * 0.5 * (1 - cos(2 pi n / L))``,
  designed in float64 and rounded to float32.
* Angles: the plugin stores ``degrees / -360`` turns clamped to
  [-0.5, 0.5] (src/phaserotate.c:564-571); the CLI's table holds
  ``cos``/``sin`` of ``-pi a / 360`` for a = 0..359 half-degree units,
  float64 rounded to float32 (cli/phase-rotate.cc:44-55).
* Geometries: the CLI's block is rate/8 rounded up to a power of two in
  [1024, 32768] (cli/phase-rotate.cc:749-755), its FIR ``blksiz`` taps
  with group delay ``blksiz/2``; the plugin's fftlen is 512 / 1024 / 2048
  below 64 / 128 kHz / above, its FIR 3072 / 4096 / 8192 taps
  (src/phaserotate.c:278-297).
"""

from __future__ import annotations

import numpy as np

SUBSAMPLE = 2
MAXSAMPLE = 180 * SUBSAMPLE


def hilbert_fir(length: int) -> np.ndarray:
    """The Hann-windowed Hilbert FIR of ``length`` taps, float32."""
    k = np.arange(length // 2 + 1)
    spec = 1j * np.where(k & 1, -1.0, 1.0)
    fir = np.fft.irfft(spec, n=length)
    n = np.arange(length)
    return (fir * 0.5 * (1.0 - np.cos(2.0 * np.pi * n / length))
            ).astype(np.float32)


def cos_sin_table() -> np.ndarray:
    """(2, MAXSAMPLE) float32 [cos; sin] of every half-degree unit."""
    a = np.arange(MAXSAMPLE) * (2.0 * np.pi / SUBSAMPLE / -360.0)
    return np.stack([np.cos(a), np.sin(a)]).astype(np.float32)


def cli_blksiz(rate: int, requested: int = 0) -> int:
    blksiz = requested if 0 < requested <= 32768 else rate // 8
    p = 1
    while p < blksiz:
        p <<= 1
    return min(32768, max(1024, p))


def plugin_geometry(rate: float) -> dict:
    fftlen, firlen = ((512, 3072) if rate < 64000 else
                      (1024, 4096) if rate < 128000 else (2048, 8192))
    parsiz = fftlen // 2
    return dict(fftlen=fftlen, firlen=firlen, parsiz=parsiz,
                firlat=firlen // 2, latency=parsiz + firlen // 2)


def degrees_to_turns(degrees) -> np.ndarray:
    t = np.asarray(degrees, np.float32) / np.float32(-360.0)
    return np.clip(t, np.float32(-0.5), np.float32(0.5)).astype(np.float32)


def angle_step(angle, target, parsiz: int):
    """One block of the plugin's angle ramp (src/phaserotate.c:673-709),
    float32: returns (next angle, per-sample slope, ramping)."""
    angle = np.float32(angle)
    target = np.float32(target)
    da = np.float32(target - angle)
    if abs(da) > np.float32(0.5):
        da = np.float32(da - np.sign(da))
    da = np.float32(da * np.float32(1.0 / parsiz))
    th = np.float32(parsiz * 1e-6)
    clipped = abs(da) > th
    da = np.float32(min(max(da, -th), th))
    if target == angle:
        return angle, np.float32(0.0), False
    nxt = np.float32(angle + da * np.float32(parsiz)) if clipped else target
    return nxt, da, True
