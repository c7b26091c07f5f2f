"""Audio made from the seed: music-like stereo on the card (the analysis
cells) or on the host (each serving client), the song lengths of a
configuration, the sample format a configuration states, and a PCM WAV
writer of the benchmark's own.

The signal is an asymmetric three-partial tone under a slow envelope plus
band-limited noise, so the peak-versus-angle table is far from flat.  An
analysis master is normalized to a peak level drawn from the
configuration's range, as released masters are (see ``configs/``)."""

from __future__ import annotations

import struct
from statistics import NormalDist
from typing import List

import numpy as np

from .spec import SpecError

# the sample depths each container is written at (a configuration's
# ``container`` and ``bits``)
FORMATS = {"wav": (16, 24)}


def sample_bits(config: dict) -> int:
    """The bits a sample of the configuration's masters: its ``bits`` (16
    where it states none) in its ``container`` (``"wav"`` where it states
    none).  A format the benchmark cannot write raises ``SpecError``."""
    name = config.get("name", "?")
    container = config.get("container", "wav")
    if container not in FORMATS:
        raise SpecError(f"config {name!r}: container {container!r} is not "
                        f"one the benchmark writes ({sorted(FORMATS)})")
    bits = config.get("bits", 16)
    if bits not in FORMATS[container]:
        raise SpecError(f"config {name!r}: bits {bits!r} is not a depth "
                        f"the benchmark writes {container} at "
                        f"{FORMATS[container]}")
    return bits


def song_seconds(count: int, mean: float, sigma: float) -> List[float]:
    """``count`` song lengths: the midpoint quantiles of a log-normal of
    the given ``mean`` and log-spread ``sigma``.  Every seed gets this same
    set, in its own order."""
    nd = NormalDist()
    median = mean * np.exp(-0.5 * sigma * sigma)
    return [float(median * np.exp(sigma * nd.inv_cdf((i + 0.5) / count)))
            for i in range(count)]


def _seed(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([seed & 0xFFFFFFFFFFFF, *salt])


def music_device(seed: int, index: int, channels: int, n: int, rate: int,
                 peak_dbfs, device, bits: int = 16):
    """(channels, n) float32 on ``device``, quantized to the ``bits`` grid
    (steps of 2^-(bits-1)); also the integer samples: int16 at 16 bits,
    int32 at 24.  The master peaks at a level drawn from the seed inside
    ``peak_dbfs`` (lowest, highest), in dBFS.  The music does not depend
    on ``bits``, only its rounding."""
    import torch

    rng = _seed(seed, 1, index)
    peak = 10.0 ** (rng.uniform(*peak_dbfs) / 20.0)
    f0 = torch.tensor(rng.uniform(200.0, 1500.0, channels), device=device,
                      dtype=torch.float64)
    ph = torch.tensor(rng.uniform(0.0, 6.28, (channels, 3)), device=device,
                      dtype=torch.float64)
    t = torch.arange(n, device=device, dtype=torch.float64) / rate
    w = 2 * np.pi * f0[:, None] * t[None]
    x = (0.6 * torch.sin(w + ph[:, :1]) + 0.35 * torch.sin(2 * w + ph[:, 1:2])
         + 0.15 * torch.sin(3 * w + ph[:, 2:]))
    del w
    env = 0.55 + 0.45 * torch.sin(2 * np.pi * 0.3 * t + rng.uniform(0, 6)) ** 2
    g = torch.Generator(device=device).manual_seed(
        int(rng.integers(0, 2 ** 62)))
    x = 0.5 * env * x
    noise = torch.randn(channels, n + 15, generator=g, device=device,
                        dtype=torch.float64)
    for k, h in enumerate(np.hanning(16) / 8.0):  # band-limited, as the host's
        x += (0.08 * h) * noise[:, k : k + n]
    del noise
    x *= peak / x.abs().max()
    full = 1 << (bits - 1)
    q = torch.clamp(torch.round(x * float(full)), -full, full - 1).to(
        torch.int16 if bits == 16 else torch.int32)
    return q.to(torch.float32) * (1.0 / full), q


def music_host(seed: int, index: int, channels: int, n: int,
               rate: int) -> np.ndarray:
    """(channels, n) float32 on the host, for one serving session."""
    rng = _seed(seed, 2, index)
    t = np.arange(n, dtype=np.float64) / rate
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 0.07 * t + rng.uniform(0, 6)) ** 2
    out = np.empty((channels, n), np.float32)
    for c in range(channels):
        f0 = 997.0 * rng.uniform(0.8, 1.25)
        x = (0.6 * np.sin(2 * np.pi * f0 * t + c)
             + 0.35 * np.sin(2 * np.pi * 2 * f0 * t + 0.7 + c)
             + 0.15 * np.sin(2 * np.pi * 3 * f0 * t + 1.9))
        noise = rng.standard_normal(n + 15)
        noise = np.convolve(noise, np.hanning(16) / 8.0, mode="valid")[:n]
        out[c] = 0.5 * env * x + 0.08 * noise
    return out


# the low three bytes of a little-endian int32
_LOW3 = np.dtype({"names": ["s"], "formats": ["V3"], "offsets": [0],
                  "itemsize": 4})


def write_wav(path: str, pcm: np.ndarray, rate: int, bits: int = 16) -> None:
    """A canonical 44-byte-header PCM WAV (format tag 1) of (channels, n)
    integer samples at ``bits`` 16 (int16) or 24 (the low three bytes of
    each int32, little-endian, packed)."""
    ch = pcm.shape[0]
    width = bits // 8
    if bits == 16:
        data = np.ascontiguousarray(pcm.T, "<i2")
    else:  # one 3-byte item a sample, copied whole (bytewise is 2x slower)
        data = np.ascontiguousarray(np.ascontiguousarray(pcm.T, "<i4").view(
            _LOW3)["s"])
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + data.nbytes) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, ch, rate,
                                      rate * ch * width, ch * width, bits))
        f.write(b"data" + struct.pack("<I", data.nbytes))
        f.write(data.tobytes())
