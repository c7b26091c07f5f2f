"""Optional ALSA playback output (ctypes, no build-time dependency).

A copy of ``phaserotate_tpu/io/playback.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy.  Only these lines differ;
``tests/test_torch_io.py`` holds the rest to its source.

The reference's standalone form is a JACK client (Makefile:250-257);
this framework's hosts are offline-first, but ``hostapp --play`` can
monitor through a real sound device when ALSA is present.  The binding
loads ``libasound.so.2`` at runtime — environments without a sound
stack (CI, TPU pods) simply get ``open_output() -> None`` and the host
falls back to paced simulation, which the README states explicitly.

Uses the high-level snd_pcm_set_params API (float32-LE interleaved,
soft resample, 100 ms buffer) and snd_pcm_recover for underruns — the
standard minimal-latency-agnostic playback loop.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

__all__ = ["AlsaOutput", "open_output"]

_SND_PCM_STREAM_PLAYBACK = 0
_SND_PCM_FORMAT_FLOAT_LE = 14
_SND_PCM_ACCESS_RW_INTERLEAVED = 3


class AlsaOutput:
    """One playback stream.  ``lib`` is injectable for tests."""

    def __init__(self, rate: int, channels: int, device: str = "default",
                 latency_us: int = 100_000, lib=None):
        self._lib = lib if lib is not None else ctypes.CDLL(
            "libasound.so.2")
        self.rate = int(rate)
        self.channels = int(channels)
        self._pcm = ctypes.c_void_p()
        err = self._lib.snd_pcm_open(
            ctypes.byref(self._pcm), device.encode(),
            _SND_PCM_STREAM_PLAYBACK, 0)
        if err < 0:
            raise OSError(err, f"snd_pcm_open({device!r}) failed")
        err = self._lib.snd_pcm_set_params(
            self._pcm, _SND_PCM_FORMAT_FLOAT_LE,
            _SND_PCM_ACCESS_RW_INTERLEAVED, self.channels, self.rate,
            1, latency_us)
        if err < 0:
            self._lib.snd_pcm_close(self._pcm)
            raise OSError(err, "snd_pcm_set_params failed")

    def write(self, block: np.ndarray) -> None:
        """Play one (channels, n) float32 block (blocking)."""
        x = np.ascontiguousarray(
            np.atleast_2d(np.asarray(block, np.float32)).T.reshape(-1))
        total = len(x) // self.channels
        done = 0
        while done < total:
            chunk = x[done * self.channels :]
            n = self._lib.snd_pcm_writei(
                self._pcm, chunk.ctypes.data_as(ctypes.c_void_p),
                total - done)
            if n < 0:  # underrun or suspend: try to recover the stream
                n = self._lib.snd_pcm_recover(self._pcm, n, 1)
                if n < 0:
                    raise OSError(n, "snd_pcm_writei failed")
                continue
            done += n

    def close(self) -> None:
        if self._pcm:
            self._lib.snd_pcm_drain(self._pcm)
            self._lib.snd_pcm_close(self._pcm)
            self._pcm = ctypes.c_void_p()

    def __enter__(self) -> "AlsaOutput":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_output(rate: int, channels: int,
                device: str = "default") -> Optional[AlsaOutput]:
    """ALSA output, or None when no sound stack is available."""
    try:
        return AlsaOutput(rate, channels, device)
    except OSError:
        return None
