"""16-bit PCM WAV reads straight into a caller's rows (the port's own
module).

The copied reader ``read_wav_pcm16`` (``io/wav.py``) reads the whole file
into one bytes object, copies the samples out de-interleaved, and the
fleet then copies them again into its staging slot: three passes over the
samples and two allocations the size of the file, each file.  Here the
chunk headers are walked without reading the audio (``io/pcm24.py``'s
``read_header``), and the ``data`` payload of a 16-bit integer PCM file
(format 1, or ``WAVE_FORMAT_EXTENSIBLE`` with the PCM subformat) is read
with ``readinto`` a piece at a time into a buffer that each thread keeps,
each piece de-interleaved once into the caller's ``(channels, frames)``
rows.  The samples are those ``read_wav_pcm16`` gives, and
``WavFormatError`` is raised wherever it raises it.
"""

from __future__ import annotations

import threading

import numpy as np

from .pcm24 import read_header
from .wav import WavFormatError

__all__ = ["read_pcm16_into"]

# bytes of the data chunk read at a time
_PIECE_BYTES = 1 << 20
# each thread's piece buffer, reused from file to file
_local = threading.local()


def _piece_buffer() -> np.ndarray:
    buf = getattr(_local, "buf", None)
    if buf is None:
        buf = _local.buf = np.empty(_PIECE_BYTES, np.uint8)
    return buf


def read_pcm16_into(path: str, rows: np.ndarray) -> int:
    """Read a 16-bit PCM WAV's samples into ``rows`` (channels, frames)
    int16, channel c's samples into row c, from its start; returns the
    frames written: the file's whole frames, or as many as ``rows`` holds.
    The rest of ``rows`` is left as it is.  No buffer the size of the file
    is made: the data is read a piece of ``_PIECE_BYTES`` at a time.

    Raises ``WavFormatError`` for any file that is not 16-bit integer PCM
    WAV, or whose data ends early, and ``ValueError`` where ``rows`` is not
    int16 of the file's channels."""
    h = read_header(path)
    if h.wformat != 1 or h.bits != 16:
        raise WavFormatError(f"{path}: not 16-bit integer PCM (fmt "
                             f"{h.wformat}, {h.bits} bit)")
    channels = h.channels
    if rows.dtype != np.int16 or rows.ndim != 2 or rows.shape[0] != channels:
        raise ValueError(f"{path}: {channels} channels of int16 do not fit "
                         f"rows of {rows.dtype} {rows.shape}")
    frames = min(h.frames, rows.shape[1])
    frame_bytes = 2 * channels
    buf = _piece_buffer()
    step = len(buf) // frame_bytes  # a frame is at most 128 KiB
    view = memoryview(buf)
    with open(path, "rb", buffering=0) as f:
        f.seek(h.data_offset)
        done = 0
        while done < frames:
            k = min(step, frames - done)
            want = k * frame_bytes
            got = 0
            while got < want:
                m = f.readinto(view[got:want])
                if not m:
                    raise WavFormatError(
                        f"{path}: data ends after "
                        f"{done * frame_bytes + got} of "
                        f"{frames * frame_bytes} bytes")
                got += m
            piece = buf[:want].view("<i2").reshape(k, channels)
            rows[:, done : done + k] = piece.T
            done += k
    return frames
