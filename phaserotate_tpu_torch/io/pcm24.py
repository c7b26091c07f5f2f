"""Exact 24-bit PCM WAV reads for the fleet (the port's own module).

The copied readers of this package give no exact path for 24-bit files:
``read_audio_pcm16`` reads them through the float reader and rounds the
samples to int16.  Here a RIFF/WAVE file's chunk headers are walked
without reading the audio, and the ``data`` payload of a 24-bit integer
PCM file (format 1, or ``WAVE_FORMAT_EXTENSIBLE`` with the PCM subformat)
is read straight into a caller's buffer with ``readinto``, as the file
holds it: interleaved, three bytes a sample, little-endian.  The card
widens it to float32 (``kernels/pcm24.py``).

The chunk walk follows ``io/wav.py``'s ``_read_wav_chunks``: the same
frame count, and ``WavFormatError`` wherever that reader raises it (a
truncated chunk, a missing ``fmt `` or ``data`` chunk, a bad ``fmt ``).
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple

from .wav import WavFormatError

__all__ = ["WavHeader", "is_pcm24", "read_header", "read_pcm24_into"]


class WavHeader(NamedTuple):
    """What a RIFF/WAVE file's chunk headers say of its audio."""

    wformat: int  # wFormatTag; the subformat's for WAVE_FORMAT_EXTENSIBLE
    bits: int
    channels: int
    rate: int
    frames: int  # whole frames in the data chunk
    data_offset: int
    data_bytes: int


def read_header(path: str) -> WavHeader:
    """Walk the chunk headers of the RIFF/WAVE file at ``path``; reads
    the ``fmt `` chunk and nothing of the audio."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise WavFormatError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        pos = 12
        while pos + 8 <= size:
            f.seek(pos)
            cid, n = struct.unpack("<4sI", f.read(8))
            if pos + 8 + n > size:
                raise WavFormatError(
                    f"{path}: truncated {cid!r} chunk — header declares "
                    f"{n} bytes, file has {size - pos - 8}")
            if cid == b"fmt ":
                payload = f.read(min(n, 40))
                if len(payload) < 16:
                    raise WavFormatError(f"{path}: short fmt chunk")
                fmt = struct.unpack_from("<HHIIHH", payload, 0)
                if fmt[0] == 0xFFFE and n >= 40:  # WAVE_FORMAT_EXTENSIBLE
                    fmt = struct.unpack_from("<H", payload, 24) + fmt[1:]
            elif cid == b"data":
                data = (pos + 8, n)
            pos += 8 + n + (n & 1)
    if fmt is None or data is None:
        raise WavFormatError(f"{path}: missing fmt/data chunk")
    wformat, channels, rate, _, _, bits = fmt
    if channels < 1 or rate < 1:
        raise WavFormatError(
            f"{path}: bad fmt chunk ({channels} channels @ {rate} Hz)")
    frames = data[1] // (channels * max(1, bits // 8))
    return WavHeader(wformat, bits, channels, rate, frames, *data)


def is_pcm24(header: WavHeader) -> bool:
    """True for 24-bit integer PCM."""
    return header.wformat == 1 and header.bits == 24


def read_pcm24_into(path: str, out) -> int:
    """Read the whole frames of a 24-bit PCM WAV's ``data`` chunk into the
    start of ``out`` (a writable contiguous byte buffer, such as a row of
    a ``uint8`` array) as the file holds them; returns the frame count.
    The rest of ``out`` is left as it is.

    Raises ``WavFormatError`` for any file that is not 24-bit integer PCM
    WAV, or whose data ends early, and ``ValueError`` where ``out`` is too
    small."""
    h = read_header(path)
    if not is_pcm24(h):
        raise WavFormatError(f"{path}: not 24-bit integer PCM (fmt "
                             f"{h.wformat}, {h.bits} bit)")
    want = h.frames * h.channels * 3
    view = memoryview(out).cast("B")
    if want > len(view):
        raise ValueError(f"{path}: {want} bytes of samples do not fit a "
                         f"buffer of {len(view)}")
    with open(path, "rb", buffering=0) as f:
        f.seek(h.data_offset)
        done = 0
        while done < want:
            got = f.readinto(view[done:want])
            if not got:
                raise WavFormatError(f"{path}: data ends after {done} of "
                                     f"{want} bytes")
            done += got
    return h.frames
