"""WAV file I/O with metadata passthrough.

A copy of ``phaserotate_tpu/io/wav.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy of the host-side (numpy/ctypes) file
layer.  Only these lines differ; ``tests/test_torch_io.py`` holds every
function here to its source.

The host-side audio I/O layer (the role libsndfile plays for the reference
CLI, cli/phase-rotate.cc:33, 541-563): reads/writes RIFF WAVE in PCM
16/24/32 and float32, and round-trips the metadata the reference's
``copy_metadata`` preserves — LIST/INFO strings, ``cue `` markers and the
``bext`` broadcast-info chunk — as opaque or parsed chunks.

Pure-Python implementation (no external audio libraries in the image); a
C++ fast path for bulk PCM conversion lives in native/ (io/native.py).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["WavMetadata", "read_wav", "write_wav", "WavFormatError"]


class WavFormatError(ValueError):
    pass


# LIST/INFO ids <-> human names (the set libsndfile maps to SF_STR_*)
_INFO_IDS = (
    b"INAM", b"IART", b"ICOP", b"ICRD", b"ICMT", b"IGNR", b"IPRD",
    b"ISFT", b"IENG", b"ITRK",
)


@dataclasses.dataclass
class WavMetadata:
    """Carried-through metadata (cli/phase-rotate.cc:541-563 equivalents).

    info: LIST/INFO string table keyed by 4CC (e.g. b"INAM" -> title).
    cues: raw ``cue `` chunk payload (markers), if present.
    bext: raw ``bext`` broadcast-info payload, if present.
    other: any other non-audio chunks worth preserving verbatim.
    """

    info: Dict[bytes, str] = dataclasses.field(default_factory=dict)
    cues: Optional[bytes] = None
    bext: Optional[bytes] = None
    other: List[Tuple[bytes, bytes]] = dataclasses.field(default_factory=list)
    container: str = "RIFF/WAVE"  # set by the reader (AIFF sets FORM/...)


def _pcm_to_float(raw: bytes, bits: int, fmt: int) -> np.ndarray:
    if fmt == 3:  # IEEE float
        if bits == 32:
            return np.frombuffer(raw, "<f4").astype(np.float32)
        if bits == 64:
            return np.frombuffer(raw, "<f8").astype(np.float32)
        raise WavFormatError(f"unsupported float width {bits}")
    if fmt != 1:
        raise WavFormatError(f"unsupported wFormatTag {fmt}")
    if bits == 16:
        from . import native

        if native.available():
            return native.pcm16_to_f32(np.frombuffer(raw, "<i2"))
        return (np.frombuffer(raw, "<i2").astype(np.float32)) / 32768.0
    if bits == 24:
        from . import native

        return native.pcm24_to_f32(np.frombuffer(raw, np.uint8))
    if bits == 32:
        return np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    if bits == 8:
        return (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    raise WavFormatError(f"unsupported PCM width {bits}")


def _float_to_pcm(x: np.ndarray, bits: int, fmt: int) -> bytes:
    if fmt == 3:
        return x.astype("<f4").tobytes()
    x = np.clip(x, -1.0, 1.0 - 2.0 ** -(bits - 1))
    if bits == 16:
        return (np.round(x * 32768.0).astype("<i2")).tobytes()
    if bits == 24:
        v = np.round(x * 8388608.0).astype(np.int32)
        v = np.clip(v, -8388608, 8388607)
        out = np.empty((len(v), 3), np.uint8)
        out[:, 0] = v & 0xFF
        out[:, 1] = (v >> 8) & 0xFF
        out[:, 2] = (v >> 16) & 0xFF
        return out.tobytes()
    if bits == 32:
        v = np.round(x * 2147483648.0)
        v = np.clip(v, -2147483648, 2147483647)
        return v.astype("<i4").tobytes()
    raise WavFormatError(f"unsupported PCM width {bits}")


def _parse_info_list(payload: bytes) -> Dict[bytes, str]:
    info: Dict[bytes, str] = {}
    pos = 0
    while pos + 8 <= len(payload):
        cid = payload[pos : pos + 4]
        (size,) = struct.unpack_from("<I", payload, pos + 4)
        data = payload[pos + 8 : pos + 8 + size]
        info[cid] = data.rstrip(b"\x00").decode("utf-8", "replace")
        pos += 8 + size + (size & 1)
    return info


def _info_list_body(meta: "WavMetadata") -> bytes:
    """RIFF INFO subchunk stream (shared by the WAV, W64, and RF64
    writers)."""
    body = b""
    for cid, text in meta.info.items():
        t = text.encode("utf-8") + b"\x00"
        if len(t) & 1:
            t += b"\x00"
        body += cid + struct.pack("<I", len(t)) + t
    return body


def _read_wav_chunks(path: str):
    """Walk the RIFF chunks -> (wformat, bits, channels, rate, data,
    meta) — the shared front half of the float and raw-PCM readers."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 12 or blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise WavFormatError(f"{path}: not a RIFF/WAVE file")

    meta = WavMetadata()
    fmt = None
    data = None
    pos = 12
    while pos + 8 <= len(blob):
        cid = blob[pos : pos + 4]
        (size,) = struct.unpack_from("<I", blob, pos + 4)
        if pos + 8 + size > len(blob):
            # a truncated chunk must be an error, not silently-short audio
            # (libsndfile reports the header frame count; round-1 advisor)
            raise WavFormatError(
                f"{path}: truncated {cid!r} chunk — header declares "
                f"{size} bytes, file has {len(blob) - pos - 8}"
            )
        payload = blob[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", payload, 0)
            if fmt[0] == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                sub = payload[24:26]
                fmt = (struct.unpack("<H", sub)[0],) + fmt[1:]
        elif cid == b"data":
            data = payload
        elif cid == b"LIST" and payload[:4] == b"INFO":
            meta.info.update(_parse_info_list(payload[4:]))
        elif cid == b"cue ":
            meta.cues = payload
        elif cid == b"bext":
            meta.bext = payload
        elif cid not in (b"fact", b"PEAK", b"junk", b"JUNK", b"pad "):
            meta.other.append((cid, payload))
        pos += 8 + size + (size & 1)

    if fmt is None or data is None:
        raise WavFormatError(f"{path}: missing fmt/data chunk")
    wformat, channels, rate, _, _, bits = fmt
    if channels < 1 or rate < 1:
        raise WavFormatError(
            f"{path}: bad fmt chunk ({channels} channels @ {rate} Hz)")
    return wformat, bits, channels, rate, data, meta


def read_wav(path: str) -> Tuple[np.ndarray, int, WavMetadata]:
    """Read a WAV file.

    Returns ``(audio, rate, metadata)`` where audio is (channels, n)
    float32 in [-1, 1] (libsndfile's normalization conventions).
    """
    wformat, bits, channels, rate, data, meta = _read_wav_chunks(path)
    flat = _pcm_to_float(data, bits, wformat)
    n = len(flat) // channels
    audio = flat[: n * channels].reshape(n, channels).T.copy()
    return audio, rate, meta


def read_wav_pcm16(path: str) -> Tuple[np.ndarray, int, WavMetadata]:
    """Read a 16-bit PCM WAV without float conversion.

    Returns ``((channels, n) int16, rate, metadata)`` — the raw-PCM
    ingest path for device-side dequantization (sweep_peaks_aux_pcm16).
    Raises WavFormatError for any other sample format; callers fall
    back to :func:`read_wav` + quantize.
    """
    wformat, bits, channels, rate, data, meta = _read_wav_chunks(path)
    if wformat != 1 or bits != 16:
        raise WavFormatError(
            f"{path}: not 16-bit integer PCM (fmt {wformat}, {bits} bit)")
    flat = np.frombuffer(data, "<i2")
    n = len(flat) // channels
    audio = flat[: n * channels].reshape(n, channels).T.copy()
    return audio, rate, meta


def write_wav(
    path: str,
    audio: np.ndarray,
    rate: int,
    meta: Optional[WavMetadata] = None,
    bits: int = 32,
    float_format: bool = True,
) -> None:
    """Write a WAV file; ``audio`` is (channels, n) or (n,) float32.

    Defaults to float32 samples (no quantization of the rotated output);
    pass ``float_format=False`` with bits in {16, 24, 32} for PCM.
    Metadata chunks (INFO strings, cues, bext) are written back like the
    reference CLI's copy_metadata does.
    """
    x = np.atleast_2d(np.asarray(audio, np.float32))
    channels, n = x.shape
    interleaved = x.T.reshape(-1)
    fmt_tag = 3 if float_format else 1
    if float_format:
        bits = 32
    payload = _float_to_pcm(interleaved, bits, fmt_tag)

    chunks: List[bytes] = []
    block_align = channels * bits // 8
    fmt_chunk = struct.pack(
        "<HHIIHH", fmt_tag, channels, rate, rate * block_align,
        block_align, bits)
    chunks.append(b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk)
    if fmt_tag == 3:
        chunks.append(b"fact" + struct.pack("<II", 4, n))

    if meta is not None:
        if meta.bext is not None:
            b = meta.bext
            chunks.append(
                b"bext" + struct.pack("<I", len(b)) + b
                + (b"\x00" if len(b) & 1 else b""))
        if meta.cues is not None:
            c = meta.cues
            chunks.append(
                b"cue " + struct.pack("<I", len(c)) + c
                + (b"\x00" if len(c) & 1 else b""))
        if meta.info:
            body = b"INFO" + _info_list_body(meta)
            chunks.append(b"LIST" + struct.pack("<I", len(body)) + body)

    chunks.append(
        b"data" + struct.pack("<I", len(payload)) + payload
        + (b"\x00" if len(payload) & 1 else b""))

    body = b"WAVE" + b"".join(chunks)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
