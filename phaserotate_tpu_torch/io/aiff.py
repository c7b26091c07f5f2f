"""AIFF/AIFF-C audio file codec.

A copy of ``phaserotate_tpu/io/aiff.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy of the host-side (numpy/ctypes) file
layer.  Only these lines differ; ``tests/test_torch_io.py`` holds every
function here to its source.

The reference CLI reads any libsndfile format (cli/phase-rotate.cc uses
sf_open); WAV and AIFF cover the interchange formats mastering users
actually feed it.  This is a fresh implementation of the public
IFF/AIFF-1.3 layout: FORM container, COMM (channels, frames, bits, rate
as an 80-bit extended float) and SSND (offset/blocksize + big-endian
PCM); AIFF-C with the ``NONE``/``sowt``/``fl32`` compression types.

Shares the (channels, n) float32 in [-1, 1] conventions and the
:class:`~phaserotate_tpu.io.wav.WavMetadata` carrier of the WAV codec
(NAME/AUTH/ANNO text chunks map to INFO-style entries).
"""

from __future__ import annotations

import math
import struct
from typing import Dict, Optional, Tuple

import numpy as np

from .wav import WavFormatError, WavMetadata

__all__ = ["read_aiff", "read_aiff_pcm16", "write_aiff", "is_aiff"]

# AIFF text chunk ids <-> the WAV INFO ids the rest of the stack uses
_TEXT_MAP = {b"NAME": b"INAM", b"AUTH": b"IART", b"ANNO": b"ICMT",
             b"(c) ": b"ICOP"}
_TEXT_MAP_INV = {v: k for k, v in _TEXT_MAP.items()}


def _read_f80(b: bytes) -> float:
    """80-bit IEEE extended float -> python float (the COMM sample rate).

    Out-of-range exponents (inf/nan encodings, absurd rates) come back
    as ``inf`` so the caller's rate validity check raises WavFormatError
    instead of this helper leaking OverflowError."""
    (se,) = struct.unpack(">H", b[:2])
    sign = -1.0 if se & 0x8000 else 1.0
    exp = se & 0x7FFF
    (mant,) = struct.unpack(">Q", b[2:10])
    if exp == 0 and mant == 0:
        return 0.0
    try:
        return sign * math.ldexp(mant, exp - 16383 - 63)
    except OverflowError:
        return math.inf


def _write_f80(x: float) -> bytes:
    if x <= 0:
        return b"\x00" * 10
    m, e = math.frexp(x)  # x = m * 2**e, m in [0.5, 1)
    exp = e - 1 + 16383
    mant = int(m * (1 << 64))
    return struct.pack(">HQ", exp, mant)


def is_aiff(blob: bytes) -> bool:
    return (len(blob) >= 12 and blob[:4] == b"FORM"
            and blob[8:12] in (b"AIFF", b"AIFC"))


def _parse_aiff(path: str):
    """FORM walk shared by the float and raw-PCM16 readers: returns
    ``(channels, frames, bits, rate, compression, ssnd, meta)``.  Every
    malformation raises :class:`WavFormatError`."""
    with open(path, "rb") as f:
        blob = f.read()
    if not is_aiff(blob):
        raise WavFormatError(f"{path}: not a FORM/AIFF file")
    is_aifc = blob[8:12] == b"AIFC"

    meta = WavMetadata()
    meta.container = "FORM/AIFC" if is_aifc else "FORM/AIFF"
    comm = None
    ssnd = None
    compression = b"NONE"
    pos = 12
    while pos + 8 <= len(blob):
        cid = blob[pos : pos + 4]
        (size,) = struct.unpack_from(">I", blob, pos + 4)
        if pos + 8 + size > len(blob):
            raise WavFormatError(
                f"{path}: truncated {cid!r} chunk — header declares "
                f"{size} bytes, file has {len(blob) - pos - 8}")
        payload = blob[pos + 8 : pos + 8 + size]
        if cid == b"COMM":
            if size < 18:
                raise WavFormatError(f"{path}: short COMM chunk ({size})")
            channels, frames = struct.unpack_from(">hI", payload, 0)
            (bits,) = struct.unpack_from(">h", payload, 6)
            rate = _read_f80(payload[8:18])
            if is_aifc and size >= 22:
                compression = payload[18:22]
            comm = (channels, frames, bits, rate)
        elif cid == b"SSND":
            if size < 8:
                raise WavFormatError(f"{path}: short SSND chunk ({size})")
            offset, _blocksize = struct.unpack_from(">II", payload, 0)
            if 8 + offset > len(payload):
                raise WavFormatError(f"{path}: bad SSND offset {offset}")
            ssnd = payload[8 + offset :]
        elif cid in _TEXT_MAP:
            meta.info[_TEXT_MAP[cid]] = payload.rstrip(b"\x00").decode(
                "utf-8", "replace")
        pos += 8 + size + (size & 1)

    if comm is None or ssnd is None:
        raise WavFormatError(f"{path}: missing COMM/SSND chunk")
    channels, frames, bits, rate = comm
    if channels < 1 or not math.isfinite(rate) or not (
            1.0 <= rate < 2**31):
        raise WavFormatError(f"{path}: bad COMM ({channels} ch @ {rate})")
    return channels, frames, bits, rate, compression, ssnd, meta


def read_aiff_pcm16(path: str) -> Tuple[np.ndarray, int, WavMetadata]:
    """Read a 16-bit PCM AIFF/AIFF-C without float conversion.

    Returns ``((channels, n) int16, rate, metadata)`` — the raw-PCM
    fleet ingest path, like read_wav_pcm16/read_au_pcm16: a header
    parse plus one byteswap (``NONE`` big-endian) or a plain view
    (``sowt``).  Raises WavFormatError for any other encoding; callers
    fall back to :func:`read_aiff` + quantize.
    """
    channels, frames, bits, rate, compression, ssnd, meta = \
        _parse_aiff(path)
    if bits != 16 or compression not in (b"NONE", b"sowt"):
        raise WavFormatError(
            f"{path}: not 16-bit PCM AIFF ({bits}-bit "
            f"{compression!r})")
    dt = "<i2" if compression == b"sowt" else ">i2"
    flat = np.frombuffer(ssnd[: (len(ssnd) // 2) * 2],
                         dt).astype(np.int16)
    if len(flat) // channels < frames:
        raise WavFormatError(
            f"{path}: SSND holds {len(flat) // channels} frames, COMM "
            f"declares {frames}")
    audio = flat[: frames * channels].reshape(frames, channels).T.copy()
    return audio, int(round(rate)), meta


def read_aiff(path: str) -> Tuple[np.ndarray, int, WavMetadata]:
    """Read an AIFF/AIFF-C file -> ((channels, n) float32, rate, meta).

    Every malformation raises :class:`WavFormatError` (never a bare
    struct/ValueError), so callers handle WAV and AIFF identically.
    """
    channels, frames, bits, rate, compression, ssnd, meta = \
        _parse_aiff(path)

    if compression in (b"NONE", b"sowt"):
        little = compression == b"sowt"
        width = bits // 8
        ssnd = ssnd[: (len(ssnd) // max(width, 1)) * max(width, 1)]
        if bits == 16:
            dt = "<i2" if little else ">i2"
            flat = np.frombuffer(ssnd, dt).astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(ssnd, np.uint8)
            raw = raw[: (len(raw) // 3) * 3].reshape(-1, 3)
            if little:
                v = (raw[:, 0].astype(np.int32)
                     | (raw[:, 1].astype(np.int32) << 8)
                     | (raw[:, 2].astype(np.int32) << 16))
            else:
                v = ((raw[:, 0].astype(np.int32) << 16)
                     | (raw[:, 1].astype(np.int32) << 8)
                     | raw[:, 2].astype(np.int32))
            v = np.where(v & 0x800000, v - 0x1000000, v)
            flat = v.astype(np.float32) / 8388608.0
        elif bits == 32:
            dt = "<i4" if little else ">i4"
            flat = (np.frombuffer(ssnd, dt).astype(np.float64)
                    / 2147483648.0).astype(np.float32)
        else:
            raise WavFormatError(f"{path}: unsupported PCM width {bits}")
    elif compression in (b"fl32", b"FL32"):
        flat = np.frombuffer(ssnd[: (len(ssnd) // 4) * 4],
                             ">f4").astype(np.float32)
    else:
        raise WavFormatError(
            f"{path}: unsupported AIFF-C compression {compression!r}")

    if len(flat) // channels < frames:
        # short audio must be an error, not a silently shorter file —
        # the same policy as the WAV reader's truncation check
        raise WavFormatError(
            f"{path}: SSND holds {len(flat) // channels} frames, COMM "
            f"declares {frames}")
    audio = flat[: frames * channels].reshape(frames, channels).T.copy()
    return audio, int(round(rate)), meta


def write_aiff(
    path: str,
    audio: np.ndarray,
    rate: int,
    meta: Optional[WavMetadata] = None,
    bits: int = 32,
    float_format: bool = True,
) -> None:
    """Write an AIFF file.

    Defaults to AIFF-C fl32 (32-bit float — no quantization of the
    rotated output, matching the WAV writer's default); pass
    ``float_format=False`` with bits in {16, 24, 32} for classic
    big-endian PCM AIFF.
    """
    x = np.atleast_2d(np.asarray(audio, np.float32))
    channels, n = x.shape
    flat = x.T.reshape(-1)
    if float_format:
        data = flat.astype(">f4").tobytes()
        bits = 32
    elif bits == 16:
        pcm = np.clip(np.rint(flat * 32768.0), -32768, 32767).astype(">i2")
        data = pcm.tobytes()
    elif bits == 24:
        v = np.clip(np.rint(flat * 8388608.0), -8388608,
                    8388607).astype(np.int32)
        b = np.empty((len(v), 3), np.uint8)
        b[:, 0] = (v >> 16) & 0xFF
        b[:, 1] = (v >> 8) & 0xFF
        b[:, 2] = v & 0xFF
        data = b.tobytes()
    elif bits == 32:
        pcm = np.clip(np.rint(flat.astype(np.float64) * 2147483648.0),
                      -2147483648, 2147483647).astype(">i4")
        data = pcm.tobytes()
    else:
        raise ValueError(f"bits must be 16/24/32, got {bits}")

    chunks = []
    comm = struct.pack(">hIh", channels, n, bits) + _write_f80(float(rate))
    if float_format:
        # AIFF-C compression type + pascal-string name (even total)
        comm += b"fl32" + b"\x07float32"
        chunks.append(b"FVER" + struct.pack(">II", 4, 0xA2805140))
    chunks.append(b"COMM" + struct.pack(">I", len(comm)) + comm)
    for info_id, text in (meta.info.items() if meta else ()):
        cid = _TEXT_MAP_INV.get(info_id)
        if cid is None:
            continue
        payload = text.encode("utf-8")
        chunks.append(cid + struct.pack(">I", len(payload)) + payload
                      + (b"\x00" if len(payload) & 1 else b""))
    ssnd = struct.pack(">II", 0, 0) + data
    chunks.append(b"SSND" + struct.pack(">I", len(ssnd)) + ssnd
                  + (b"\x00" if len(ssnd) & 1 else b""))

    body = (b"AIFC" if float_format else b"AIFF") + b"".join(chunks)
    with open(path, "wb") as f:
        f.write(b"FORM" + struct.pack(">I", len(body)) + body)
