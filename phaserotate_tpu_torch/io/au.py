"""Sun/NeXT AU (.au/.snd) audio file codec.

A copy of ``phaserotate_tpu/io/au.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy of the host-side (numpy/ctypes) file
layer.  Only these lines differ; ``tests/test_torch_io.py`` holds every
function here to its source.

The reference CLI opens any libsndfile major format
(cli/phase-rotate.cc:33 sf_open); AU is the classic Unix interchange
format in that set (SF_FORMAT_AU).  Fresh implementation of the public
layout: a 24-byte big-endian header (magic ".snd", data offset, data
size, encoding, sample rate, channels), an optional NUL-padded
annotation between header and data, then interleaved big-endian
samples.

Supported encodings (the libsndfile AU set for linear/float audio):
G.711 mu-law (1) and A-law (27), signed PCM 8/16/24/32 (2/3/4/5), and
IEEE float32/float64 (6/7).  Reads to the package-wide ((channels, n)
float32, rate, WavMetadata) convention; the annotation maps to the
ICMT info entry like AIFF's ANNO.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from .wav import WavFormatError, WavMetadata

__all__ = ["read_au", "read_au_pcm16", "write_au", "is_au"]

_MAGIC = b".snd"

# encoding id -> (bytes per sample, kind)
_ENCODINGS = {
    1: (1, "ulaw"),
    2: (1, "pcm8"),
    3: (2, "pcm16"),
    4: (3, "pcm24"),
    5: (4, "pcm32"),
    6: (4, "f32"),
    7: (8, "f64"),
    27: (1, "alaw"),
}
_UNKNOWN_SIZE = 0xFFFFFFFF


def is_au(blob: bytes) -> bool:
    return blob[:4] == _MAGIC


def _ulaw_decode(u: np.ndarray) -> np.ndarray:
    """G.711 mu-law byte -> float32 in [-1, 1] (ITU-T G.711 expansion,
    the same math libsndfile's table encodes)."""
    u = (~u) & 0xFF
    sign = np.where(u & 0x80, -1.0, 1.0).astype(np.float32)
    exp = (u >> 4) & 0x07
    mant = u & 0x0F
    mag = ((mant.astype(np.int32) << 3) + 0x84 << exp) - 0x84
    return (sign * mag.astype(np.float32)) / 32768.0


def _alaw_decode(a: np.ndarray) -> np.ndarray:
    """G.711 A-law byte -> float32 in [-1, 1].  Note the A-law sign
    convention is inverted vs mu-law: bit 0x80 SET (after the 0x55
    XOR) means positive."""
    a = a ^ 0x55
    sign = np.where(a & 0x80, 1.0, -1.0).astype(np.float32)
    exp = (a >> 4) & 0x07
    mant = (a & 0x0F).astype(np.int32)
    mag = np.where(exp == 0, (mant << 4) + 8,
                   ((mant << 4) + 0x108) << np.maximum(exp - 1, 0))
    return (sign * mag.astype(np.float32)) / 32768.0


def _ulaw_encode(x: np.ndarray) -> np.ndarray:
    """float32 -> G.711 mu-law byte (vectorized segment search)."""
    pcm = np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int32)
    sign = np.where(pcm < 0, 0x80, 0).astype(np.int32)
    mag = np.minimum(np.abs(pcm), 32635) + 0x84
    exp = (np.floor(np.log2(mag)).astype(np.int32) - 7).clip(0, 7)
    mant = (mag >> (exp + 3)) & 0x0F
    return ((~(sign | (exp << 4) | mant)) & 0xFF).astype(np.uint8)


def _alaw_encode(x: np.ndarray) -> np.ndarray:
    """float32 -> G.711 A-law byte (the classic 13-bit segment search,
    vectorized)."""
    pcm = np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int32)
    p = pcm >> 3  # 13-bit domain
    pos = p >= 0
    mask = np.where(pos, 0xD5, 0x55)
    p2 = np.where(pos, p, -p - 1)
    seg_end = np.array([0x1F, 0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF,
                        0xFFF], np.int32)
    seg = np.searchsorted(seg_end, p2, side="left").astype(np.int32)
    shift = np.where(seg < 2, 1, seg)
    aval = (np.minimum(seg, 7) << 4) | ((p2 >> shift) & 0x0F)
    aval = np.where(seg >= 8, 0x7F, aval)
    return ((aval ^ mask) & 0xFF).astype(np.uint8)


def read_au(path: str) -> Tuple[np.ndarray, int, WavMetadata]:
    """Read a Sun AU file -> ((channels, n) float32, rate, meta)."""
    audio, rate, meta, _enc = _read_au_impl(path, want_pcm16=False)
    return audio, rate, meta


def _read_au_impl(path: str, want_pcm16: bool):
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 24 or blob[:4] != _MAGIC:
        raise WavFormatError(f"{path}: not an AU file")
    offset, size, enc, rate, channels = struct.unpack_from(">IIIII",
                                                           blob, 4)
    if offset < 24 or offset > len(blob):
        raise WavFormatError(f"{path}: bad AU data offset {offset}")
    if enc not in _ENCODINGS:
        raise WavFormatError(f"{path}: unsupported AU encoding {enc}")
    if not (1 <= channels <= 64):
        raise WavFormatError(f"{path}: implausible channel count "
                             f"{channels}")
    if not (1 <= rate <= 768000):
        raise WavFormatError(f"{path}: implausible sample rate {rate}")
    meta = WavMetadata(container="AU")
    note = blob[24:offset].split(b"\x00", 1)[0]
    if note:
        meta.info[b"ICMT"] = note.decode("utf-8", "replace")
    bps, kind = _ENCODINGS[enc]
    avail = len(blob) - offset
    if size != _UNKNOWN_SIZE:
        avail = min(avail, size)
    n_total = avail // (bps * channels) * channels
    raw = blob[offset : offset + n_total * bps]
    if want_pcm16:
        if kind != "pcm16":
            return None, int(rate), meta, enc
        flat16 = np.frombuffer(raw, ">i2").astype(np.int16)
        n = len(flat16) // channels
        audio16 = flat16[: n * channels].reshape(n, channels).T.copy()
        return audio16, int(rate), meta, enc
    if kind == "ulaw":
        flat = _ulaw_decode(np.frombuffer(raw, np.uint8))
    elif kind == "alaw":
        flat = _alaw_decode(np.frombuffer(raw, np.uint8))
    elif kind == "pcm8":
        flat = np.frombuffer(raw, np.int8).astype(np.float32) / 128.0
    elif kind == "pcm16":
        flat = np.frombuffer(raw, ">i2").astype(np.float32) / 32768.0
    elif kind == "pcm24":
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.uint32)
        v = (b[:, 0] << 16) | (b[:, 1] << 8) | b[:, 2]
        v = v.astype(np.int32)
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        flat = v.astype(np.float32) / float(1 << 23)
    elif kind == "pcm32":
        flat = (np.frombuffer(raw, ">i4").astype(np.float64)
                / float(1 << 31)).astype(np.float32)
    elif kind == "f32":
        flat = np.frombuffer(raw, ">f4").astype(np.float32)
    else:  # f64
        flat = np.frombuffer(raw, ">f8").astype(np.float32)
    n = len(flat) // channels
    audio = flat[: n * channels].reshape(n, channels).T.copy()
    return audio, int(rate), meta, enc


def read_au_pcm16(path: str) -> Tuple[np.ndarray, int, WavMetadata]:
    """Read a 16-bit PCM AU without float conversion.

    Returns ``((channels, n) int16, rate, metadata)`` — the raw-PCM
    fleet ingest path (device-side dequantize,
    search.sweep_peaks_aux_pcm16); AU stores big-endian, so this is a
    header parse plus one byteswap.  Raises WavFormatError for any
    other encoding; callers fall back to :func:`read_au` + quantize.
    """
    audio, rate, meta, enc = _read_au_impl(path, want_pcm16=True)
    if enc != 3:
        raise WavFormatError(f"{path}: not 16-bit PCM AU (encoding "
                             f"{enc})")
    return audio, rate, meta


def write_au(path: str, audio: np.ndarray, rate: int,
             meta: Optional[WavMetadata] = None,
             encoding: str = "pcm16") -> None:
    """Write a Sun AU file.  ``encoding``: pcm8/pcm16/pcm24/pcm32/
    f32/f64/ulaw/alaw (big-endian, per the format)."""
    enc_id = {v[1]: k for k, v in _ENCODINGS.items()}.get(encoding)
    if enc_id is None:
        raise ValueError(f"unsupported AU encoding {encoding!r}")
    x = np.atleast_2d(np.ascontiguousarray(audio, np.float32))
    channels, n = x.shape
    flat = x.T.reshape(-1)
    if encoding == "ulaw":
        raw = _ulaw_encode(flat).tobytes()
    elif encoding == "alaw":
        raw = _alaw_encode(flat).tobytes()
    elif encoding == "pcm8":
        raw = np.clip(np.rint(flat * 128.0), -128,
                      127).astype(np.int8).tobytes()
    elif encoding == "pcm16":
        raw = np.clip(np.rint(flat * 32768.0), -32768,
                      32767).astype(">i2").tobytes()
    elif encoding == "pcm24":
        v = np.clip(np.rint(flat.astype(np.float64) * (1 << 23)),
                    -(1 << 23), (1 << 23) - 1).astype(np.int64)
        v = np.where(v < 0, v + (1 << 24), v).astype(np.uint32)
        b = np.empty((len(v), 3), np.uint8)
        b[:, 0] = (v >> 16) & 0xFF
        b[:, 1] = (v >> 8) & 0xFF
        b[:, 2] = v & 0xFF
        raw = b.tobytes()
    elif encoding == "pcm32":
        v = np.clip(np.rint(flat.astype(np.float64) * (1 << 31)),
                    -(1 << 31), (1 << 31) - 1).astype(">i4")
        raw = v.tobytes()
    elif encoding == "f32":
        raw = flat.astype(">f4").tobytes()
    else:  # f64
        raw = flat.astype(">f8").tobytes()
    note = b""
    if meta is not None and meta.info.get(b"ICMT"):
        note = meta.info[b"ICMT"].encode("utf-8") + b"\x00"
        note += b"\x00" * ((-len(note)) % 8)  # keep data 8-aligned
    offset = 24 + len(note)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack(">IIIII", offset, len(raw), enc_id,
                            int(rate), channels))
        f.write(note)
        f.write(raw)
