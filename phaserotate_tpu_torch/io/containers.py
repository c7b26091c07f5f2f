"""Extended PCM containers: Sony Wave64 (W64), RF64/BW64, Apple CAF.

A copy of ``phaserotate_tpu/io/containers.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy of the host-side (numpy/ctypes) file
layer.  Only these lines differ; ``tests/test_torch_io.py`` holds every
function here to its source.

Rounds out the libsndfile-breadth parity of the reference's file layer
(cli/phase-rotate.cc:33 ``sf_open``): beyond WAV/AIFF/FLAC these are the
containers mastering and broadcast workflows hand around —

* **W64**: RIFF recast with 16-byte GUID chunk ids and 64-bit sizes
  (no 4 GiB limit); chunk payloads 8-byte aligned.
* **RF64/BW64**: RIFF with a ``ds64`` size-override chunk; the EBU
  broadcast-wave form for >4 GiB captures.
* **CAF**: Apple's big-endian chunked container (``caff`` magic,
  ``desc`` describing LPCM, ``data`` with edit count, optional ``info``
  string table).

All three decode through the same PCM conversion as WAV (io/wav.py) and
encode float32 by default (no quantization of rotated output).
Implemented from the public container specifications; independent of
libsndfile.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from .wav import (
    WavFormatError,
    WavMetadata,
    _float_to_pcm,
    _info_list_body,
    _parse_info_list,
    _pcm_to_float,
)

__all__ = [
    "is_w64", "read_w64", "write_w64",
    "is_rf64", "read_rf64", "write_rf64",
    "is_caf", "read_caf", "write_caf",
]

# W64 GUIDs: fourcc + fixed suffix bytes (data2/3 little-endian, data4
# raw, per the Sony Wave64 spec)
_W64_RIFF = b"riff\x2e\x91\xcf\x11\xa5\xd6\x28\xdb\x04\xc1\x00\x00"
_W64_SUFFIX = b"\xf3\xac\xd3\x11\x8c\xd1\x00\xc0\x4f\x8e\xdb\x8a"


def _w64_guid(fourcc: bytes) -> bytes:
    return fourcc + _W64_SUFFIX


def is_w64(head: bytes) -> bool:
    return head[:16] == _W64_RIFF if len(head) >= 16 else \
        head[:4] == b"riff"


def is_rf64(head: bytes) -> bool:
    return head[:4] in (b"RF64", b"BW64") and head[8:12] == b"WAVE"


def is_caf(head: bytes) -> bool:
    return head[:4] == b"caff"


# ---- W64 -------------------------------------------------------------------

def read_w64(path: str) -> Tuple[np.ndarray, int, WavMetadata]:
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:16] != _W64_RIFF:
        raise WavFormatError(f"{path}: not a Wave64 file")
    if blob[24:40] != _w64_guid(b"wave"):
        raise WavFormatError(f"{path}: Wave64 without wave form")

    meta = WavMetadata(container="W64")
    fmt = None
    data = None
    pos = 40
    while pos + 24 <= len(blob):
        guid = blob[pos : pos + 16]
        (size,) = struct.unpack_from("<Q", blob, pos + 16)
        if size < 24 or pos + size > len(blob):
            raise WavFormatError(f"{path}: truncated Wave64 chunk")
        payload = blob[pos + 24 : pos + size]
        fourcc = guid[:4]
        if fourcc == b"fmt ":
            if len(payload) < 16:
                raise WavFormatError(f"{path}: short fmt chunk")
            fmt = struct.unpack_from("<HHIIHH", payload, 0)
        elif fourcc == b"data":
            data = payload
        elif fourcc == b"bext":
            meta.bext = payload
        elif fourcc == b"cue ":
            meta.cues = payload
        elif fourcc == b"list" and payload[:4] == b"INFO":
            # list payload carries RIFF-format INFO subchunks
            meta.info.update(_parse_info_list(payload[4:]))
        else:
            meta.other.append((fourcc, payload))
        pos += (size + 7) & ~7  # chunks are 8-byte aligned

    if fmt is None or data is None:
        raise WavFormatError(f"{path}: missing fmt/data chunk")
    wformat, channels, rate, _, _, bits = fmt
    if channels < 1 or rate < 1:
        raise WavFormatError(f"{path}: bad fmt chunk")
    flat = _pcm_to_float(data, bits, wformat)
    n = len(flat) // channels
    return flat[: n * channels].reshape(n, channels).T.copy(), rate, meta


def write_w64(path: str, audio: np.ndarray, rate: int,
              meta: Optional[WavMetadata] = None,
              bits: int = 32, float_format: bool = True) -> None:
    x = np.atleast_2d(np.asarray(audio, np.float32))
    channels, n = x.shape
    fmt_tag = 3 if float_format else 1
    if float_format:
        bits = 32
    payload = _float_to_pcm(x.T.reshape(-1), bits, fmt_tag)

    def chunk(fourcc: bytes, body: bytes) -> bytes:
        size = 24 + len(body)
        pad = b"\x00" * ((-size) % 8)
        return _w64_guid(fourcc) + struct.pack("<Q", size) + body + pad

    block_align = channels * bits // 8
    fmt_body = struct.pack("<HHIIHH", fmt_tag, channels, rate,
                           rate * block_align, block_align, bits)
    body = _w64_guid(b"wave") + chunk(b"fmt ", fmt_body)
    if meta is not None:
        if meta.bext is not None:
            body += chunk(b"bext", meta.bext)
        if meta.cues is not None:
            body += chunk(b"cue ", meta.cues)
        if meta.info:
            body += chunk(b"list", b"INFO" + _info_list_body(meta))
    body += chunk(b"data", payload)
    with open(path, "wb") as f:
        # riff size covers the whole file including this header
        f.write(_W64_RIFF + struct.pack("<Q", 24 + len(body)) + body)


# ---- RF64 ------------------------------------------------------------------

def read_rf64(path: str) -> Tuple[np.ndarray, int, WavMetadata]:
    with open(path, "rb") as f:
        blob = f.read()
    if not is_rf64(blob[:12]):
        raise WavFormatError(f"{path}: not an RF64/BW64 file")

    meta = WavMetadata(container="RF64")
    fmt = None
    data = None
    ds64_data_size = None
    pos = 12
    while pos + 8 <= len(blob):
        cid = blob[pos : pos + 4]
        (size,) = struct.unpack_from("<I", blob, pos + 4)
        # a data chunk carrying the 0xFFFFFFFF sentinel takes its real
        # size from ds64 — resolve that BEFORE any bounds/payload work
        if cid == b"data" and size == 0xFFFFFFFF:
            if ds64_data_size is None:
                raise WavFormatError(
                    f"{path}: RF64 data chunk without ds64 size")
            size = ds64_data_size
        # bounds-check before touching the payload so truncated files
        # fail with the format-error contract, never a raw struct.error
        if pos + 8 + size > len(blob):
            raise WavFormatError(f"{path}: truncated {cid!r} chunk")
        payload = blob[pos + 8 : pos + 8 + size]
        if cid == b"ds64":
            if len(payload) < 24:
                raise WavFormatError(f"{path}: short ds64 chunk")
            _, ds64_data_size, _ = struct.unpack_from("<QQQ", payload, 0)
        elif cid == b"data":
            data = payload
        elif cid == b"fmt ":
            if len(payload) < 16:
                raise WavFormatError(f"{path}: short fmt chunk")
            fmt = struct.unpack_from("<HHIIHH", payload, 0)
        elif cid == b"bext":
            meta.bext = payload
        elif cid == b"cue ":
            meta.cues = payload
        elif cid == b"LIST" and payload[:4] == b"INFO":
            meta.info.update(_parse_info_list(payload[4:]))
        pos += 8 + size + (size & 1)

    if fmt is None or data is None:
        raise WavFormatError(f"{path}: missing fmt/data chunk")
    wformat, channels, rate, _, _, bits = fmt
    if channels < 1 or rate < 1:
        raise WavFormatError(f"{path}: bad fmt chunk")
    flat = _pcm_to_float(data, bits, wformat)
    n = len(flat) // channels
    return flat[: n * channels].reshape(n, channels).T.copy(), rate, meta


def write_rf64(path: str, audio: np.ndarray, rate: int,
               meta: Optional[WavMetadata] = None,
               bits: int = 32, float_format: bool = True) -> None:
    """Always-valid RF64: sizes are carried in ds64 and the 32-bit
    fields hold the 0xFFFFFFFF sentinel, so files stream correctly past
    4 GiB without a rewrite pass."""
    x = np.atleast_2d(np.asarray(audio, np.float32))
    channels, n = x.shape
    fmt_tag = 3 if float_format else 1
    if float_format:
        bits = 32
    payload = _float_to_pcm(x.T.reshape(-1), bits, fmt_tag)

    block_align = channels * bits // 8
    fmt_body = struct.pack("<HHIIHH", fmt_tag, channels, rate,
                           rate * block_align, block_align, bits)
    chunks = []
    data_chunk = (b"data" + struct.pack("<I", 0xFFFFFFFF) + payload
                  + (b"\x00" if len(payload) & 1 else b""))
    fmt_chunk = b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
    meta_chunks = b""
    if meta is not None:
        if meta.bext is not None:
            b = meta.bext
            meta_chunks += (b"bext" + struct.pack("<I", len(b)) + b
                            + (b"\x00" if len(b) & 1 else b""))
        if meta.cues is not None:
            c = meta.cues
            meta_chunks += (b"cue " + struct.pack("<I", len(c)) + c
                            + (b"\x00" if len(c) & 1 else b""))
        if meta.info:
            lst = b"INFO" + _info_list_body(meta)
            meta_chunks += b"LIST" + struct.pack("<I", len(lst)) + lst
    riff_size = (4 + 8 + 28 + len(fmt_chunk) + len(meta_chunks)
                 + len(data_chunk))
    ds64 = struct.pack("<QQQI", riff_size, len(payload), n, 0)
    chunks.append(b"ds64" + struct.pack("<I", len(ds64)) + ds64)
    chunks.append(fmt_chunk)
    if meta_chunks:
        chunks.append(meta_chunks)
    chunks.append(data_chunk)
    with open(path, "wb") as f:
        f.write(b"RF64" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
                + b"".join(chunks))


# ---- CAF -------------------------------------------------------------------

_CAF_FLOAT = 1       # kCAFLinearPCMFormatFlagIsFloat
_CAF_LITTLE = 2      # kCAFLinearPCMFormatFlagIsLittleEndian

_CAF_INFO_KEYS = {"title": b"INAM", "artist": b"IART",
                  "comments": b"ICMT", "copyright": b"ICOP",
                  "year": b"ICRD", "genre": b"IGNR"}
_INFO_CAF_KEYS = {v: k for k, v in _CAF_INFO_KEYS.items()}


def read_caf(path: str) -> Tuple[np.ndarray, int, WavMetadata]:
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] != b"caff":
        raise WavFormatError(f"{path}: not a CAF file")

    meta = WavMetadata(container="CAF")
    desc = None
    data = None
    pos = 8
    while pos + 12 <= len(blob):
        ctype = blob[pos : pos + 4]
        (size,) = struct.unpack_from(">q", blob, pos + 4)
        if size == -1:  # last-chunk sentinel: runs to EOF
            size = len(blob) - pos - 12
        elif size < 0:
            # any other negative size is corruption; without this guard
            # e.g. -12 would advance pos by zero and loop forever
            raise WavFormatError(
                f"{path}: negative {ctype!r} chunk size {size}")
        if pos + 12 + size > len(blob):
            raise WavFormatError(f"{path}: truncated {ctype!r} chunk")
        payload = blob[pos + 12 : pos + 12 + size]
        if ctype == b"desc":
            if len(payload) < 32:
                raise WavFormatError(f"{path}: short desc chunk")
            desc = struct.unpack(">d4sIIIII", payload[:32])
        elif ctype == b"data":
            data = payload[4:]  # skip the u32 edit count
        elif ctype == b"info":
            _parse_caf_info(payload, meta)
        pos += 12 + size

    if desc is None or data is None:
        raise WavFormatError(f"{path}: missing desc/data chunk")
    rate_f, fmt_id, flags, bpp, fpp, channels, bits = desc
    if fmt_id != b"lpcm":
        raise WavFormatError(
            f"{path}: unsupported CAF codec {fmt_id!r} (LPCM only)")
    if channels < 1 or rate_f <= 0:
        raise WavFormatError(f"{path}: bad desc chunk")
    is_float = bool(flags & _CAF_FLOAT)
    little = bool(flags & _CAF_LITTLE)
    raw = data
    if not little:  # byte-swap to little for the shared PCM converter
        w = bits // 8
        if w > 1:
            a = np.frombuffer(raw[: len(raw) - len(raw) % w], np.uint8)
            raw = a.reshape(-1, w)[:, ::-1].tobytes()
    flat = _pcm_to_float(raw, bits, 3 if is_float else 1)
    n = len(flat) // channels
    return (flat[: n * channels].reshape(n, channels).T.copy(),
            int(round(rate_f)), meta)


def _parse_caf_info(payload: bytes, meta: WavMetadata) -> None:
    try:
        (count,) = struct.unpack_from(">I", payload, 0)
        parts = payload[4:].split(b"\x00")
        for i in range(count):
            key = parts[2 * i].decode("utf-8", "replace").lower()
            val = parts[2 * i + 1].decode("utf-8", "replace")
            tag = _CAF_INFO_KEYS.get(key)
            if tag:
                meta.info[tag] = val
    except (struct.error, IndexError):
        pass  # malformed info strings are non-fatal


def write_caf(path: str, audio: np.ndarray, rate: int,
              meta: Optional[WavMetadata] = None,
              bits: int = 32, float_format: bool = True) -> None:
    x = np.atleast_2d(np.asarray(audio, np.float32))
    channels, n = x.shape
    if float_format:
        bits = 32
    payload = _float_to_pcm(x.T.reshape(-1), bits,
                            3 if float_format else 1)
    flags = (_CAF_FLOAT if float_format else 0) | _CAF_LITTLE
    bpf = channels * bits // 8
    desc = struct.pack(">d4sIIIII", float(rate), b"lpcm", flags,
                       bpf, 1, channels, bits)

    out = [b"caff" + struct.pack(">HH", 1, 0)]
    out.append(b"desc" + struct.pack(">q", len(desc)) + desc)
    if meta is not None and meta.info:
        entries = []
        for tag, val in meta.info.items():
            key = _INFO_CAF_KEYS.get(tag)
            if key:
                entries.append((key.encode(), val.encode()))
        if entries:
            body = struct.pack(">I", len(entries)) + b"".join(
                k + b"\x00" + v + b"\x00" for k, v in entries)
            out.append(b"info" + struct.pack(">q", len(body)) + body)
    body = struct.pack(">I", 0) + payload  # edit count 0
    out.append(b"data" + struct.pack(">q", len(body)) + body)
    with open(path, "wb") as f:
        f.write(b"".join(out))
