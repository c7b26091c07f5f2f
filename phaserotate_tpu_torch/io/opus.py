"""Ogg Opus read/write: our own Ogg layer + the system libopus codec.

A copy of ``phaserotate_tpu/io/opus.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy of the host-side (numpy/ctypes) file
layer.  Only these lines differ; ``tests/test_torch_io.py`` holds every
function here to its source.

Completes the lossy-format breadth of the file layer (the reference
gets Opus through libsndfile, cli/phase-rotate.cc:33).  The container
work is the framework's: pages parse through the same CRC-checked Ogg
reader as Vorbis (io/vorbis.py) and are WRITTEN by the page muxer here;
only the raw packet codec is the system library — libopus has no
container API at all, so this split is how every Opus app works.

Opus decodes at 48 kHz regardless of the input rate; the encoder
accepts 8/12/16/24/48 kHz input (other rates are rejected with a clear
error rather than silently resampled).
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional, Tuple

import numpy as np

from .vorbis import OggFormatError, _ogg_crc, _ogg_packets
from .wav import WavMetadata

__all__ = ["available", "is_opus", "read_opus", "write_opus"]

_OPUS_APPLICATION_AUDIO = 2049
_FRAME = 960  # 20 ms @ 48 kHz, the canonical Ogg Opus frame

_lib: Optional[ctypes.CDLL] = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL("libopus.so.0")
    except OSError:
        _lib = False
        return _lib
    lib.opus_decoder_create.restype = ctypes.c_void_p
    lib.opus_decoder_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.opus_decode_float.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]
    lib.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
    lib.opus_encoder_create.restype = ctypes.c_void_p
    lib.opus_encoder_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.opus_encode_float.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int]
    lib.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return bool(_load())


def is_opus(head: bytes, body_probe: bytes = b"") -> bool:
    """Ogg capture whose first packet is OpusHead.  ``head`` alone
    cannot distinguish Opus from Vorbis; callers pass more bytes."""
    blob = head + body_probe
    return blob[:4] == b"OggS" and b"OpusHead" in blob[:128]


def read_opus(path: str) -> Tuple[np.ndarray, int, WavMetadata]:
    """Decode an Ogg Opus file -> ((channels, n) float32, 48000, meta)."""
    lib = _load()
    if not lib:
        raise RuntimeError(
            "Opus decoding needs the system libopus (libopus.so.0); "
            "not found")
    with open(path, "rb") as f:
        data = f.read()
    packets, final_granule = _ogg_packets(data)
    if not packets or packets[0][:8] != b"OpusHead":
        raise OggFormatError(f"{path}: not an Ogg Opus stream")
    head = packets[0]
    if len(head) < 19:
        raise OggFormatError(f"{path}: short OpusHead")
    version = head[8]
    if version >> 4 != 0:
        raise OggFormatError(f"{path}: unsupported Opus version {version}")
    channels = head[9]
    (preskip,) = struct.unpack_from("<H", head, 10)
    mapping = head[18]
    if mapping != 0 or channels > 2:
        raise OggFormatError(
            f"{path}: only mapping family 0 (mono/stereo) supported")
    meta = WavMetadata(container="OPUS")
    if len(packets) > 1 and packets[1][:8] == b"OpusTags":
        _parse_opus_tags(packets[1], meta)

    err = ctypes.c_int(0)
    dec = lib.opus_decoder_create(48000, channels, ctypes.byref(err))
    if not dec or err.value:
        raise RuntimeError(f"opus_decoder_create failed ({err.value})")
    try:
        pcm = (ctypes.c_float * (5760 * channels))()
        chunks = []
        for pkt in packets[2:]:
            if not pkt:
                continue
            got = lib.opus_decode_float(dec, pkt, len(pkt), pcm, 5760, 0)
            if got < 0:
                raise OggFormatError(
                    f"{path}: opus decode error {got}")
            a = np.frombuffer(bytes(pcm)[: 4 * got * channels],
                              np.float32)
            chunks.append(a.reshape(got, channels))
        flat = (np.concatenate(chunks) if chunks
                else np.zeros((0, channels), np.float32))
    finally:
        lib.opus_decoder_destroy(dec)
    audio = flat.T.copy()
    audio = audio[:, preskip:]
    total = max(0, final_granule - preskip)
    if final_granule >= 0 and audio.shape[1] > total:
        audio = audio[:, :total]
    return audio, 48000, meta


def _parse_opus_tags(pkt: bytes, meta: WavMetadata) -> None:
    from .vorbis import _VORBIS_TO_INFO

    try:
        off = 8
        (vlen,) = struct.unpack_from("<I", pkt, off)
        off += 4 + vlen
        (count,) = struct.unpack_from("<I", pkt, off)
        off += 4
        for _ in range(count):
            (clen,) = struct.unpack_from("<I", pkt, off)
            off += 4
            entry = pkt[off : off + clen].decode("utf-8", "replace")
            off += clen
            if "=" in entry:
                key, val = entry.split("=", 1)
                tag = _VORBIS_TO_INFO.get(key.upper())
                if tag:
                    meta.info[tag] = val
    except (struct.error, IndexError):
        pass


# ---- Ogg page writer --------------------------------------------------------

def _ogg_page(serial: int, seq: int, granule: int, body_packets,
              htype: int) -> bytes:
    """One Ogg page carrying whole packets (no spanning needed here:
    Opus packets are far below the 255*255 page limit)."""
    lacing = bytearray()
    body = bytearray()
    for pkt in body_packets:
        q, r = divmod(len(pkt), 255)
        lacing += b"\xff" * q + bytes([r])
        body += pkt
    if len(lacing) > 255:
        raise ValueError("too many packets for one page")
    hdr = bytearray(b"OggS")
    hdr += bytes([0, htype])
    hdr += struct.pack("<q", granule)
    hdr += struct.pack("<I", serial)
    hdr += struct.pack("<I", seq)
    hdr += b"\x00\x00\x00\x00"  # crc placeholder
    hdr += bytes([len(lacing)]) + lacing
    page = bytes(hdr) + bytes(body)
    crc = _ogg_crc(page)
    return page[:22] + struct.pack("<I", crc) + page[26:]


def write_opus(path: str, audio: np.ndarray, rate: int,
               meta: Optional[WavMetadata] = None,
               bitrate: Optional[int] = None) -> None:
    """Encode float32 audio ((ch, n) or (n,)) as Ogg Opus.

    ``rate`` must be one of 8000/12000/16000/24000/48000 (the Opus
    input rates; no silent resampling).  Note the decoded stream always
    comes back at 48 kHz — Opus semantics, not a bug.
    """
    lib = _load()
    if not lib:
        raise RuntimeError(
            "Opus encoding needs the system libopus (libopus.so.0); "
            "not found")
    if rate not in (8000, 12000, 16000, 24000, 48000):
        raise ValueError(
            f"Opus input rate must be 8/12/16/24/48 kHz, got {rate}")
    x = np.atleast_2d(np.ascontiguousarray(audio, np.float32))
    channels, n = x.shape
    if channels > 2:
        raise ValueError("Ogg Opus writer supports mono or stereo")

    err = ctypes.c_int(0)
    enc = lib.opus_encoder_create(rate, channels,
                                  _OPUS_APPLICATION_AUDIO,
                                  ctypes.byref(err))
    if not enc or err.value:
        raise RuntimeError(f"opus_encoder_create failed ({err.value})")
    frame = _FRAME * rate // 48000  # 20 ms at the input rate
    look = ctypes.c_int(0)
    # OPUS_GET_LOOKAHEAD_REQUEST = 4027 (value in input-rate units).
    # ctl is variadic (no argtypes): wrap the handle so the 64-bit
    # pointer is not truncated to int
    lib.opus_encoder_ctl(ctypes.c_void_p(enc), ctypes.c_int(4027),
                         ctypes.byref(look))
    preskip = look.value * 48000 // rate  # OpusHead wants 48k units
    try:
        # feed lookahead extra zeros so the last n-th sample survives
        # the decoder's preskip trim (total padded to whole frames)
        n_fed = n + look.value
        inter = np.zeros(
            (-(-n_fed // frame) * frame, channels), np.float32)
        inter[:n] = x.T
        out = ctypes.create_string_buffer(4096)
        pkts = []
        for i in range(0, len(inter), frame):
            buf = np.ascontiguousarray(inter[i : i + frame])
            got = lib.opus_encode_float(
                enc, buf.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_float)), frame, out, 4096)
            if got < 0:
                raise RuntimeError(f"opus encode error {got}")
            pkts.append(out.raw[:got])
    finally:
        lib.opus_encoder_destroy(enc)

    head = (b"OpusHead" + bytes([1, channels])
            + struct.pack("<H", preskip) + struct.pack("<I", rate)
            + struct.pack("<h", 0) + bytes([0]))
    vendor = b"phaserotate_tpu"
    comments = []
    if meta is not None and meta.info:
        from .vorbis import _VORBIS_TO_INFO

        inv = {v: k for k, v in _VORBIS_TO_INFO.items()}
        for tag, val in meta.info.items():
            if tag in inv:
                comments.append(f"{inv[tag]}={val}".encode())
    tags = (b"OpusTags" + struct.pack("<I", len(vendor)) + vendor
            + struct.pack("<I", len(comments))
            + b"".join(struct.pack("<I", len(c)) + c for c in comments))

    serial = 0x50525455  # "PRTU"
    pages = [_ogg_page(serial, 0, 0, [head], 0x02),   # BOS
             _ogg_page(serial, 1, 0, [tags], 0x00)]
    seq = 2
    granule = preskip
    per_page = 32  # packets per audio page
    total_48k = n * 48000 // rate + preskip
    for i in range(0, len(pkts), per_page):
        group = pkts[i : i + per_page]
        granule += len(group) * _FRAME
        last = i + per_page >= len(pkts)
        pages.append(_ogg_page(
            serial, seq, min(granule, total_48k) if last else granule,
            group, 0x04 if last else 0x00))
        seq += 1
    with open(path, "wb") as f:
        f.write(b"".join(pages))
