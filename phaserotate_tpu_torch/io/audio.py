"""Format-dispatching audio I/O.

A copy of ``phaserotate_tpu/io/audio.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy of the host-side (numpy/ctypes) file
layer.  Only these lines differ; ``tests/test_torch_io.py`` holds every
function here to its source.

The reference opens files through libsndfile and gets every major format
for free (cli/phase-rotate.cc sf_open); here the formats mastering
workflows actually exchange — WAV, AIFF, FLAC, Ogg Vorbis, Ogg Opus,
MP3, W64, RF64/BW64, CAF, AU — are dispatched by content sniffing on
read and by extension on write.  Lossless codecs are the framework's own
(io/flac.py, io/containers.py); lossy ones pair a framework container
layer with the canonical system codec libraries (io/vorbis.py decodes
Vorbis from scratch; vorbisenc/mp3/opus bind libvorbisenc, libmpg123/
libmp3lame, libopus — the libraries libsndfile itself links).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .aiff import is_aiff, read_aiff, write_aiff
from .au import is_au, read_au, write_au
from .containers import (
    is_caf,
    is_rf64,
    is_w64,
    read_caf,
    read_rf64,
    read_w64,
    write_caf,
    write_rf64,
    write_w64,
)
from .flac import FlacFormatError, is_flac, read_flac, read_flac_pcm16, \
    write_flac
from .mp3 import is_mp3, read_mp3
from .vorbis import is_ogg, read_ogg
from .wav import WavFormatError, WavMetadata, read_wav, read_wav_pcm16, \
    write_wav

__all__ = ["read_audio", "read_audio_pcm16", "probe_audio", "write_audio"]

_AIFF_EXT = (".aiff", ".aif", ".aifc")


def read_audio(path: str) -> Tuple[np.ndarray, int, WavMetadata]:
    """Read WAV, AIFF, FLAC, Ogg Vorbis, Ogg Opus, MP3, W64, RF64,
    CAF, or AU (sniffed by magic) -> ((ch, n) f32, rate, meta)."""
    with open(path, "rb") as f:
        head = f.read(16)
    if is_aiff(head):
        return read_aiff(path)
    if is_flac(head):
        return read_flac(path)
    if is_ogg(head):
        # Opus and Vorbis share the OggS capture: probe the first page
        with open(path, "rb") as f:
            probe = f.read(128)
        if b"OpusHead" in probe:
            from .opus import read_opus

            return read_opus(path)
        return read_ogg(path)
    if is_w64(head):
        return read_w64(path)
    if is_rf64(head):
        return read_rf64(path)
    if is_caf(head):
        return read_caf(path)
    if is_au(head):
        return read_au(path)
    if is_mp3(head):
        return read_mp3(path)
    return read_wav(path)


def read_audio_pcm16(path: str) -> Tuple[np.ndarray, int, WavMetadata]:
    """Read any supported file as ((ch, n) int16 PCM, rate, meta).

    Fleet ingest path: 16-bit WAV and FLAC decode straight to int16
    with NO host float conversion (half the bytes to ship to a device;
    dequantize there — search.sweep_peaks_aux_pcm16).  Every other
    format/depth falls back to the float reader + quantization, which
    is value-identical for material that originated at 16 bit.
    """
    with open(path, "rb") as f:
        head = f.read(16)
    try:
        if is_flac(head):
            return read_flac_pcm16(path)
        if head[:4] == b"RIFF":
            return read_wav_pcm16(path)
        if is_au(head):
            from .au import read_au_pcm16

            return read_au_pcm16(path)
        if is_aiff(head):
            from .aiff import read_aiff_pcm16

            return read_aiff_pcm16(path)
    except (WavFormatError, FlacFormatError):
        pass  # not 16-bit PCM (or no native decoder): quantize below
    audio, rate, meta = read_audio(path)
    q = np.clip(np.rint(audio * 32768.0), -32768, 32767).astype(np.int16)
    return q, rate, meta


def _ogg_final_granule(path: str) -> int:
    """Granule position of the stream's last Ogg page (total PCM
    frames for Vorbis; 48 kHz frames incl. preskip for Opus), found by
    scanning the file tail — no decode.

    'OggS' can occur as a byte pattern inside packet data, so each
    candidate is validated as a real page (version byte 0, header
    fully present, page CRC matches) before its granule is trusted;
    the result is clamped to >= 0 (Vorbis pages may carry -1)."""
    import os
    import struct

    from .vorbis import _ogg_crc

    size = os.path.getsize(path)
    with open(path, "rb") as f:
        f.seek(max(0, size - 65536))
        tail = f.read()
    i = len(tail)
    while True:
        i = tail.rfind(b"OggS", 0, i)
        if i < 0:
            return -1
        # header = capture(4) ver(1) type(1) granule(8) serial(4)
        #          seq(4) crc(4) nsegs(1) segtable(nsegs)
        if i + 27 > len(tail) or tail[i + 4] != 0:
            continue
        nsegs = tail[i + 26]
        body = sum(tail[i + 27 : i + 27 + nsegs])
        end = i + 27 + nsegs + body
        if end > len(tail):
            continue
        (page_crc,) = struct.unpack_from("<I", tail, i + 22)
        page = bytearray(tail[i:end])
        page[22:26] = b"\x00\x00\x00\x00"
        if _ogg_crc(bytes(page)) != page_crc:
            continue
        granule = struct.unpack_from("<q", tail, i + 6)[0]
        return max(0, granule)


def probe_audio(path: str) -> Tuple[int, int, int]:
    """(rate, channels, frames) from headers where possible.

    A fleet's bucketing pass (fleet.py) must not decode audio it will
    decode again at staging time: WAV/FLAC read chunk headers, Ogg
    Vorbis/Opus read the identification packet plus the final page's
    granule position; only formats without a cheap header path (MP3
    without a seek table, the exotic containers) fall back to a full
    decode."""
    import struct

    with open(path, "rb") as f:
        head = f.read(16)
    if head[:4] == b"RIFF":
        from .wav import _read_wav_chunks

        _wformat, bits, channels, rate, data, _meta = \
            _read_wav_chunks(path)
        return rate, channels, len(data) // (channels * max(1, bits // 8))
    if is_flac(head):
        from .flac import _read_flac_header

        with open(path, "rb") as f:
            blob = f.read(1 << 20)  # metadata only; frames not parsed
        _pos, rate, channels, _bits, total, _meta = \
            _read_flac_header(blob)
        if total:
            return rate, channels, total
    elif is_ogg(head):
        with open(path, "rb") as f:
            first = f.read(512)
        granule = _ogg_final_granule(path)
        i = first.find(b"OpusHead")
        if i >= 0 and granule >= 0 and len(first) >= i + 12:
            channels = first[i + 9]
            (preskip,) = struct.unpack_from("<H", first, i + 10)
            return 48000, channels, max(0, granule - preskip)
        i = first.find(b"\x01vorbis")
        if i >= 0 and granule >= 0 and len(first) >= i + 16:
            channels = first[i + 11]
            (rate,) = struct.unpack_from("<I", first, i + 12)
            if rate and channels:
                return rate, channels, granule
    elif is_au(head):
        import os

        from .au import _ENCODINGS

        with open(path, "rb") as f:
            hdr = f.read(24)
        if len(hdr) == 24:
            offset, size, enc, rate, channels = struct.unpack_from(
                ">IIIII", hdr, 4)
            if enc in _ENCODINGS and channels and rate:
                bps = _ENCODINGS[enc][0]
                avail = max(0, os.path.getsize(path) - offset)
                if size != 0xFFFFFFFF:
                    avail = min(avail, size)
                return rate, channels, avail // (bps * channels)
    audio, rate, _meta = read_audio_pcm16(path)
    return rate, audio.shape[0], audio.shape[1]


def _sniff(path: str) -> str:
    try:
        with open(path, "rb") as f:
            head = f.read(16)
    except OSError:
        return "wav"
    if is_aiff(head):
        return "aiff"
    if is_flac(head):
        return "flac"
    if is_ogg(head):
        try:
            with open(path, "rb") as f:
                if b"OpusHead" in f.read(128):
                    return "opus"
        except OSError:
            pass
        return "ogg"
    if is_mp3(head):
        return "mp3"
    if is_w64(head):
        return "w64"
    if is_rf64(head):
        return "rf64"
    if is_caf(head):
        return "caf"
    if is_au(head):
        return "au"
    return "wav"


def write_audio(
    path: str,
    audio: np.ndarray,
    rate: int,
    meta: Optional[WavMetadata] = None,
    like: Optional[str] = None,
) -> None:
    """Write by output extension (.aiff/.aif/.aifc -> AIFF, .flac ->
    FLAC, .w64 -> W64, .rf64 -> RF64, .caf -> CAF, .wav -> WAV); with no
    recognizable extension, follow the format of ``like`` (the input
    file, sniffed by CONTENT like the read path — an extension-less AIFF
    input keeps producing AIFF) the way the reference's write path
    inherits the input's major format."""
    lower = path.lower()
    known = lower.endswith(
        (".wav",) + _AIFF_EXT + (".flac", ".ogg", ".oga", ".mp3",
                                 ".opus", ".w64", ".rf64", ".caf",
                                 ".au", ".snd"))
    inherited = "" if known or like is None else _sniff(like)
    if lower.endswith(_AIFF_EXT) or inherited == "aiff":
        write_aiff(path, audio, rate, meta)
    elif lower.endswith(".flac") or inherited == "flac":
        write_flac(path, audio, rate, meta)
    elif lower.endswith((".ogg", ".oga")) or inherited == "ogg":
        from .vorbisenc import write_ogg

        comments = None
        if meta is not None and meta.info:
            from .vorbis import _VORBIS_TO_INFO

            inv = {v: k for k, v in _VORBIS_TO_INFO.items()}
            comments = {inv[tag]: val for tag, val in meta.info.items()
                        if tag in inv}
        write_ogg(path, audio, rate, comments=comments)
    elif lower.endswith(".opus") or inherited == "opus":
        from .opus import write_opus

        write_opus(path, audio, rate, meta)
    elif lower.endswith(".mp3") or inherited == "mp3":
        from .mp3 import write_mp3

        write_mp3(path, audio, rate, meta)
    elif lower.endswith(".w64") or inherited == "w64":
        write_w64(path, audio, rate, meta)
    elif lower.endswith(".rf64") or inherited == "rf64":
        write_rf64(path, audio, rate, meta)
    elif lower.endswith(".caf") or inherited == "caf":
        write_caf(path, audio, rate, meta)
    elif lower.endswith((".au", ".snd")) or inherited == "au":
        write_au(path, audio, rate, meta)
    else:
        write_wav(path, audio, rate, meta)
