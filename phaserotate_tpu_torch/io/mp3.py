"""MP3 read/write via the system codecs (ctypes, no compile step).

A copy of ``phaserotate_tpu/io/mp3.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy of the host-side (numpy/ctypes) file
layer.  Only these lines differ; ``tests/test_torch_io.py`` holds every
function here to its source.

The reference opens MP3 through libsndfile, which itself links libmpg123
for decode and libmp3lame for encode (cli/phase-rotate.cc:33 sf_open);
this module takes exactly the same posture — thin bindings over the
canonical system codecs.  Unlike FLAC (io/flac.py) and Vorbis
(io/vorbis.py) there is no independent reimplementation here: MP3's
patent-era reference implementations ARE mpg123/LAME, and a DSP
framework gains nothing from a third.

Degrades cleanly: :func:`available` is False without the shared
libraries and callers get a clear error.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from .wav import WavMetadata

__all__ = ["available", "is_mp3", "read_mp3", "write_mp3",
           "Mp3FormatError"]


class Mp3FormatError(ValueError):
    """Malformed/undecodable MP3 input.  A ValueError subclass like
    WavFormatError/FlacFormatError/OggFormatError: the io contract is
    that corrupt INPUT surfaces as ValueError, while a missing system
    codec stays RuntimeError (environment, not data)."""

# mpg123.h constants
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_FLOAT_32 = 0x200
_MPG123_ADD_FLAGS = 2       # enum mpg123_parms
_MPG123_FORCE_FLOAT = 0x400  # enum mpg123_param_flags

_libs: Optional[Tuple] = None


def _load():
    global _libs
    if _libs is not None:
        return _libs
    try:
        mpg = ctypes.CDLL("libmpg123.so.0")
        lame = ctypes.CDLL("libmp3lame.so.0")
    except OSError:
        _libs = ()
        return _libs
    mpg.mpg123_init()
    mpg.mpg123_new.restype = ctypes.c_void_p
    mpg.mpg123_new.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_int)]
    mpg.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    mpg.mpg123_param.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_long, ctypes.c_double]
    mpg.mpg123_getformat.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    mpg.mpg123_read.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t)]
    mpg.mpg123_close.argtypes = [ctypes.c_void_p]
    mpg.mpg123_delete.argtypes = [ctypes.c_void_p]

    lame.lame_init.restype = ctypes.c_void_p
    for fn in ("lame_set_in_samplerate", "lame_set_num_channels",
               "lame_set_quality", "lame_set_VBR", "lame_set_VBR_q",
               "lame_set_brate", "lame_init_params", "lame_close"):
        getattr(lame, fn).argtypes = [ctypes.c_void_p] + (
            [ctypes.c_int] if fn not in ("lame_init_params",
                                         "lame_close") else [])
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    lame.lame_encode_buffer_ieee_float.argtypes = [
        ctypes.c_void_p, f32p, f32p, ctypes.c_int, u8p, ctypes.c_int]
    lame.lame_encode_flush.argtypes = [ctypes.c_void_p, u8p,
                                       ctypes.c_int]
    _libs = (mpg, lame)
    return _libs


def available() -> bool:
    return bool(_load())


def is_mp3(head: bytes) -> bool:
    """ID3v2 tag or an MPEG audio frame sync (layer III)."""
    if head[:3] == b"ID3":
        return True
    if len(head) >= 2 and head[0] == 0xFF and (head[1] & 0xE0) == 0xE0:
        # MPEG sync; require a sane layer/version field
        return (head[1] & 0x18) != 0x08 and (head[1] & 0x06) != 0
    return False


def read_mp3(path: str) -> Tuple[np.ndarray, int, WavMetadata]:
    """Decode an MP3 -> ((channels, n) float32, rate, meta) through
    libmpg123 (float output, no quantization)."""
    libs = _load()
    if not libs:
        raise RuntimeError(
            "MP3 decoding needs the system libmpg123 (libmpg123.so.0); "
            "not found")
    mpg, _ = libs
    err = ctypes.c_int(0)
    h = mpg.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed ({err.value})")
    try:
        # force float BEFORE open: post-open mpg123_format() did not
        # take effect on this libmpg123 (output stayed s16)
        mpg.mpg123_param(h, _MPG123_ADD_FLAGS, _MPG123_FORCE_FLOAT, 0.0)
        if mpg.mpg123_open(h, path.encode()) != _MPG123_OK:
            raise Mp3FormatError(f"{path}: mpg123 cannot open")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        if mpg.mpg123_getformat(h, ctypes.byref(rate),
                                ctypes.byref(channels),
                                ctypes.byref(enc)) != _MPG123_OK:
            raise Mp3FormatError(f"{path}: mpg123 cannot read format")
        if enc.value != _MPG123_ENC_FLOAT_32:
            raise Mp3FormatError(
                f"{path}: mpg123 did not negotiate float output "
                f"(got encoding {enc.value:#x})")
        buf = (ctypes.c_ubyte * (1 << 18))()
        done = ctypes.c_size_t(0)
        chunks = []
        while True:
            rc = mpg.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(np.frombuffer(
                    bytes(buf[: done.value]), np.float32))
            if rc == _MPG123_DONE:
                break
            if rc not in (_MPG123_OK, _MPG123_NEW_FORMAT):
                raise Mp3FormatError(f"{path}: mpg123 read error {rc}")
        flat = (np.concatenate(chunks) if chunks
                else np.zeros(0, np.float32))
        ch = max(1, channels.value)
        n = len(flat) // ch
        audio = flat[: n * ch].reshape(n, ch).T.copy()
        meta = WavMetadata(container="MP3")
        return audio, int(rate.value), meta
    finally:
        mpg.mpg123_close(h)
        mpg.mpg123_delete(h)


def write_mp3(path: str, audio: np.ndarray, rate: int,
              meta: Optional[WavMetadata] = None,
              vbr_quality: int = 2) -> None:
    """Encode float32 audio ((ch, n) or (n,)) as MP3 through libmp3lame
    (VBR, quality 0=best..9; mono or stereo)."""
    libs = _load()
    if not libs:
        raise RuntimeError(
            "MP3 encoding needs the system libmp3lame "
            "(libmp3lame.so.0); not found")
    _, lame = libs
    x = np.atleast_2d(np.ascontiguousarray(audio, np.float32))
    channels, n = x.shape
    if channels > 2:
        raise ValueError("MP3 supports mono or stereo")
    gfp = lame.lame_init()
    try:
        lame.lame_set_in_samplerate(gfp, rate)
        lame.lame_set_num_channels(gfp, channels)
        lame.lame_set_quality(gfp, 2)
        lame.lame_set_VBR(gfp, 4)  # vbr_mtrh (LAME's default VBR mode)
        lame.lame_set_VBR_q(gfp, int(vbr_quality))
        if lame.lame_init_params(gfp) < 0:
            raise RuntimeError("lame_init_params failed")
        f32p = ctypes.POINTER(ctypes.c_float)
        left = x[0].ctypes.data_as(f32p)
        right = (x[1] if channels == 2 else x[0]).ctypes.data_as(f32p)
        outsz = int(1.25 * n + 7200)
        out = (ctypes.c_ubyte * outsz)()
        got = lame.lame_encode_buffer_ieee_float(
            gfp, left, right, n, out, outsz)
        if got < 0:
            raise RuntimeError(f"lame encode error {got}")
        blob = bytes(out[:got])
        got = lame.lame_encode_flush(gfp, out, outsz)
        if got > 0:
            blob += bytes(out[:got])
        with open(path, "wb") as f:
            f.write(blob)
    finally:
        lame.lame_close(gfp)
