"""ctypes bindings to the native host runtime (native/phaserotate_host.cc).

A copy of ``phaserotate_tpu/io/native.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy of the host-side (numpy/ctypes) file
layer.  Only these lines differ; ``tests/test_torch_io.py`` holds every
function here to its source.

Auto-builds the shared library on first use when a toolchain is present;
every binding has a numpy fallback so the framework works without it.
Check :data:`available` to know which path is active.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

__all__ = [
    "available",
    "peak",
    "rotated_peak",
    "deinterleave",
    "interleave",
    "pcm16_to_f32",
    "f32_to_pcm16",
    "pcm24_to_f32",
    "f32_to_pcm24",
    "flac_decode",
    "vorbis_decode",
    "pack_residual_raw",
    "Ring",
]

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libphaserotate_host.so")

_lib: Optional[ctypes.CDLL] = None


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            check=True, capture_output=True, timeout=120)
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i16p = ctypes.POINTER(ctypes.c_int16)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.prt_peak.restype = ctypes.c_float
    lib.prt_peak.argtypes = [f32p, ctypes.c_size_t, ctypes.c_float]
    lib.prt_rotated_peak.restype = ctypes.c_float
    lib.prt_rotated_peak.argtypes = [
        f32p, f32p, ctypes.c_size_t,
        ctypes.c_float, ctypes.c_float, ctypes.c_float]
    lib.prt_pcm16_to_f32.argtypes = [i16p, f32p, ctypes.c_size_t]
    lib.prt_f32_to_pcm16.argtypes = [f32p, i16p, ctypes.c_size_t]
    lib.prt_pcm24_to_f32.argtypes = [u8p, f32p, ctypes.c_size_t]
    lib.prt_f32_to_pcm24.argtypes = [f32p, u8p, ctypes.c_size_t]
    lib.prt_deinterleave.argtypes = [
        f32p, f32p, ctypes.c_size_t, ctypes.c_size_t]
    lib.prt_interleave.argtypes = [
        f32p, f32p, ctypes.c_size_t, ctypes.c_size_t]
    lib.prt_ring_new.restype = ctypes.c_void_p
    lib.prt_ring_new.argtypes = [ctypes.c_size_t]
    lib.prt_ring_free.argtypes = [ctypes.c_void_p]
    for fname in ("prt_ring_read_space", "prt_ring_write_space"):
        fn = getattr(lib, fname)
        fn.restype = ctypes.c_size_t
        fn.argtypes = [ctypes.c_void_p]
    lib.prt_ring_write.restype = ctypes.c_size_t
    lib.prt_ring_write.argtypes = [ctypes.c_void_p, f32p, ctypes.c_size_t]
    lib.prt_ring_read.restype = ctypes.c_size_t
    lib.prt_ring_read.argtypes = [ctypes.c_void_p, f32p, ctypes.c_size_t]
    try:  # added after the first library revision: absence is fine
        lib.prt_flac_decode.restype = ctypes.c_int64
        lib.prt_flac_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_int64]
    except AttributeError:
        pass
    i32p = ctypes.POINTER(ctypes.c_int32)
    try:  # round-5 addition (wire_pack.cc): absence is fine
        lib.prt_pack_residual.restype = ctypes.c_int64
        lib.prt_pack_residual.argtypes = [
            i16p, ctypes.c_int64, ctypes.c_int64,
            i32p, ctypes.c_int64, i32p, i32p, i32p]
    except AttributeError:
        pass
    try:  # round-5 addition (vorbis_decode.cc): absence is fine
        lib.prt_vorbis_decode.restype = ctypes.c_int64
        lib.prt_vorbis_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
    except AttributeError:
        pass
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def peak(buf: np.ndarray, current: float = 0.0) -> float:
    """SIMD max(|buf|) (dsp_compute_peak role)."""
    buf = np.ascontiguousarray(buf, np.float32)
    lib = _load()
    if lib is None:
        return float(max(current, np.abs(buf).max(initial=0.0)))
    return float(lib.prt_peak(_fptr(buf), buf.size, current))


def rotated_peak(b0: np.ndarray, b1: np.ndarray, ca: float, sa: float,
                 current: float = 0.0) -> float:
    b0 = np.ascontiguousarray(b0, np.float32)
    b1 = np.ascontiguousarray(b1, np.float32)
    lib = _load()
    if lib is None:
        return float(max(current, np.abs(ca * b0 + sa * b1).max(initial=0.0)))
    return float(lib.prt_rotated_peak(
        _fptr(b0), _fptr(b1), b0.size, ca, sa, current))


def deinterleave(interleaved: np.ndarray, channels: int) -> np.ndarray:
    """(frames*channels,) interleaved -> (channels, frames) planar."""
    x = np.ascontiguousarray(interleaved, np.float32)
    frames = x.size // channels
    lib = _load()
    if lib is None:
        return x[: frames * channels].reshape(frames, channels).T.copy()
    out = np.empty((channels, frames), np.float32)
    lib.prt_deinterleave(_fptr(x), _fptr(out), frames, channels)
    return out


def interleave(planar: np.ndarray) -> np.ndarray:
    """(channels, frames) -> (frames*channels,) interleaved."""
    x = np.ascontiguousarray(planar, np.float32)
    channels, frames = x.shape
    lib = _load()
    if lib is None:
        return x.T.reshape(-1).copy()
    out = np.empty(frames * channels, np.float32)
    lib.prt_interleave(_fptr(x), _fptr(out), frames, channels)
    return out


def pcm16_to_f32(pcm: np.ndarray) -> np.ndarray:
    pcm = np.ascontiguousarray(pcm, np.int16)
    lib = _load()
    if lib is None:
        return pcm.astype(np.float32) / 32768.0
    out = np.empty(pcm.size, np.float32)
    lib.prt_pcm16_to_f32(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), _fptr(out),
        pcm.size)
    return out


def f32_to_pcm16(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, np.float32)
    lib = _load()
    if lib is None:
        return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    out = np.empty(x.size, np.int16)
    lib.prt_f32_to_pcm16(
        _fptr(x), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), x.size)
    return out


def pcm24_to_f32(raw: np.ndarray) -> np.ndarray:
    """(3*n,) uint8 packed little-endian 24-bit PCM -> (n,) float32."""
    raw = np.ascontiguousarray(raw, np.uint8)
    n = raw.size // 3
    lib = _load()
    if lib is None:
        b = raw[: 3 * n].reshape(-1, 3)
        v = (b[:, 0].astype(np.int32)
             | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        v = np.where(v & 0x800000, v - 0x1000000, v)
        return v.astype(np.float32) / 8388608.0
    out = np.empty(n, np.float32)
    lib.prt_pcm24_to_f32(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _fptr(out), n)
    return out


def f32_to_pcm24(x: np.ndarray) -> np.ndarray:
    """(n,) float32 -> (3*n,) uint8 packed little-endian 24-bit PCM."""
    x = np.ascontiguousarray(x, np.float32)
    lib = _load()
    if lib is None:
        v = np.clip(np.round(x * 8388608.0), -8388608,
                    8388607).astype(np.int32)
        out = np.empty((x.size, 3), np.uint8)
        out[:, 0] = v & 0xFF
        out[:, 1] = (v >> 8) & 0xFF
        out[:, 2] = (v >> 16) & 0xFF
        return out.reshape(-1)
    out = np.empty(3 * x.size, np.uint8)
    lib.prt_f32_to_pcm24(
        _fptr(x), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        x.size)
    return out


def flac_decode(data: bytes, frame_start: int, channels: int,
                stream_bits: int, total: int) -> Optional[np.ndarray]:
    """Decode the frame section of a FLAC stream natively.

    Returns (channels, decoded) int32 planar samples, or None when the
    native library is unavailable or the decoder reports any error —
    the caller then uses the pure-Python reference decoder (which also
    owns the error-message surface for corrupt files).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "prt_flac_decode"):
        return None
    # frames may legally run past STREAMINFO's total (the Python
    # decoder truncates afterwards): leave one max-blocksize of margin
    stride = int(total) + 65536
    out = np.empty((channels, stride), np.int32)
    buf = np.frombuffer(data, np.uint8)
    rc = int(lib.prt_flac_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        frame_start, channels, stream_bits,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), stride,
        int(total)))
    if rc < 0:
        return None
    return out[:, :rc]


def vorbis_decode(data: bytes, channels: int, rate: int,
                  max_frames: int) -> Optional[np.ndarray]:
    """Decode a whole Ogg Vorbis stream natively (vorbis_decode.cc).

    ``channels``/``rate`` come from the caller's header probe and
    ``max_frames`` bounds the output (final granule + slack).  Returns
    (channels, frames) float32, or None when the native library is
    unavailable or the decoder reports any error — the caller then uses
    the pure-Python reference decoder (io/vorbis.py), which also owns
    the error-message surface for corrupt files.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "prt_vorbis_decode"):
        return None
    if channels < 1 or max_frames < 0:
        return None
    out = np.empty((channels, max_frames), np.float32)
    buf = np.frombuffer(data, np.uint8)
    rc = int(lib.prt_vorbis_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        _fptr(out), max_frames, channels, rate))
    if rc < 0:
        return None
    return out[:, :rc]


def pack_residual_raw(x16: np.ndarray, words: np.ndarray,
                      widths: np.ndarray, woffs: np.ndarray,
                      order: np.ndarray) -> int:
    """Native residual wire pack (wire_pack.cc) into caller buffers.

    ``x16`` is (S, n) int16; the out arrays must be C-contiguous int32
    of shapes (cap,), (S, nb), (S, nb), (S,).  Returns total words
    written, or -1 when the native library lacks the entry point (the
    caller then uses the numpy reference pack in search/packed.py).
    ctypes releases the GIL for the call's duration, so a fleet's pack
    overlaps the previous chunk's host->device transfer.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "prt_pack_residual"):
        return -1
    i32p = ctypes.POINTER(ctypes.c_int32)
    S, n = x16.shape
    return int(lib.prt_pack_residual(
        x16.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), S, n,
        words.ctypes.data_as(i32p), words.size,
        widths.ctypes.data_as(i32p), woffs.ctypes.data_as(i32p),
        order.ctypes.data_as(i32p)))


class Ring:
    """Lock-free SPSC float ring buffer (native; numpy deque fallback)."""

    def __init__(self, capacity: int):
        self._lib = _load()
        if self._lib is not None:
            self._h = self._lib.prt_ring_new(capacity)
        else:
            from collections import deque

            self._q = deque()
            self._cap = capacity

    def write(self, data: np.ndarray) -> int:
        data = np.ascontiguousarray(data, np.float32)
        if self._lib is not None:
            return int(self._lib.prt_ring_write(self._h, _fptr(data),
                                                data.size))
        n = min(data.size, self._cap - len(self._q))
        self._q.extend(data[:n].tolist())
        return n

    def read(self, n: int) -> np.ndarray:
        if self._lib is not None:
            out = np.empty(n, np.float32)
            got = int(self._lib.prt_ring_read(self._h, _fptr(out), n))
            return out[:got]
        got = min(n, len(self._q))
        return np.array([self._q.popleft() for _ in range(got)], np.float32)

    @property
    def read_space(self) -> int:
        if self._lib is not None:
            return int(self._lib.prt_ring_read_space(self._h))
        return len(self._q)

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._h:
            self._lib.prt_ring_free(self._h)
            self._h = None
