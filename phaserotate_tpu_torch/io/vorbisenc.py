"""ctypes bindings to the system Vorbis libraries.

A copy of ``phaserotate_tpu/io/vorbisenc.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy of the host-side (numpy/ctypes) file
layer.  Only these lines differ; ``tests/test_torch_io.py`` holds every
function here to its source.

Role split (mirrors the reference's reliance on system codecs via
libsndfile, cli/phase-rotate.cc:33):

* **write_ogg** — production .ogg *encode* path through libvorbisenc
  (psychoacoustic encoding is out of scope for a DSP framework; the
  system encoder is the right tool, exactly as libsndfile uses it).
* **decode_ogg_ref** — a *reference* decoder through libvorbisfile,
  used by tests to cross-check the framework's own pure-Python decoder
  (io/vorbis.py), which owns the production read path.

Everything degrades cleanly: :func:`available` is False when the
shared libraries are missing and callers raise a clear error.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional, Tuple

import numpy as np

__all__ = ["available", "write_ogg", "decode_ogg_ref"]


class _OggPacket(ctypes.Structure):
    _fields_ = [
        ("packet", ctypes.POINTER(ctypes.c_ubyte)),
        ("bytes", ctypes.c_long),
        ("b_o_s", ctypes.c_long),
        ("e_o_s", ctypes.c_long),
        ("granulepos", ctypes.c_int64),
        ("packetno", ctypes.c_int64),
    ]


class _OggPage(ctypes.Structure):
    _fields_ = [
        ("header", ctypes.POINTER(ctypes.c_ubyte)),
        ("header_len", ctypes.c_long),
        ("body", ctypes.POINTER(ctypes.c_ubyte)),
        ("body_len", ctypes.c_long),
    ]


# opaque library state: allocated oversized, initialized by the library
class _Opaque1k(ctypes.Structure):
    _fields_ = [("_", ctypes.c_ubyte * 1024)]


class _Opaque4k(ctypes.Structure):
    _fields_ = [("_", ctypes.c_ubyte * 4096)]


_libs: Optional[Tuple] = None


def _load():
    global _libs
    if _libs is not None:
        return _libs
    try:
        ogg = ctypes.CDLL("libogg.so.0")
        vorbis = ctypes.CDLL("libvorbis.so.0")
        venc = ctypes.CDLL("libvorbisenc.so.2")
        vfile = ctypes.CDLL("libvorbisfile.so.3")
    except OSError:
        _libs = ()
        return _libs

    vorbis.vorbis_analysis_buffer.restype = ctypes.POINTER(
        ctypes.POINTER(ctypes.c_float))
    _libs = (ogg, vorbis, venc, vfile)
    return _libs


def available() -> bool:
    return bool(_load())


def write_ogg(path: str, audio: np.ndarray, rate: int,
              quality: float = 0.4,
              comments: Optional[dict] = None) -> None:
    """Encode float32 audio ((ch, n) or (n,)) as an Ogg Vorbis file via
    libvorbisenc (VBR, ``quality`` in [-0.1, 1.0])."""
    libs = _load()
    if not libs:
        raise RuntimeError(
            "Ogg Vorbis encoding needs the system libvorbisenc "
            "(libvorbisenc.so.2); not found")
    ogg, vorbis, venc, _ = libs

    x = np.atleast_2d(np.ascontiguousarray(audio, np.float32))
    channels, n = x.shape

    vi = _Opaque1k()
    vorbis.vorbis_info_init(ctypes.byref(vi))
    rc = venc.vorbis_encode_init_vbr(
        ctypes.byref(vi), ctypes.c_long(channels), ctypes.c_long(rate),
        ctypes.c_float(quality))
    if rc:
        vorbis.vorbis_info_clear(ctypes.byref(vi))
        raise RuntimeError(f"vorbis_encode_init_vbr failed ({rc})")

    vc = _Opaque1k()
    vorbis.vorbis_comment_init(ctypes.byref(vc))
    for key, val in (comments or {}).items():
        vorbis.vorbis_comment_add_tag(
            ctypes.byref(vc), str(key).encode(), str(val).encode())

    vd = _Opaque4k()
    vb = _Opaque4k()
    vorbis.vorbis_analysis_init(ctypes.byref(vd), ctypes.byref(vi))
    vorbis.vorbis_block_init(ctypes.byref(vd), ctypes.byref(vb))

    os_ = _Opaque1k()
    ogg.ogg_stream_init(ctypes.byref(os_), 1)

    out = bytearray()
    page = _OggPage()

    def _flush_pages(force: bool) -> None:
        fn = ogg.ogg_stream_flush if force else ogg.ogg_stream_pageout
        while fn(ctypes.byref(os_), ctypes.byref(page)):
            out.extend(ctypes.string_at(page.header, page.header_len))
            out.extend(ctypes.string_at(page.body, page.body_len))

    hdr = _OggPacket()
    hdr_comm = _OggPacket()
    hdr_code = _OggPacket()
    vorbis.vorbis_analysis_headerout(
        ctypes.byref(vd), ctypes.byref(vc), ctypes.byref(hdr),
        ctypes.byref(hdr_comm), ctypes.byref(hdr_code))
    for pk in (hdr, hdr_comm, hdr_code):
        ogg.ogg_stream_packetin(ctypes.byref(os_), ctypes.byref(pk))
    _flush_pages(True)  # headers end on their own page (spec)

    pk = _OggPacket()
    chunk = 4096
    pos = 0
    while True:
        todo = min(chunk, n - pos)
        buf = vorbis.vorbis_analysis_buffer(ctypes.byref(vd), chunk)
        if todo > 0:
            for c in range(channels):
                ctypes.memmove(buf[c], x[c, pos : pos + todo].ctypes.data,
                               4 * todo)
        vorbis.vorbis_analysis_wrote(ctypes.byref(vd), todo)
        pos += todo
        while vorbis.vorbis_analysis_blockout(
                ctypes.byref(vd), ctypes.byref(vb)) == 1:
            vorbis.vorbis_analysis(ctypes.byref(vb), None)
            vorbis.vorbis_bitrate_addblock(ctypes.byref(vb))
            while vorbis.vorbis_bitrate_flushpacket(
                    ctypes.byref(vd), ctypes.byref(pk)) == 1:
                ogg.ogg_stream_packetin(ctypes.byref(os_),
                                        ctypes.byref(pk))
                _flush_pages(False)
        if todo == 0:
            break
    _flush_pages(True)

    ogg.ogg_stream_clear(ctypes.byref(os_))
    vorbis.vorbis_block_clear(ctypes.byref(vb))
    vorbis.vorbis_dsp_clear(ctypes.byref(vd))
    vorbis.vorbis_comment_clear(ctypes.byref(vc))
    vorbis.vorbis_info_clear(ctypes.byref(vi))

    with open(path, "wb") as f:
        f.write(bytes(out))


def decode_ogg_ref(path: str) -> Tuple[np.ndarray, int]:
    """Reference decode via libvorbisfile (ov_fopen/ov_read_float):
    -> ((channels, n) float32, rate).  Test oracle for io/vorbis.py."""
    libs = _load()
    if not libs:
        raise RuntimeError(
            "reference Ogg decode needs libvorbisfile.so.3; not found")
    _, vorbis, _, vfile = libs

    vf = ctypes.create_string_buffer(1024)  # OggVorbis_File (opaque)
    rc = vfile.ov_fopen(path.encode(), vf)
    if rc:
        raise RuntimeError(f"ov_fopen failed ({rc})")
    try:
        class _VorbisInfoHead(ctypes.Structure):
            _fields_ = [("version", ctypes.c_int),
                        ("channels", ctypes.c_int),
                        ("rate", ctypes.c_long)]

        vfile.ov_info.restype = ctypes.POINTER(_VorbisInfoHead)
        info = vfile.ov_info(vf, -1).contents
        channels, rate = info.channels, int(info.rate)

        chunks = []
        pcm = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))()
        bitstream = ctypes.c_int(0)
        while True:
            got = vfile.ov_read_float(vf, ctypes.byref(pcm), 4096,
                                      ctypes.byref(bitstream))
            if got <= 0:
                break
            block = np.empty((channels, got), np.float32)
            for c in range(channels):
                block[c] = np.ctypeslib.as_array(pcm[c], (got,))
            chunks.append(block)
        audio = (np.concatenate(chunks, axis=1) if chunks
                 else np.zeros((channels, 0), np.float32))
        return audio, rate
    finally:
        vfile.ov_clear(vf)
