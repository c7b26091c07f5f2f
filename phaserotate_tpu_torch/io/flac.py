"""FLAC codec (pure Python/numpy — no external libraries).

A copy of ``phaserotate_tpu/io/flac.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy of the host-side (numpy/ctypes) file
layer.  Only these lines differ; ``tests/test_torch_io.py`` holds every
function here to its source.

The reference reads anything libsndfile can open (cli/phase-rotate.cc:33
``sf_open``); FLAC is the lossless interchange format mastering workflows
actually exchange, so the framework carries its own codec:

* **Decoder**: the full frame spec subset real encoders emit — CONSTANT /
  VERBATIM / FIXED (orders 0-4) / LPC (orders 1-32) subframes, wasted
  bits, partitioned Rice residuals (both 4- and 5-bit parameter methods,
  escape codes), all channel assignments (independent, left/side,
  right/side, mid/side), 8/16/20/24/32-bit samples, frame-header CRC-8
  and frame CRC-16 verification.
* **Encoder**: LPC (orders <= 12, Levinson-Durbin on a Welch-windowed
  autocorrelation, 15-bit quantized coefficients with error feedback)
  with FIXED predictors (orders 0-4) as candidates, per-frame model
  search by exact Rice cost, per-partition Rice parameter selection —
  genuinely compressed, spec-conformant output (decodable by any FLAC
  reader), 16/24-bit.

Layout follows the public FLAC format specification (xiph.org/flac);
this is an independent implementation, not derived from libFLAC.
"""

from __future__ import annotations

import hashlib
import struct
from typing import List, Optional, Tuple

import numpy as np

from .wav import WavMetadata

__all__ = ["is_flac", "read_flac", "write_flac", "FlacFormatError"]


class FlacFormatError(ValueError):
    pass


def is_flac(head: bytes) -> bool:
    return head[:4] == b"fLaC"


# ---- CRCs (FLAC frame polynomials) ----------------------------------------

def _make_crc8_table() -> np.ndarray:
    tbl = np.zeros(256, np.uint16)
    for i in range(256):
        c = i
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
        tbl[i] = c
    return tbl.astype(np.uint8)


def _make_crc16_table() -> np.ndarray:
    tbl = np.zeros(256, np.uint32)
    for i in range(256):
        c = i << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 \
                else (c << 1) & 0xFFFF
        tbl[i] = c
    return tbl.astype(np.uint16)


_CRC8 = _make_crc8_table()
_CRC16 = _make_crc16_table()


def _crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC8[c ^ b]
    return int(c)


def _crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = ((c << 8) & 0xFFFF) ^ int(_CRC16[((c >> 8) ^ b) & 0xFF])
    return c


# ---- bit I/O ---------------------------------------------------------------

class _BitReader:
    """MSB-first bit reader over a bytes buffer."""

    def __init__(self, data: bytes, pos_bytes: int = 0):
        self.data = data
        self.pos = pos_bytes * 8  # absolute bit position

    def byte_pos(self) -> int:
        return self.pos >> 3

    def read_uint(self, n: int) -> int:
        if n == 0:
            return 0
        pos, data = self.pos, self.data
        end = pos + n
        if end > len(data) * 8:
            raise FlacFormatError("truncated FLAC stream")
        first, last = pos >> 3, (end + 7) >> 3
        acc = int.from_bytes(data[first:last], "big")
        acc >>= (last * 8) - end
        self.pos = end
        return acc & ((1 << n) - 1)

    def read_signed(self, n: int) -> int:
        v = self.read_uint(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def read_unary(self) -> int:
        """Count 0 bits until the terminating 1."""
        data = self.data
        q = 0
        pos = self.pos
        nbits = len(data) * 8
        while True:
            if pos >= nbits:
                raise FlacFormatError("truncated unary code")
            byte = data[pos >> 3]
            rem = 8 - (pos & 7)
            chunk = byte & ((1 << rem) - 1)
            if chunk == 0:
                q += rem
                pos += rem
                continue
            lead = rem - chunk.bit_length()
            q += lead
            pos += lead + 1
            self.pos = pos
            return q

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7


class _BitWriter:
    def __init__(self):
        self.chunks: List[Tuple[int, int]] = []  # (value, nbits)
        self.nbits = 0

    def write_uint(self, value: int, n: int) -> None:
        if n:
            self.chunks.append((value & ((1 << n) - 1), n))
            self.nbits += n

    def write_unary(self, q: int) -> None:
        self.write_uint(1, q + 1)  # q zeros then a 1

    def align(self) -> None:
        pad = (-self.nbits) % 8
        if pad:
            self.write_uint(0, pad)

    def tobytes(self) -> bytes:
        acc = 0
        for value, n in self.chunks:
            acc = (acc << n) | value
        total = self.nbits
        pad = (-total) % 8
        acc <<= pad
        return acc.to_bytes((total + pad) // 8, "big")


# ---- decoder ---------------------------------------------------------------

_BLOCKSIZE_CODE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                   8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                   13: 8192, 14: 16384, 15: 32768}
_RATE_CODE = {0: None, 1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
              6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}
_BITS_CODE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


def _read_utf8_number(br: _BitReader) -> int:
    first = br.read_uint(8)
    if first < 0x80:
        return first
    n = 0
    probe = first
    while probe & 0x40:
        n += 1
        probe <<= 1
    v = first & (0x3F >> n)
    for _ in range(n):
        c = br.read_uint(8)
        if (c & 0xC0) != 0x80:
            raise FlacFormatError("bad UTF-8 coded number")
        v = (v << 6) | (c & 0x3F)
    return v


def _read_residual(br: _BitReader, blocksize: int, order: int) -> np.ndarray:
    method = br.read_uint(2)
    if method > 1:
        raise FlacFormatError(f"reserved residual method {method}")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    part_order = br.read_uint(4)
    nparts = 1 << part_order
    if blocksize % nparts:
        raise FlacFormatError("partition order does not divide blocksize")
    out = np.empty(blocksize - order, np.int64)
    idx = 0
    for p in range(nparts):
        n = (blocksize >> part_order) - (order if p == 0 else 0)
        param = br.read_uint(plen)
        if param == escape:
            raw_bits = br.read_uint(5)
            for i in range(n):
                out[idx + i] = br.read_signed(raw_bits) if raw_bits else 0
        else:
            for i in range(n):
                q = br.read_unary()
                v = (q << param) | br.read_uint(param) if param else q
                out[idx + i] = (v >> 1) ^ -(v & 1)  # zigzag
        idx += n
    return out


_FIXED_COEF = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _predict_fixed(order: int, warmup: np.ndarray,
                   resid: np.ndarray, blocksize: int) -> np.ndarray:
    out = np.empty(blocksize, np.int64)
    out[:order] = warmup
    if order == 0:
        out[:] = resid
        return out
    coef = _FIXED_COEF[order]
    # int64 wraparound on corrupt streams is deliberate: the garbage
    # samples fail the frame CRC-16 check right after decode
    with np.errstate(over="ignore"):
        for i in range(order, blocksize):
            acc = resid[i - order]
            for j, c in enumerate(coef):
                acc += c * out[i - 1 - j]
            out[i] = acc
    return out


def _predict_lpc(order: int, warmup: np.ndarray, coefs: List[int],
                 shift: int, resid: np.ndarray,
                 blocksize: int) -> np.ndarray:
    out = np.empty(blocksize, np.int64)
    out[:order] = warmup
    o = [int(w) for w in warmup]
    lim = 1 << 40  # far beyond any 32-bit sample: corrupt stream
    for i in range(order, blocksize):
        acc = 0
        for j in range(order):
            acc += coefs[j] * o[-1 - j]
        v = int(resid[i - order]) + (acc >> shift)
        if not -lim < v < lim:  # diverging prediction = corruption
            raise FlacFormatError("LPC prediction out of sample range")
        o.append(v)
        if len(o) > order:
            o.pop(0)
        out[i] = v
    return out


def _read_subframe(br: _BitReader, blocksize: int,
                   bits: int) -> np.ndarray:
    if br.read_uint(1):
        raise FlacFormatError("subframe padding bit set")
    ftype = br.read_uint(6)
    wasted = 0
    if br.read_uint(1):
        wasted = br.read_unary() + 1
        bits -= wasted
    if ftype == 0:  # CONSTANT
        v = br.read_signed(bits)
        out = np.full(blocksize, v, np.int64)
    elif ftype == 1:  # VERBATIM
        out = np.array([br.read_signed(bits) for _ in range(blocksize)],
                       np.int64)
    elif 8 <= ftype <= 12:  # FIXED order 0-4
        order = ftype - 8
        warm = np.array([br.read_signed(bits) for _ in range(order)],
                        np.int64)
        resid = _read_residual(br, blocksize, order)
        out = _predict_fixed(order, warm, resid, blocksize)
    elif ftype >= 32:  # LPC order 1-32
        order = (ftype & 0x1F) + 1
        warm = np.array([br.read_signed(bits) for _ in range(order)],
                        np.int64)
        prec = br.read_uint(4)
        if prec == 15:
            raise FlacFormatError("invalid LPC precision")
        prec += 1
        shift = br.read_signed(5)
        if shift < 0:
            raise FlacFormatError("negative LPC shift")
        coefs = [br.read_signed(prec) for _ in range(order)]
        resid = _read_residual(br, blocksize, order)
        out = _predict_lpc(order, warm, coefs, shift, resid, blocksize)
    else:
        raise FlacFormatError(f"reserved subframe type {ftype}")
    if wasted:
        out <<= wasted
    return out


def _read_flac_header(data: bytes):
    """Parse the metadata section -> (frame_pos, rate, channels, bits,
    total, meta) — shared by the float and raw-PCM readers."""
    if not is_flac(data):
        raise FlacFormatError("not a FLAC stream")

    pos = 4
    streaminfo = None
    meta = WavMetadata(container="FLAC")
    while True:
        if pos + 4 > len(data):
            raise FlacFormatError("truncated metadata")
        hdr = data[pos]
        last, btype = hdr & 0x80, hdr & 0x7F
        blen = int.from_bytes(data[pos + 1 : pos + 4], "big")
        body = data[pos + 4 : pos + 4 + blen]
        if len(body) != blen:
            raise FlacFormatError("truncated metadata block")
        if btype == 0:
            streaminfo = body
        elif btype == 4:
            _parse_vorbis_comment(body, meta)
        pos += 4 + blen
        if last:
            break
    if streaminfo is None or len(streaminfo) < 34:
        raise FlacFormatError("missing STREAMINFO")

    br = _BitReader(streaminfo)
    br.read_uint(16)  # min blocksize
    br.read_uint(16)  # max blocksize
    br.read_uint(24)
    br.read_uint(24)  # min/max framesize
    rate = br.read_uint(20)
    channels = br.read_uint(3) + 1
    bits = br.read_uint(5) + 1
    total = br.read_uint(36)
    if rate == 0:
        raise FlacFormatError("invalid sample rate")
    return pos, rate, channels, bits, total, meta


def read_flac(path: str) -> Tuple[np.ndarray, int, WavMetadata]:
    """Decode a FLAC file -> ((channels, n) float32 in [-1, 1], rate,
    metadata).  Vorbis comments map onto the INFO string table the WAV
    metadata carries (TITLE->INAM etc.)."""
    with open(path, "rb") as f:
        data = f.read()
    pos, rate, channels, bits, total, meta = _read_flac_header(data)

    audio = None
    if total:
        # fast path: native frame decoder (native/flac_decode.cc); any
        # decode error falls through to the pure-Python reference
        # decoder below, which owns the exact error messages
        from . import native as _native

        audio = _native.flac_decode(data, pos, channels, bits, total)
    if audio is None:
        chans: List[List[np.ndarray]] = [[] for _ in range(channels)]
        decoded = 0
        while pos < len(data) and (total == 0 or decoded < total):
            pos, block = _read_frame(data, pos, channels, bits)
            for c in range(channels):
                chans[c].append(block[c])
            decoded += block.shape[1]

        if decoded:
            audio = np.concatenate(
                [np.concatenate(ch)[None] for ch in chans], axis=0)
        else:  # zero-frame stream (e.g. an empty encode): valid, empty
            audio = np.zeros((channels, 0), np.int64)
    if total:
        audio = audio[:, :total]
    scale = float(1 << (bits - 1))
    return (audio.astype(np.float32) / scale, rate, meta)


def read_flac_pcm16(path: str) -> Tuple[np.ndarray, int, WavMetadata]:
    """Decode a 16-bit FLAC straight to int16 PCM (no host floats).

    Returns ``((channels, n) int16, rate, metadata)`` — the raw-PCM
    ingest path for device-side dequantization.  Requires a 16-bit
    stream with a known total and the native decoder; raises
    FlacFormatError otherwise (callers fall back to :func:`read_flac`
    + quantize, which is value-identical for 16-bit sources).
    """
    with open(path, "rb") as f:
        data = f.read()
    pos, rate, channels, bits, total, meta = _read_flac_header(data)
    if bits != 16:
        raise FlacFormatError(f"{path}: not a 16-bit stream ({bits} bit)")
    if not total:
        raise FlacFormatError(f"{path}: unknown total sample count")
    from . import native as _native

    audio = _native.flac_decode(data, pos, channels, bits, total)
    if audio is None:
        raise FlacFormatError(f"{path}: native FLAC decode unavailable")
    return audio[:, :total].astype(np.int16), rate, meta


def _read_frame(data: bytes, pos: int, channels: int,
                stream_bits: int) -> Tuple[int, np.ndarray]:
    br = _BitReader(data, pos)
    sync = br.read_uint(14)
    if sync != 0x3FFE:
        raise FlacFormatError(f"bad frame sync at byte {pos}")
    br.read_uint(1)  # reserved
    br.read_uint(1)  # blocking strategy
    bs_code = br.read_uint(4)
    sr_code = br.read_uint(4)
    ch_code = br.read_uint(4)
    bits_code = br.read_uint(3)
    br.read_uint(1)  # reserved
    _read_utf8_number(br)  # frame/sample number

    if bs_code == 0:
        raise FlacFormatError("reserved blocksize code")
    elif bs_code == 6:
        blocksize = br.read_uint(8) + 1
    elif bs_code == 7:
        blocksize = br.read_uint(16) + 1
    else:
        blocksize = _BLOCKSIZE_CODE[bs_code]
    if sr_code == 12:
        br.read_uint(8)
    elif sr_code in (13, 14):
        br.read_uint(16)
    elif sr_code == 15:
        raise FlacFormatError("invalid sample rate code")
    bits = _BITS_CODE.get(bits_code, stream_bits) if bits_code \
        else stream_bits

    crc_end = br.byte_pos()
    hdr_crc = br.read_uint(8)
    if _crc8(data[pos:crc_end]) != hdr_crc:
        raise FlacFormatError("frame header CRC mismatch")

    if ch_code < 8:
        n_sub = ch_code + 1
        if n_sub != channels:
            raise FlacFormatError("channel count mismatch")
        subs = [_read_subframe(br, blocksize, bits)
                for _ in range(n_sub)]
        block = np.stack(subs)
    elif ch_code in (8, 9, 10):
        if channels != 2:
            raise FlacFormatError("stereo decorrelation in non-stereo")
        # side channel carries one extra bit
        if ch_code == 8:  # left/side
            left = _read_subframe(br, blocksize, bits)
            side = _read_subframe(br, blocksize, bits + 1)
            block = np.stack([left, left - side])
        elif ch_code == 9:  # right/side
            side = _read_subframe(br, blocksize, bits + 1)
            right = _read_subframe(br, blocksize, bits)
            block = np.stack([right + side, right])
        else:  # mid/side
            mid = _read_subframe(br, blocksize, bits)
            side = _read_subframe(br, blocksize, bits + 1)
            left = ((mid << 1) | (side & 1)) + side
            block = np.stack([left >> 1, (left >> 1) - side])
    else:
        raise FlacFormatError(f"reserved channel assignment {ch_code}")

    br.align()
    frame_end = br.byte_pos()
    crc = br.read_uint(16)
    if _crc16(data[pos:frame_end]) != crc:
        raise FlacFormatError("frame CRC-16 mismatch")
    return br.byte_pos(), block


_VORBIS_TO_INFO = {
    "TITLE": b"INAM", "ARTIST": b"IART", "ALBUM": b"IPRD",
    "DATE": b"ICRD", "GENRE": b"IGNR", "COMMENT": b"ICMT",
    "COPYRIGHT": b"ICOP", "TRACKNUMBER": b"ITRK",
}
_INFO_TO_VORBIS = {v: k for k, v in _VORBIS_TO_INFO.items()}


def _parse_vorbis_comment(body: bytes, meta: WavMetadata) -> None:
    try:
        (vlen,) = struct.unpack_from("<I", body, 0)
        off = 4 + vlen
        (count,) = struct.unpack_from("<I", body, off)
        off += 4
        for _ in range(count):
            (clen,) = struct.unpack_from("<I", body, off)
            off += 4
            entry = body[off : off + clen].decode("utf-8", "replace")
            off += clen
            if "=" in entry:
                key, val = entry.split("=", 1)
                tag = _VORBIS_TO_INFO.get(key.upper())
                if tag:
                    meta.info[tag] = val
    except (struct.error, IndexError):
        pass  # malformed comments are non-fatal (audio still decodes)


# ---- encoder ---------------------------------------------------------------

def _write_utf8_number(bw: _BitWriter, v: int) -> None:
    if v < 0x80:
        bw.write_uint(v, 8)
        return
    # n continuation bytes hold 6n bits; the lead byte starts with
    # n+1 one-bits then a zero and holds the remaining 6-n value bits
    for n in range(1, 7):
        if v < (1 << (6 + 5 * n)) or n == 6:
            break
    lead = (0xFF00 >> (n + 1)) & 0xFF
    bw.write_uint((lead | (v >> (6 * n))) & 0xFF, 8)
    for i in range(n - 1, -1, -1):
        bw.write_uint(0x80 | ((v >> (6 * i)) & 0x3F), 8)


def _best_rice_param(resid: np.ndarray) -> int:
    """Parameter minimizing the Rice-coded size (computed exactly from
    the zigzagged magnitudes)."""
    z = (np.abs(resid.astype(np.int64)) << 1) - (resid < 0)
    best_k, best_cost = 0, None
    for k in range(0, 30):
        cost = int(np.sum(z >> k)) + (k + 1) * len(z)
        if best_cost is None or cost < best_cost:
            best_k, best_cost = k, cost
        elif cost > best_cost * 2:
            break
    return best_k


def _write_residual(bw: _BitWriter, resid: np.ndarray, order: int,
                    blocksize: int) -> None:
    """Method 0 (4-bit params), partition order chosen so partitions are
    ~256 samples (a common encoder default)."""
    part_order = 0
    while (blocksize >> (part_order + 1)) >= 256 and \
            blocksize % (1 << (part_order + 1)) == 0 and \
            (blocksize >> (part_order + 1)) > order:
        part_order += 1
    bw.write_uint(0, 2)  # method 0
    bw.write_uint(part_order, 4)
    nparts = 1 << part_order
    idx = 0
    for p in range(nparts):
        n = (blocksize >> part_order) - (order if p == 0 else 0)
        part = resid[idx : idx + n]
        idx += n
        k = min(_best_rice_param(part), 14)
        bw.write_uint(k, 4)
        z = (np.abs(part.astype(np.int64)) << 1) - (part < 0)
        for v in z:
            v = int(v)
            bw.write_unary(v >> k)
            if k:
                bw.write_uint(v & ((1 << k) - 1), k)


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    r = x.astype(np.int64)
    for _ in range(order):
        r = np.diff(r)
    return r


def _partition_order(bs: int, order: int) -> int:
    """Partition order used by _write_residual (partitions ~256
    samples) — shared so cost estimates match what gets written."""
    po = 0
    while (bs >> (po + 1)) >= 256 and bs % (1 << (po + 1)) == 0 and \
            (bs >> (po + 1)) > order:
        po += 1
    return po


def _residual_cost(resid: np.ndarray, order: int, bs: int) -> int:
    """Exact Rice-coded bit count _write_residual would produce."""
    po = _partition_order(bs, order)
    cost = 2 + 4 + 4 * (1 << po)  # method + order + per-partition params
    idx = 0
    for p in range(1 << po):
        n = (bs >> po) - (order if p == 0 else 0)
        part = resid[idx : idx + n]
        idx += n
        k = min(_best_rice_param(part), 14)
        z = (np.abs(part.astype(np.int64)) << 1) - (part < 0)
        cost += int(np.sum(z >> k)) + (k + 1) * len(z)
    return cost


_MAX_LPC_ORDER = 12
_LPC_PRECISION = 15  # quantized coefficient bits (qlp precision)


def _lpc_analyze(x: np.ndarray, max_order: int):
    """Welch-windowed autocorrelation + Levinson-Durbin.

    Returns (coefs_per_order, err_per_order): float64 LPC coefficients
    and prediction-error energies for orders 1..max_order."""
    n = len(x)
    w = 1.0 - (2.0 * np.arange(n) / (n - 1) - 1.0) ** 2  # Welch window
    xf = x.astype(np.float64) * w
    auto = np.empty(max_order + 1)
    for lag in range(max_order + 1):
        auto[lag] = np.dot(xf[: n - lag], xf[lag:])
    if auto[0] == 0.0:
        return [], []
    err = auto[0]
    lpc = np.zeros(max_order)
    coefs, errs = [], []
    for i in range(max_order):
        acc = auto[i + 1]
        for j in range(i):
            acc -= lpc[j] * auto[i - j]
        k = acc / err
        lpc[i] = k
        half = i >> 1
        for j in range(half):
            t = lpc[j]
            lpc[j] = t - k * lpc[i - 1 - j]
            lpc[i - 1 - j] -= k * t
        if i & 1:
            lpc[half] -= k * lpc[half]
        err *= 1.0 - k * k
        coefs.append(lpc[: i + 1].copy())
        errs.append(max(err, 0.0))
    return coefs, errs


def _quantize_lpc(coefs: np.ndarray, precision: int):
    """-> (qcoefs int list, shift) with error-feedback rounding, or
    None when the coefficients cannot be represented."""
    cmax = float(np.max(np.abs(coefs)))
    if cmax <= 0.0 or not np.isfinite(cmax):
        return None
    # largest shift keeping every quantized value within precision bits
    log2cmax = int(np.floor(np.log2(cmax)))
    shift = precision - 1 - log2cmax - 1
    if shift > 15:
        shift = 15  # the stream field is SIGNED 5-bit: 15 is the max
    if shift < 0:
        return None  # coefficient magnitude too large for the format
    qmax = (1 << (precision - 1)) - 1
    qmin = -(1 << (precision - 1))
    q = []
    error = 0.0
    for c in coefs:
        v = c * (1 << shift) + error
        qi = int(np.rint(v))
        if qi > qmax:
            qi = qmax
        elif qi < qmin:
            qi = qmin
        error = v - qi
        q.append(qi)
    return q, shift


def _lpc_residual(x: np.ndarray, qcoefs, shift: int) -> np.ndarray:
    """Exact integer LPC residual: r[i] = x[i] - (sum qc[j]*x[i-1-j]
    >> shift) — the inverse of the decoder's predict_lpc."""
    order = len(qcoefs)
    c = np.asarray(qcoefs, np.int64)
    pred = np.convolve(x.astype(np.int64), c)[order - 1 : len(x) - 1]
    return x[order:].astype(np.int64) - (pred >> shift)


def write_flac(path: str, audio: np.ndarray, rate: int,
               meta: Optional[WavMetadata] = None,
               bits: int = 16, blocksize: int = 4096) -> None:
    """Encode float32 audio ((ch, n) or (n,)) as FLAC.

    Fixed-predictor encoder: per frame and channel the order 0-4 whose
    residual sum-of-magnitudes is smallest, Rice-coded with exact
    per-partition parameter search.  Output verifies against the format
    spec (decodable by read_flac and libFLAC alike).
    """
    if bits not in (16, 24):
        raise FlacFormatError(f"unsupported encode depth {bits}")
    x = np.atleast_2d(np.asarray(audio, np.float32))
    channels, n = x.shape
    if channels > 8:
        raise FlacFormatError("FLAC supports at most 8 channels")
    scale = float(1 << (bits - 1))
    lim = (1 << (bits - 1)) - 1
    samples = np.clip(np.rint(x * scale), -(lim + 1), lim).astype(np.int64)

    # MD5 of the interleaved little-endian samples (STREAMINFO field)
    inter = samples.T.reshape(-1)
    if bits == 16:
        raw = inter.astype("<i2").tobytes()
    else:
        b32 = inter.astype("<i4").tobytes()
        raw = b"".join(b32[i : i + 3] for i in range(0, len(b32), 4))
    md5 = hashlib.md5(raw).digest()

    frames = []
    frame_no = 0
    for start in range(0, n, blocksize):
        blk = samples[:, start : start + blocksize]
        frames.append(_encode_frame(blk, frame_no, rate, bits, blocksize))
        frame_no += 1

    si = _BitWriter()
    # fixed-blocksize stream: min == max == nominal (the shorter final
    # frame is excluded from these by the spec)
    si.write_uint(blocksize, 16)
    si.write_uint(blocksize, 16)
    sizes = [len(f) for f in frames] or [0]
    si.write_uint(min(sizes), 24)
    si.write_uint(max(sizes), 24)
    si.write_uint(rate, 20)
    si.write_uint(channels - 1, 3)
    si.write_uint(bits - 1, 5)
    si.write_uint(n, 36)
    streaminfo = si.tobytes() + md5

    blocks = [bytes([0x00]) + len(streaminfo).to_bytes(3, "big")
              + streaminfo]
    if meta is not None and meta.info:
        vc = _encode_vorbis_comment(meta)
        blocks.append(bytes([0x04]) + len(vc).to_bytes(3, "big") + vc)
    # mark the last metadata block
    last = blocks[-1]
    blocks[-1] = bytes([last[0] | 0x80]) + last[1:]

    with open(path, "wb") as f:
        f.write(b"fLaC")
        for b in blocks:
            f.write(b)
        for frame in frames:
            f.write(frame)


def _encode_vorbis_comment(meta: WavMetadata) -> bytes:
    vendor = b"phaserotate_tpu"
    entries = []
    for tag, val in meta.info.items():
        key = _INFO_TO_VORBIS.get(tag)
        if key:
            entries.append(f"{key}={val}".encode())
    out = struct.pack("<I", len(vendor)) + vendor
    out += struct.pack("<I", len(entries))
    for e in entries:
        out += struct.pack("<I", len(e)) + e
    return out


def _encode_frame(blk: np.ndarray, frame_no: int, rate: int,
                  bits: int, nominal_blocksize: int) -> bytes:
    channels, bs = blk.shape
    bw = _BitWriter()
    bw.write_uint(0x3FFE, 14)
    bw.write_uint(0, 1)   # reserved
    bw.write_uint(0, 1)   # fixed blocksize strategy
    if bs == nominal_blocksize and bs in _BLOCKSIZE_CODE.values():
        bs_code = {v: k for k, v in _BLOCKSIZE_CODE.items()}[bs]
        bs_tail = None
    else:
        bs_code, bs_tail = 7, bs - 1  # 16-bit blocksize follows
    bw.write_uint(bs_code, 4)
    rate_rev = {v: k for k, v in _RATE_CODE.items() if v}
    sr_code = rate_rev.get(rate, 0)
    bw.write_uint(sr_code, 4)
    bw.write_uint(channels - 1, 4)  # independent channels
    bw.write_uint({16: 4, 24: 6}[bits], 3)
    bw.write_uint(0, 1)
    _write_utf8_number(bw, frame_no)
    if bs_tail is not None:
        bw.write_uint(bs_tail, 16)
    header = bw.tobytes()
    header += bytes([_crc8(header)])

    body = _BitWriter()
    for c in range(channels):
        _encode_subframe(body, blk[c], bits, bs)
    body.align()
    frame = header + body.tobytes()
    return frame + _crc16(frame).to_bytes(2, "big")


def _encode_subframe(bw: _BitWriter, x: np.ndarray, bits: int,
                     bs: int) -> None:
    """Model search: CONSTANT, best FIXED order 0-4, best LPC order
    <= 12 — whichever costs the fewest bits by exact Rice accounting
    (the role of libFLAC's -5 level: windowed LPC with one quantized
    precision, no exhaustive apodization search)."""
    if np.all(x == x[0]):  # CONSTANT
        bw.write_uint(0, 1)
        bw.write_uint(0, 6)
        bw.write_uint(0, 1)
        bw.write_uint(int(x[0]) & ((1 << bits) - 1), bits)
        return

    # FIXED candidate: order minimizing residual magnitude, exact cost
    max_fixed = min(4, bs - 1)
    fixed_order, best_mag = 0, None
    for order in range(max_fixed + 1):
        mag = int(np.sum(np.abs(_fixed_residual(x, order))))
        if best_mag is None or mag < best_mag:
            fixed_order, best_mag = order, mag
    fixed_resid = _fixed_residual(x, fixed_order)
    fixed_cost = (fixed_order * bits
                  + _residual_cost(fixed_resid, fixed_order, bs))

    # LPC candidate: Levinson error picks the order, then exact cost of
    # the quantized predictor (evaluating one order keeps encode fast)
    lpc_choice = None
    max_order = min(_MAX_LPC_ORDER, bs // 2 - 1)
    if max_order >= 1 and bs > 2 * _MAX_LPC_ORDER:
        coefs, errs = _lpc_analyze(x, max_order)
        if coefs:
            # expected bits/sample ~ 0.5*log2(err): pick the order where
            # the win stops paying for precision-bit header growth
            best_o, best_est = 1, None
            for o in range(1, max_order + 1):
                e = errs[o - 1]
                est = (0.5 * np.log2(e / bs) * (bs - o) if e > 0
                       else 0.0)
                est += o * (bits + _LPC_PRECISION)
                if best_est is None or est < best_est:
                    best_o, best_est = o, est
            quant = _quantize_lpc(coefs[best_o - 1], _LPC_PRECISION)
            if quant is not None:
                qcoefs, shift = quant
                resid = _lpc_residual(x, qcoefs, shift)
                cost = (best_o * bits + 4 + 5
                        + best_o * _LPC_PRECISION
                        + _residual_cost(resid, best_o, bs))
                if cost < fixed_cost:
                    lpc_choice = (best_o, qcoefs, shift, resid)

    bw.write_uint(0, 1)
    mask = (1 << bits) - 1
    if lpc_choice is not None:
        order, qcoefs, shift, resid = lpc_choice
        bw.write_uint(32 + (order - 1), 6)  # LPC
        bw.write_uint(0, 1)                 # no wasted bits
        for i in range(order):
            bw.write_uint(int(x[i]) & mask, bits)
        bw.write_uint(_LPC_PRECISION - 1, 4)
        bw.write_uint(shift & 0x1F, 5)
        pmask = (1 << _LPC_PRECISION) - 1
        for qc in qcoefs:
            bw.write_uint(qc & pmask, _LPC_PRECISION)
        _write_residual(bw, resid, order, bs)
    else:
        bw.write_uint(8 + fixed_order, 6)  # FIXED
        bw.write_uint(0, 1)                # no wasted bits
        for i in range(fixed_order):
            bw.write_uint(int(x[i]) & mask, bits)
        _write_residual(bw, fixed_resid, fixed_order, bs)
