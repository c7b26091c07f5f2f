"""Ogg Vorbis decoder (pure Python/numpy — no external libraries).

A copy of ``phaserotate_tpu/io/vorbis.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy of the host-side (numpy/ctypes) file
layer.  Only these lines differ; ``tests/test_torch_io.py`` holds every
function here to its source.

The reference reads anything libsndfile can open (cli/phase-rotate.cc:33
``sf_open``), which includes Ogg Vorbis — a common delivery format that
mastering workflows receive for loudness/peak work.  Same posture as the
FLAC codec (io/flac.py): the framework carries its own decoder,
implemented from the public Vorbis I specification (xiph.org); this is
an independent implementation, not derived from libvorbis.

Scope:

* **Ogg layer**: page capture, CRC-32 check, packet reassembly across
  pages (continued packets), end-trim from the final granule position.
* **Vorbis layer**: all three headers; codebook Huffman + VQ lookup
  types 0/1/2; floor type 1 (neighbor-predicted piecewise curve on the
  0.5 dB-step scale); residue types 0/1/2; square polar channel
  coupling; IMDCT; long/short window overlap-add.
* Floor type 0 (LSP, deprecated since 2002 — no mainstream encoder
  emits it) is detected and rejected with a clear error.

Encoding is intentionally NOT reimplemented: psychoacoustic rate
allocation belongs to the system encoder, so ``write_ogg`` lives in
io/vorbisenc.py as a libvorbisenc binding — exactly how the reference
leans on libsndfile for lossy formats.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from .wav import WavMetadata

__all__ = ["is_ogg", "read_ogg", "OggFormatError"]


class OggFormatError(ValueError):
    pass


def is_ogg(head: bytes) -> bool:
    return head[:4] == b"OggS"


def _ilog(x: int) -> int:
    """Number of bits needed for x (Vorbis ilog: ilog(0)=0, ilog(1)=1,
    ilog(7)=3)."""
    n = 0
    while x > 0:
        n += 1
        x >>= 1
    return n


# ---- Ogg container ---------------------------------------------------------

def _ogg_crc_table() -> np.ndarray:
    tbl = np.zeros(256, np.uint32)
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ 0x04C11DB7) & 0xFFFFFFFF if c & 0x80000000 \
                else (c << 1) & 0xFFFFFFFF
        tbl[i] = c
    return tbl


_OGG_CRC = _ogg_crc_table()


def _ogg_crc(data: bytes) -> int:
    c = 0
    tbl = _OGG_CRC
    for b in data:
        c = ((c << 8) & 0xFFFFFFFF) ^ int(tbl[((c >> 24) ^ b) & 0xFF])
    return c


def _ogg_packets(data: bytes):
    """Parse the physical stream -> (packets, final_granule).

    Follows the first logical stream (first serial seen); packets are
    reassembled across page boundaries; each page's CRC-32 is verified.
    """
    packets: List[bytes] = []
    partial = b""
    pos = 0
    serial = None
    granule = 0
    while pos < len(data):
        if data[pos : pos + 4] != b"OggS":
            raise OggFormatError(f"lost Ogg page sync at byte {pos}")
        if pos + 27 > len(data):
            raise OggFormatError("truncated Ogg page header")
        version = data[pos + 4]
        if version != 0:
            raise OggFormatError(f"unsupported Ogg version {version}")
        htype = data[pos + 5]
        (page_granule,) = struct.unpack_from("<q", data, pos + 6)
        (page_serial,) = struct.unpack_from("<I", data, pos + 14)
        (page_crc,) = struct.unpack_from("<I", data, pos + 22)
        nsegs = data[pos + 26]
        seg_table = data[pos + 27 : pos + 27 + nsegs]
        if len(seg_table) != nsegs:
            raise OggFormatError("truncated Ogg segment table")
        body_start = pos + 27 + nsegs
        body_len = sum(seg_table)
        body = data[body_start : body_start + body_len]
        if len(body) != body_len:
            raise OggFormatError("truncated Ogg page body")
        page = bytearray(data[pos : body_start + body_len])
        page[22:26] = b"\x00" * 4
        if _ogg_crc(bytes(page)) != page_crc:
            raise OggFormatError(f"Ogg page CRC mismatch at byte {pos}")
        pos = body_start + body_len

        if serial is None:
            serial = page_serial
        if page_serial != serial:
            continue  # other multiplexed streams are skipped
        if page_granule != -1:
            granule = page_granule

        if not (htype & 0x01):  # fresh packet: drop any dangling partial
            partial = b""
        off = 0
        for i, seg in enumerate(seg_table):
            partial += body[off : off + seg]
            off += seg
            if seg < 255:  # lacing value < 255 terminates a packet
                packets.append(partial)
                partial = b""
    return packets, granule


# ---- LSB-first bit reader --------------------------------------------------

class _EndOfPacket(Exception):
    """Reading past packet end — a NORMAL stop condition for Vorbis
    audio packet decode (spec 1.2.2)."""


class _Bits:
    """Vorbis bit packing: LSB-first within each byte."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0        # next byte
        self.acc = 0
        self.nbits = 0

    def read(self, n: int) -> int:
        acc, nbits, pos, data = self.acc, self.nbits, self.pos, self.data
        while nbits < n:
            if pos >= len(data):
                self.acc, self.nbits, self.pos = acc, nbits, pos
                raise _EndOfPacket
            acc |= data[pos] << nbits
            pos += 1
            nbits += 8
        v = acc & ((1 << n) - 1)
        self.acc = acc >> n
        self.nbits = nbits - n
        self.pos = pos
        return v

    def read_bit(self) -> int:
        if self.nbits == 0:
            if self.pos >= len(self.data):
                raise _EndOfPacket
            self.acc = self.data[self.pos]
            self.pos += 1
            self.nbits = 8
        v = self.acc & 1
        self.acc >>= 1
        self.nbits -= 1
        return v

    def remaining(self) -> int:
        """Bits left in the packet — used to sanity-bound declared
        element counts before allocating for them."""
        return (len(self.data) - self.pos) * 8 + self.nbits


def _float32_unpack(x: int) -> float:
    """Vorbis packed float: 21-bit mantissa, 10-bit biased exponent."""
    mantissa = x & 0x1FFFFF
    if x & 0x80000000:
        mantissa = -mantissa
    exponent = (x & 0x7FE00000) >> 21
    return float(mantissa) * (2.0 ** (exponent - 788))


# ---- codebooks -------------------------------------------------------------

class _Codebook:
    """Huffman codebook + optional VQ lookup (Vorbis I spec section 3)."""

    def __init__(self, bits: _Bits):
        if bits.read(24) != 0x564342:
            raise OggFormatError("codebook sync lost")
        self.dims = bits.read(16)
        entries = bits.read(24)
        ordered = bits.read(1)
        # A corrupt header can declare up to 2^24 entries; allocating
        # and walking that many is a multi-minute stall on a small host
        # (and entries*dims below can demand terabytes).  Non-ordered
        # books spend >=1 bit per entry, so the packet length bounds the
        # real count; ordered books are run-length coded, so cap them at
        # a value far beyond anything an encoder emits.
        if not ordered and entries > bits.remaining() + 8:
            raise OggFormatError("codebook entries exceed packet size")
        if ordered and entries > (1 << 22):
            raise OggFormatError("implausible ordered codebook size")
        lengths = [0] * entries
        if not ordered:
            sparse = bits.read(1)
            for i in range(entries):
                if sparse:
                    if bits.read(1):
                        lengths[i] = bits.read(5) + 1
                else:
                    lengths[i] = bits.read(5) + 1
        else:
            length = bits.read(5) + 1
            i = 0
            while i < entries:
                num = bits.read(_ilog(entries - i))
                if i + num > entries:
                    raise OggFormatError("ordered codebook overflows")
                for j in range(i, i + num):
                    lengths[j] = length
                i += num
                length += 1
        self.lengths = lengths
        self._assign_codewords()

        lookup = bits.read(4)
        self.lookup = lookup
        self.vectors: Optional[np.ndarray] = None
        if lookup == 0:
            pass
        elif lookup in (1, 2):
            minimum = _float32_unpack(bits.read(32))
            delta = _float32_unpack(bits.read(32))
            value_bits = bits.read(4) + 1
            sequence_p = bits.read(1)
            if lookup == 1:
                lv = _lookup1_values(entries, self.dims)
                mult_count = lv
            else:
                lv = 0
                mult_count = entries * self.dims
            mults = np.array([bits.read(value_bits)
                              for _ in range(mult_count)], np.float64)
            if entries * self.dims > (1 << 22):
                raise OggFormatError("implausible VQ table size")
            vecs = np.zeros((entries, self.dims), np.float64)
            if lookup == 1:
                idx = np.arange(entries)
                last = np.zeros(entries, np.float64)
                for d in range(self.dims):
                    off = (idx // (lv ** d)) % lv
                    vecs[:, d] = mults[off] * delta + minimum + last
                    if sequence_p:
                        last = vecs[:, d]
            else:
                m = mults.reshape(entries, self.dims)
                last = np.zeros(entries, np.float64)
                for d in range(self.dims):
                    vecs[:, d] = m[:, d] * delta + minimum + last
                    if sequence_p:
                        last = vecs[:, d]
            self.vectors = vecs.astype(np.float32)
        else:
            raise OggFormatError(f"reserved codebook lookup {lookup}")

    def _assign_codewords(self) -> None:
        """Canonical Vorbis codeword assignment (spec 3.2.1): entries in
        ascending order each take the lowest available leaf of their
        length.  Builds the bit-walk decode table {(code, len): entry}
        where `code` accumulates MSB-first as bits are read."""
        table = {}
        marker = [0] * 33
        for entry, length in enumerate(self.lengths):
            if length == 0:
                continue
            word = marker[length]
            if length < 32 and (word >> length):
                raise OggFormatError("overpopulated Huffman tree")
            table[(word, length)] = entry
            # mark this leaf used: increment markers up the tree
            for j in range(length, 0, -1):
                if marker[j] & 1:
                    if j == 1:
                        marker[1] += 1
                    else:
                        marker[j] = marker[j - 1] << 1
                    break
                marker[j] += 1
            # propagate new prefixes downward
            for j in range(length + 1, 33):
                if (marker[j] >> 1) == word:
                    word = marker[j]
                    marker[j] = marker[j - 1] << 1
                else:
                    break
        self.table = table
        self.maxlen = max(self.lengths, default=0)

    def decode_scalar(self, bits: _Bits) -> int:
        code = 0
        length = 0
        table = self.table
        maxlen = self.maxlen
        read_bit = bits.read_bit
        while length <= maxlen:
            code = (code << 1) | read_bit()
            length += 1
            e = table.get((code, length))
            if e is not None:
                return e
        raise OggFormatError("invalid Huffman code")

    def decode_vector(self, bits: _Bits) -> np.ndarray:
        if self.vectors is None:
            raise OggFormatError("scalar codebook used in VQ context")
        return self.vectors[self.decode_scalar(bits)]


def _lookup1_values(entries: int, dims: int) -> int:
    """Largest integer v with v**dims <= entries."""
    v = int(np.floor(entries ** (1.0 / dims)))
    while (v + 1) ** dims <= entries:
        v += 1
    while v ** dims > entries:
        v -= 1
    return v


# ---- floor type 1 ----------------------------------------------------------

# amplitude scale: 0.5 dB-ish steps, value 255 = unity
# (table[i] = 10 ** (-(255 - i) * 7 / 2560 * 10) per the spec table)
_FLOOR1_INVERSE_DB = (10.0 ** (-(255 - np.arange(256)) * (7.0 / 256.0))
                      ).astype(np.float32)
_FLOOR1_RANGES = (256, 128, 86, 64)


class _Floor1:
    def __init__(self, bits: _Bits, codebooks: List[_Codebook]):
        self.partitions = bits.read(5)
        self.classlist = [bits.read(4) for _ in range(self.partitions)]
        maxclass = max(self.classlist, default=-1)
        self.class_dims = []
        self.class_subs = []
        self.class_master = []
        self.subclass_books: List[List[int]] = []
        for _ in range(maxclass + 1):
            dim = bits.read(3) + 1
            sub = bits.read(2)
            master = bits.read(8) if sub else 0
            if sub and master >= len(codebooks):
                raise OggFormatError("floor1 master book out of range")
            books = [bits.read(8) - 1 for _ in range(1 << sub)]
            for b in books:
                if b >= len(codebooks):
                    raise OggFormatError("floor1 subclass book range")
            self.class_dims.append(dim)
            self.class_subs.append(sub)
            self.class_master.append(master)
            self.subclass_books.append(books)
        self.multiplier = bits.read(2) + 1
        rangebits = bits.read(4)
        xs = [0, 1 << rangebits]
        for p in range(self.partitions):
            c = self.classlist[p]
            for _ in range(self.class_dims[c]):
                xs.append(bits.read(rangebits))
        self.x_list = xs
        self.values = len(xs)
        if len(set(xs)) != len(xs):
            raise OggFormatError("floor1 X values not unique")
        self.sort_idx = sorted(range(self.values),
                               key=lambda i: self.x_list[i])
        # neighbor tables (spec low_neighbor/high_neighbor)
        self.lo_nb = [0] * self.values
        self.hi_nb = [0] * self.values
        for i in range(2, self.values):
            lo, hi = 0, 1  # positions of 0 and 2^rangebits
            for j in range(i):
                if self.x_list[j] < xs[i] and \
                        self.x_list[j] > self.x_list[lo]:
                    lo = j
                if self.x_list[j] > xs[i] and \
                        self.x_list[j] < self.x_list[hi]:
                    hi = j
            self.lo_nb[i] = lo
            self.hi_nb[i] = hi

    def decode(self, bits: _Bits,
               codebooks: List[_Codebook]) -> Optional[list]:
        """-> final_Y list (curve posts) or None for an unused floor."""
        if not bits.read_bit():
            return None
        rng = _FLOOR1_RANGES[self.multiplier - 1]
        ybits = _ilog(rng - 1)
        y = [bits.read(ybits), bits.read(ybits)]
        for p in range(self.partitions):
            c = self.classlist[p]
            cdim = self.class_dims[c]
            cbits = self.class_subs[c]
            csub = (1 << cbits) - 1
            cval = 0
            if cbits:
                cval = codebooks[self.class_master[c]].decode_scalar(bits)
            for _ in range(cdim):
                book = self.subclass_books[c][cval & csub]
                cval >>= cbits
                if book >= 0:
                    y.append(codebooks[book].decode_scalar(bits))
                else:
                    y.append(0)
        return y

    def synthesize(self, y: list, n2: int) -> np.ndarray:
        """Curve synthesis (spec 7.2.4): neighbor prediction, then
        line rendering on the dB scale, then the inverse-dB map."""
        rng = _FLOOR1_RANGES[self.multiplier - 1]
        values = self.values
        final = [0] * values
        step2 = [False] * values
        final[0], final[1] = y[0], y[1]
        step2[0] = step2[1] = True
        for i in range(2, values):
            lo, hi = self.lo_nb[i], self.hi_nb[i]
            pred = _render_point(self.x_list[lo], final[lo],
                                 self.x_list[hi], final[hi],
                                 self.x_list[i])
            val = y[i]
            highroom = rng - pred
            lowroom = pred
            room = 2 * (highroom if highroom < lowroom else lowroom)
            if val:
                step2[lo] = step2[hi] = step2[i] = True
                if val >= room:
                    if highroom > lowroom:
                        final[i] = val - lowroom + pred
                    else:
                        final[i] = pred - val + highroom - 1
                else:
                    if val & 1:
                        final[i] = pred - ((val + 1) >> 1)
                    else:
                        final[i] = pred + (val >> 1)
            else:
                step2[i] = False
                final[i] = pred

        out = np.zeros(n2, np.int32)
        mult = self.multiplier
        hx = 0
        lx = 0
        ly = final[0] * mult
        hy = ly
        for j in self.sort_idx[1:]:
            if not step2[j]:
                continue
            hx = self.x_list[j]
            hy = final[j] * mult
            if lx < n2:
                _render_line(lx, ly, min(hx, n2), hy, out)
            lx, ly = hx, hy
        if hx < n2:
            out[hx:] = hy if hx else ly
        np.clip(out, 0, 255, out=out)
        return _FLOOR1_INVERSE_DB[out]


def _render_point(x0: int, y0: int, x1: int, y1: int, x: int) -> int:
    dy = y1 - y0
    adx = x1 - x0
    ady = abs(dy)
    err = ady * (x - x0)
    off = err // adx
    return y0 - off if dy < 0 else y0 + off


def _render_line(x0: int, y0: int, x1: int, y1: int,
                 v: np.ndarray) -> None:
    dy = y1 - y0
    adx = x1 - x0
    base = abs(dy) // adx
    if dy < 0:
        base = -base
    sy = base - 1 if dy < 0 else base + 1
    ady = abs(dy) - abs(base) * adx
    x = x0
    y = y0
    err = 0
    if x < len(v):
        v[x] = y
    for x in range(x0 + 1, x1):
        err += ady
        if err >= adx:
            err -= adx
            y += sy
        else:
            y += base
        if x < len(v):
            v[x] = y


# ---- residue ---------------------------------------------------------------

class _Residue:
    def __init__(self, rtype: int, bits: _Bits,
                 codebooks: List[_Codebook]):
        self.rtype = rtype
        self.begin = bits.read(24)
        self.end = bits.read(24)
        self.partition_size = bits.read(24) + 1
        self.classifications = bits.read(6) + 1
        self.classbook = bits.read(8)
        if self.classbook >= len(codebooks):
            raise OggFormatError("residue classbook out of range")
        cascades = []
        for _ in range(self.classifications):
            low = bits.read(3)
            high = bits.read(5) if bits.read(1) else 0
            cascades.append((high << 3) | low)
        self.cascades = cascades
        self.books: List[List[int]] = []
        for c in range(self.classifications):
            row = []
            for p in range(8):
                if cascades[c] & (1 << p):
                    b = bits.read(8)
                    if b >= len(codebooks) or \
                            codebooks[b].lookup == 0:
                        raise OggFormatError("residue book invalid")
                    row.append(b)
                else:
                    row.append(-1)
            self.books.append(row)

    def decode(self, bits: _Bits, codebooks: List[_Codebook],
               vectors: List[np.ndarray],
               do_not_decode: List[bool]) -> None:
        """Decode (in place, additive) into `vectors` (format 0/1); for
        format 2 call with the single interleaved vector."""
        n = len(vectors[0])
        limit_begin = min(self.begin, n)
        limit_end = min(self.end, n)
        psize = self.partition_size
        to_read = limit_end - limit_begin
        if to_read <= 0:
            return
        parts = to_read // psize
        classbook = codebooks[self.classbook]
        cpc = classbook.dims  # classwords per codeword
        nclass = self.classifications
        nvec = len(vectors)
        classifs = [[0] * (parts + cpc) for _ in range(nvec)]
        for pas in range(8):
            pcount = 0
            while pcount < parts:
                if pas == 0:
                    for j in range(nvec):
                        if do_not_decode[j]:
                            continue
                        temp = classbook.decode_scalar(bits)
                        for i in range(cpc - 1, -1, -1):
                            classifs[j][pcount + i] = temp % nclass
                            temp //= nclass
                for _ in range(cpc):
                    if pcount >= parts:
                        break
                    for j in range(nvec):
                        if do_not_decode[j]:
                            continue
                        vq = classifs[j][pcount]
                        book = self.books[vq][pas]
                        if book < 0:
                            continue
                        cb = codebooks[book]
                        offset = limit_begin + pcount * psize
                        v = vectors[j]
                        if self.rtype == 0:
                            step = psize // cb.dims
                            for k in range(step):
                                t = cb.decode_vector(bits)
                                v[offset + k : offset + k
                                  + step * cb.dims : step] += t
                        else:  # formats 1 and 2: contiguous
                            k = 0
                            while k < psize:
                                t = cb.decode_vector(bits)
                                v[offset + k : offset + k + cb.dims] += t
                                k += cb.dims
                    pcount += 1


# ---- mapping / mode --------------------------------------------------------

class _Mapping:
    def __init__(self, bits: _Bits, channels: int, floors: list,
                 residues: list):
        self.submaps = bits.read(4) + 1 if bits.read(1) else 1
        self.coupling: List[Tuple[int, int]] = []
        if bits.read(1):
            steps = bits.read(8) + 1
            cb = _ilog(channels - 1)
            for _ in range(steps):
                mag = bits.read(cb)
                ang = bits.read(cb)
                if mag == ang or mag >= channels or ang >= channels:
                    raise OggFormatError("bad coupling channels")
                self.coupling.append((mag, ang))
        if bits.read(2):
            raise OggFormatError("mapping reserved bits set")
        if self.submaps > 1:
            self.mux = [bits.read(4) for _ in range(channels)]
            if any(m >= self.submaps for m in self.mux):
                raise OggFormatError("mapping mux out of range")
        else:
            self.mux = [0] * channels
        self.submap_floor = []
        self.submap_residue = []
        for _ in range(self.submaps):
            bits.read(8)  # unused time configuration
            f = bits.read(8)
            r = bits.read(8)
            if f >= len(floors) or r >= len(residues):
                raise OggFormatError("mapping floor/residue range")
            self.submap_floor.append(f)
            self.submap_residue.append(r)


# ---- setup / stream state --------------------------------------------------

class _Setup:
    def __init__(self, ident: bytes, setup: bytes):
        b = _Bits(ident)
        if b.read(8) != 1 or bytes(ident[1:7]) != b"vorbis":
            raise OggFormatError("bad identification header")
        b = _Bits(ident[7:])
        if b.read(32) != 0:
            raise OggFormatError("unsupported Vorbis version")
        self.channels = b.read(8)
        self.rate = b.read(32)
        b.read(32)
        b.read(32)
        b.read(32)  # bitrate fields
        self.bs0 = 1 << b.read(4)
        self.bs1 = 1 << b.read(4)
        if self.bs0 > self.bs1 or not b.read(1):
            raise OggFormatError("bad blocksizes/framing")
        if self.channels < 1 or self.rate < 1:
            raise OggFormatError("bad channels/rate")

        b = _Bits(setup)
        if b.read(8) != 5 or bytes(setup[1:7]) != b"vorbis":
            raise OggFormatError("bad setup header")
        b = _Bits(setup[7:])
        self.codebooks = [_Codebook(b) for _ in range(b.read(8) + 1)]
        for _ in range(b.read(6) + 1):  # time domain transforms
            if b.read(16) != 0:
                raise OggFormatError("nonzero time transform")
        self.floors = []
        for _ in range(b.read(6) + 1):
            ftype = b.read(16)
            if ftype == 1:
                self.floors.append(_Floor1(b, self.codebooks))
            elif ftype == 0:
                raise OggFormatError(
                    "floor type 0 (LSP, deprecated 2002) not supported")
            else:
                raise OggFormatError(f"reserved floor type {ftype}")
        self.residues = []
        for _ in range(b.read(6) + 1):
            rtype = b.read(16)
            if rtype > 2:
                raise OggFormatError(f"reserved residue type {rtype}")
            self.residues.append(_Residue(rtype, b, self.codebooks))
        self.mappings = []
        for _ in range(b.read(6) + 1):
            if b.read(16) != 0:
                raise OggFormatError("reserved mapping type")
            self.mappings.append(
                _Mapping(b, self.channels, self.floors, self.residues))
        self.modes = []
        for _ in range(b.read(6) + 1):
            blockflag = b.read(1)
            if b.read(16) or b.read(16):
                raise OggFormatError("reserved mode window/transform")
            mapping = b.read(8)
            if mapping >= len(self.mappings):
                raise OggFormatError("mode mapping out of range")
            self.modes.append((blockflag, mapping))
        if not b.read(1):
            raise OggFormatError("setup framing bit unset")


# cached per (n,) IMDCT operators and windows
_imdct_cache = {}
_window_cache = {}


def _imdct(spec: np.ndarray, n: int) -> np.ndarray:
    """y[j] = sum_k X[k] cos(2*pi/n * (j + 0.5 + n/4) * (k + 0.5)),
    j in [0, n) — computed as one cached (n x n/2) matrix product (the
    two Vorbis block sizes make this a pair of small resident
    operators; decode cost is dominated by entropy decode, not this)."""
    m = _imdct_cache.get(n)
    if m is None:
        j = np.arange(n)[:, None] + 0.5 + n / 4.0
        k = np.arange(n // 2)[None, :] + 0.5
        m = np.cos(2.0 * np.pi / n * j * k).astype(np.float32)
        _imdct_cache[n] = m
    return m @ spec


def _vorbis_window(left_size: int) -> np.ndarray:
    w = _window_cache.get(left_size)
    if w is None:
        i = (np.arange(left_size) + 0.5) / left_size * (np.pi / 2)
        w = np.sin(np.pi / 2.0 * np.sin(i) ** 2).astype(np.float32)
        _window_cache[left_size] = w
    return w


def _apply_window(y: np.ndarray, n: int, bs0: int, long_block: bool,
                  prev_flag: int, next_flag: int) -> np.ndarray:
    if long_block and not prev_flag:
        left_start = n // 4 - bs0 // 4
        left_size = bs0 // 2
    else:
        left_start = 0
        left_size = n // 2
    if long_block and not next_flag:
        right_start = (n * 3) // 4 - bs0 // 4
        right_size = bs0 // 2
    else:
        right_start = n // 2
        right_size = n // 2
    w = np.zeros(n, np.float32)
    w[left_start : left_start + left_size] = _vorbis_window(left_size)
    w[left_start + left_size : right_start] = 1.0
    w[right_start : right_start + right_size] = \
        _vorbis_window(right_size)[::-1]
    return y * w


# ---- top-level decode ------------------------------------------------------

_VORBIS_TO_INFO = {
    "TITLE": b"INAM", "ARTIST": b"IART", "ALBUM": b"IPRD",
    "DATE": b"ICRD", "GENRE": b"IGNR", "COMMENT": b"ICMT",
    "COPYRIGHT": b"ICOP", "TRACKNUMBER": b"ITRK",
}


def _parse_comments(pkt: bytes, meta: WavMetadata) -> None:
    try:
        if pkt[0] != 3 or pkt[1:7] != b"vorbis":
            return
        off = 7
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
        pass  # malformed comments are non-fatal


def _header_packets(data: bytes, want: int = 3) -> List[bytes]:
    """First ``want`` packets of the first logical stream, walking pages
    WITHOUT CRC verification — the cheap probe the native fast path
    needs (the native decoder re-verifies every page's CRC itself).
    Returns fewer packets if the stream is malformed/short."""
    packets: List[bytes] = []
    partial = b""
    pos = 0
    serial = None
    while pos + 27 <= len(data) and len(packets) < want:
        if data[pos : pos + 4] != b"OggS" or data[pos + 4] != 0:
            break
        htype = data[pos + 5]
        (page_serial,) = struct.unpack_from("<I", data, pos + 14)
        nsegs = data[pos + 26]
        seg_table = data[pos + 27 : pos + 27 + nsegs]
        if len(seg_table) != nsegs:
            break
        body_start = pos + 27 + nsegs
        body_len = sum(seg_table)
        body = data[body_start : body_start + body_len]
        if len(body) != body_len:
            break
        pos = body_start + body_len
        if serial is None:
            serial = page_serial
        if page_serial != serial:
            continue
        if not (htype & 0x01):
            partial = b""
        off = 0
        for seg in seg_table:
            partial += body[off : off + seg]
            off += seg
            if seg < 255:
                packets.append(partial)
                partial = b""
                if len(packets) >= want:
                    break
    return packets


def _tail_granule(data: bytes) -> int:
    """Final granule position from the stream tail (validated pages
    only; -1 when none is found) — sizing input for the native path."""
    tail = data[-65536:]
    base = len(data) - len(tail)
    i = len(tail)
    while True:
        i = tail.rfind(b"OggS", 0, i)
        if i < 0:
            return -1
        if i + 27 > len(tail) or tail[i + 4] != 0:
            continue
        nsegs = tail[i + 26]
        body = sum(tail[i + 27 : i + 27 + nsegs])
        end = i + 27 + nsegs + body
        if base + end > len(data) or end > len(tail):
            continue
        (page_crc,) = struct.unpack_from("<I", tail, i + 22)
        page = bytearray(tail[i:end])
        page[22:26] = b"\x00\x00\x00\x00"
        if _ogg_crc(bytes(page)) != page_crc:
            continue
        granule = struct.unpack_from("<q", tail, i + 6)[0]
        return max(-1, granule)


def _read_ogg_native(data: bytes, meta: WavMetadata):
    """Native fast path (native/vorbis_decode.cc): probe the headers in
    Python (channels/rate for validation, comment packet for metadata,
    tail granule for output sizing), decode everything else natively.
    Returns (audio, rate) or None -> pure-Python reference decoder."""
    from . import native as _native

    heads = _header_packets(data)
    if len(heads) < 3:
        return None
    ident = heads[0]
    if len(ident) < 30 or ident[0] != 1 or ident[1:7] != b"vorbis":
        return None
    channels = ident[11]
    (rate,) = struct.unpack_from("<I", ident, 12)
    granule = _tail_granule(data)
    if channels < 1 or rate < 1 or granule < 0:
        return None
    audio = _native.vorbis_decode(data, channels, rate,
                                  granule + 65536)
    if audio is None:
        return None
    _parse_comments(heads[1], meta)
    return audio, rate


def read_ogg(path: str) -> Tuple[np.ndarray, int, WavMetadata]:
    """Decode an Ogg Vorbis file -> ((channels, n) float32, rate, meta).

    Vorbis comments map onto the INFO string table (TITLE->INAM etc.),
    like the FLAC reader.  Decode runs in the native frame decoder
    (native/vorbis_decode.cc) when built; any error there falls back to
    this module's pure-Python reference decoder, which owns the exact
    error messages."""
    with open(path, "rb") as f:
        data = f.read()
    if not is_ogg(data):
        raise OggFormatError(f"{path}: not an Ogg stream")
    meta = WavMetadata(container="OGG")
    fast = _read_ogg_native(data, meta)
    if fast is not None:
        return fast[0], fast[1], meta
    packets, final_granule = _ogg_packets(data)
    if len(packets) < 3:
        raise OggFormatError(f"{path}: missing Vorbis headers")
    try:
        setup = _Setup(packets[0], packets[2])
    except _EndOfPacket:
        # truncated/corrupt headers must surface as the format error the
        # io contract promises, not as an internal exception type
        raise OggFormatError(f"{path}: truncated Vorbis header packet")
    _parse_comments(packets[1], meta)

    ch = setup.channels
    bs0, bs1 = setup.bs0, setup.bs1
    mode_bits = _ilog(len(setup.modes) - 1)
    out_chunks: List[np.ndarray] = []
    prev: Optional[np.ndarray] = None  # previous windowed block
    prev_n = 0

    for pkt in packets[3:]:
        if not pkt:
            continue
        bits = _Bits(pkt)
        try:
            if bits.read(1) != 0:
                continue  # non-audio packet in the audio section
            mode_idx = bits.read(mode_bits) if mode_bits else 0
            if mode_idx >= len(setup.modes):
                continue
            blockflag, mapping_idx = setup.modes[mode_idx]
            mapping = setup.mappings[mapping_idx]
            n = bs1 if blockflag else bs0
            prev_flag = next_flag = 1
            if blockflag:
                prev_flag = bits.read(1)
                next_flag = bits.read(1)
            n2 = n // 2
        except _EndOfPacket:
            continue  # EOP before the mode/window header is complete:
            # the packet is undecodable — drop it (nothing below is
            # bound yet; falling through would use stale state)

        floor_posts: List[Optional[list]] = [None] * ch
        no_residue = [False] * ch
        resid = [np.zeros(n2, np.float32) for _ in range(ch)]
        try:
            for c in range(ch):
                fl = setup.floors[
                    mapping.submap_floor[mapping.mux[c]]]
                posts = fl.decode(bits, setup.codebooks)
                floor_posts[c] = posts
                no_residue[c] = posts is None
            # coupling: a zero-floor channel still carries residue if
            # its partner does (spec 4.3.4 step 4)
            for mag, ang in mapping.coupling:
                if not (no_residue[mag] and no_residue[ang]):
                    no_residue[mag] = no_residue[ang] = False

            for s in range(mapping.submaps):
                sub_ch = [c for c in range(ch) if mapping.mux[c] == s]
                res = setup.residues[mapping.submap_residue[s]]
                if res.rtype == 2:
                    dnd_all = all(no_residue[c] for c in sub_ch)
                    inter = np.zeros(n2 * len(sub_ch), np.float32)
                    res.decode(bits, setup.codebooks, [inter],
                               [dnd_all])
                    for k, c in enumerate(sub_ch):
                        resid[c] = np.ascontiguousarray(
                            inter[k :: len(sub_ch)])
                else:
                    vecs = [resid[c] for c in sub_ch]
                    dnd = [no_residue[c] for c in sub_ch]
                    res.decode(bits, setup.codebooks, vecs, dnd)
        except _EndOfPacket:
            pass  # spec: EOP during floor/residue decode is normal —
            # synthesize from whatever was decoded so far

        # square polar coupling inverse (spec 4.3.5)
        for mag, ang in reversed(mapping.coupling):
            m = resid[mag]
            a = resid[ang]
            new_m = m.copy()
            new_a = a.copy()
            pos_m = m > 0
            pa = a > 0
            new_a[pos_m & pa] = (m - a)[pos_m & pa]
            new_m[pos_m & ~pa] = (m + a)[pos_m & ~pa]
            new_a[pos_m & ~pa] = m[pos_m & ~pa]
            new_a[~pos_m & pa] = (m + a)[~pos_m & pa]
            new_m[~pos_m & ~pa] = (m - a)[~pos_m & ~pa]
            new_a[~pos_m & ~pa] = m[~pos_m & ~pa]
            resid[mag] = new_m
            resid[ang] = new_a

        # floor curve x residue -> spectrum -> time domain
        windowed = np.zeros((ch, n), np.float32)
        for c in range(ch):
            posts = floor_posts[c]
            if posts is None:
                continue
            fl = setup.floors[mapping.submap_floor[mapping.mux[c]]]
            curve = fl.synthesize(posts, n2)
            spec_c = curve * resid[c]
            windowed[c] = _imdct(spec_c, n)
        for c in range(ch):
            windowed[c] = _apply_window(
                windowed[c], n, bs0, bool(blockflag),
                prev_flag, next_flag)

        # overlap-add: previous center .. current center
        if prev is not None:
            hop = prev_n // 4 + n // 4
            outb = np.zeros((ch, hop), np.float32)
            seg = min(prev_n // 2, hop)
            outb[:, :seg] += prev[:, prev_n // 2 : prev_n // 2 + seg]
            start = hop - n // 2  # current block start on this timeline
            if start < 0:
                outb += windowed[:, -start : -start + hop]
            else:
                outb[:, start:] += windowed[:, : hop - start]
            out_chunks.append(outb)
        prev = windowed
        prev_n = n

    audio = (np.concatenate(out_chunks, axis=1) if out_chunks
             else np.zeros((ch, 0), np.float32))
    if final_granule >= 0 and audio.shape[1] > final_granule:
        audio = audio[:, :final_granule]
    # NOT clipped to [-1, 1]: lossy reconstruction can legitimately
    # overshoot full scale, and those overshoots are exactly what a
    # peak-analysis framework must see (libvorbisfile's float path
    # leaves them intact too)
    return audio, setup.rate, meta
