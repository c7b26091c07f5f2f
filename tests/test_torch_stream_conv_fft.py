"""The one-pass map of csrc/stream_conv.cu, on the CPU.

A numpy float32 emulation of the kernel ``stream_runs``, written with its
own thread roles and index formulas:

- the persistent grid: one run of the flattened (row, output frame) space
  per block (``run_start``), walked one segment per row; a segment's
  first stream frame is the one before its first output frame (its
  output dropped, its tail kept), after a warm-up of the ns - 1 frames
  before it, zero rows for frames before the stream's start;
- the ring of R = ns - 1 + 16 spectrum rows in shared memory, frame F in
  row (F - base) mod R, each row in slot order with the Nyquist bin in
  entry 257; every ring read of the MAC checks that its row holds the
  frame the index maps say (``Ring.tag``);
- per tile: the input read in place from (rows, n) at its row stride
  (float2 loads where the row is 8-byte aligned and the frame lies inside
  n, else scalar loads), the first decimation-in-frequency pass, three
  radix-4 passes through ``slot()``, the untangling in place; the
  multiply-accumulate per pair item over a window of 8 + 1 registers, bin
  k then bin M - k; the packing into the ring rows of the tile's 16
  oldest frames, the inverse there, the overlap-add with the tail carried
  from the tile before, the mix with its rounding, the time-aligned write.

The output is held against the plain twins and the JAX package's Pallas
kernels at the budgets, and bit for bit against an emulation of the earlier
two-pass kernel (its own tiles, spectrum rows in device memory and the
recomputed frame at every tile edge), at every grid: the map changes
which thread computes what and where it is kept, not the arithmetic.
Every shared-memory access of one block is logged with the thread that
makes it and checked to take one wavefront per half-warp (64-bit) or warp
(32-bit) under the bank model of tests/test_torch_fused_conv_layout.py.
The wrappers' launches are driven through a stand-in for the C library
that runs this emulation on the memory their pointers reach, so their
arguments (strides, frame offsets, lengths) are checked too.
"""

import contextlib
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from phaserotate_tpu.core.angles import degrees_to_turns as j_turns
from phaserotate_tpu.kernels import stream_conv as j_sc
from phaserotate_tpu_torch.core.angles import degrees_to_turns
from phaserotate_tpu_torch.core.fir import _partition_fir_spectra_np
from phaserotate_tpu_torch.kernels import stream_conv as sc
from test_torch_fused_conv_layout import (
    cadd,
    cmul,
    conj,
    csub,
    mul_mj,
    mul_pj,
    slot,
    wavefronts,
)

SRC = Path(sc.__file__).resolve().parent.parent / "csrc" / "stream_conv.cu"
CPU = torch.device("cpu")
F32 = np.float32

P = 256               # frame, and M, the complex FFT points
LOG2M = 8
BINS = P + 2          # spectrum row
PAIRS = P // 2        # pair items u < 128; item 128 is k = M/2
THREADS = 544         # 17 warps
FFT_THREADS = 512     # 8 groups of 64 butterflies
GROUPS = FFT_THREADS // (P // 4)
TILE = 16             # frames per tile
HALF = TILE // 2      # frames per MAC thread
QUARTER = TILE // 4   # frames per untangling thread
AHEAD = 1             # MAC steps a ring load runs ahead
TWO_PI = F32(6.28318530717958647692)

# fir taps at 2, 12, 32 and 64 partitions
TAPS = [512, 3072, 8192, 16384]


def bitrev8(p):
    p = np.asarray(p)
    return sum(((p >> b) & 1) << (LOG2M - 1 - b) for b in range(LOG2M))


def scale(a, c):
    return a[0] * c, a[1] * c


def w512(tw, i):
    """W_512^i from the (cos, sin) table: its conjugate."""
    return tw[i, 0], -tw[i, 1]


def pair_positions(u):
    """``pair_positions``: positions (pk, pmk) of item u <= 128."""
    u = np.asarray(u)
    hb = np.left_shift(1, np.frexp(np.maximum(u, 1))[1] - 1)
    flip = 2 * hb - 1
    pk = u + hb
    pk = np.where(pk & 1, pk ^ flip, pk)
    pmk = pk ^ flip
    edge = np.where(u == 0, 0, 1)
    pk = np.where((u == 0) | (u == PAIRS), edge, pk)
    pmk = np.where((u == 0) | (u == PAIRS), edge, pmk)
    return pk, pmk


def pair_roles(half_len):
    """The two-pass kernel's ``pair_role`` over its 288 threads: the
    active threads, their items and their first frames."""
    t = np.arange(288)
    lo = t < 2 * PAIRS
    u = np.where(lo, t & (PAIRS - 1), PAIRS)
    fb = np.where(lo, t >> 7, (t - 2 * PAIRS) >> 4) * half_len
    active = lo | (((t - 2 * PAIRS) & 15) == 0)
    return t[active], u[active], fb[active]


def untangle_roles():
    """``untangle_role`` over the block: threads < 512 take item t % 128
    of quarter t / 128, warp 16's lanes 0, 8, 16, 24 item 128."""
    t = np.arange(THREADS)
    lo = t < 4 * PAIRS
    u = np.where(lo, t & (PAIRS - 1), PAIRS)
    fb = np.where(lo, t >> 7, (t - 4 * PAIRS) >> 3) * QUARTER
    active = lo | (((t - 4 * PAIRS) & 7) == 0)
    return t[active], u[active], fb[active]


def mac_roles():
    """``mac_role`` over the block: threads < 512 take item t % 128 of
    half (t / 128) % 2, bin M - k from thread 256 on (``upper``); warp
    16's lanes 0 and 16 item 128."""
    t = np.arange(THREADS)
    lo = t < 4 * PAIRS
    u = np.where(lo, t & (PAIRS - 1), PAIRS)
    fb = np.where(lo, (t >> 7) & 1, (t - 4 * PAIRS) >> 4) * HALF
    upper = lo & (t >= 2 * PAIRS)
    active = lo | (((t - 4 * PAIRS) & 15) == 0)
    return t[active], u[active], fb[active], upper[active]


class Smem:
    """The frames of every emulated block in shared memory, (blocks,
    frames, P, 2) float32 in slot order.  Each access is one warp
    instruction of the block: it logs (threads, address, bytes) with the
    address in float2 units."""

    def __init__(self, blocks: int, frames: int):
        self.z = np.zeros((blocks, frames, P, 2), F32)
        self.log = []

    def load(self, t, f, i):
        s = slot(i)
        self.log.append((t, f * P + s, 8))
        v = self.z[:, f, s]
        return v[..., 0], v[..., 1]

    def store(self, t, f, i, v):
        s = slot(i)
        self.log.append((t, f * P + s, 8))
        self.z[:, f, s, 0], self.z[:, f, s, 1] = v


def radix4(log2h):
    """Butterfly g = t % 64 of a radix-4 pass with larger span 2^log2h."""
    t = np.arange(FFT_THREADS)
    g = t & (P // 4 - 1)
    q = 1 << (log2h - 1)
    j = g & (q - 1)
    p0 = ((g >> (log2h - 1)) << (log2h + 1)) + j
    return t, j, (p0, p0 + q, p0 + 2 * q, p0 + 3 * q)


def frame_iterations(t, n_frames, lo=0):
    """A group's frames lo + t // 64, + 4, ... below n_frames: (active
    mask, frame) per iteration of the per-thread frame loop."""
    for it in range(-(-(n_frames - lo) // GROUPS)):
        f = lo + t // (P // 4) + GROUPS * it
        yield f < n_frames, f


def dif_passes(sm, tw, n_frames, lo=0):
    for log2h in (5, 3, 1):
        t, j, p = radix4(log2h)
        wa = w512(tw, j << (LOG2M - log2h))
        wc = w512(tw, (2 * j) << (LOG2M - log2h))
        for a, f in frame_iterations(t, n_frames, lo):
            ta, fa, pa = t[a], f[a], [pi[a] for pi in p]
            waa, wca = (wa[0][a], wa[1][a]), (wc[0][a], wc[1][a])
            a0, a1, a2, a3 = (sm.load(ta, fa, pi) for pi in pa)
            x0, d0 = cadd(a0, a2), cmul(csub(a0, a2), waa)
            x1, d1 = cadd(a1, a3), cmul(mul_mj(csub(a1, a3)), waa)
            sm.store(ta, fa, pa[0], cadd(x0, x1))
            sm.store(ta, fa, pa[1], cmul(csub(x0, x1), wca))
            sm.store(ta, fa, pa[2], cadd(d0, d1))
            sm.store(ta, fa, pa[3], cmul(csub(d0, d1), wca))


def dit_passes(sm, tw, n_frames):
    for log2h in (1, 3, 5, 7):
        t, j, p = radix4(log2h)
        wa = tw[j << (LOG2M - log2h)].T
        wc = tw[(2 * j) << (LOG2M - log2h)].T
        for a, f in frame_iterations(t, n_frames):
            ta, fa, pa = t[a], f[a], [pi[a] for pi in p]
            waa, wca = (wa[0][a], wa[1][a]), (wc[0][a], wc[1][a])
            a0, a1, a2, a3 = (sm.load(ta, fa, pi) for pi in pa)
            t1, t3 = cmul(a1, wca), cmul(a3, wca)
            x0, x1 = cadd(a0, t1), csub(a0, t1)
            x2, x3 = cadd(a2, t3), csub(a2, t3)
            u = cmul(x2, waa)
            v = cmul(mul_pj(x3), waa)
            sm.store(ta, fa, pa[0], cadd(x0, u))
            sm.store(ta, fa, pa[2], csub(x0, u))
            sm.store(ta, fa, pa[1], cadd(x1, v))
            sm.store(ta, fa, pa[3], csub(x1, v))


# ---- the earlier two passes: the reference the one-pass map is held to ----

FWD_TILE = 16
CONV_TILE = 16
CONV_FRAMES = CONV_TILE + 1
FWD_HALF = FWD_TILE // 2
CONV_HALF = (CONV_FRAMES + 1) // 2


def fft_forward(frames: np.ndarray, tw: np.ndarray):
    """Pass 1 of the two-pass kernel over (rows, n_frames, P) frames: the
    spectrum rows (rows, n_frames, BINS, 2) in position order."""
    rows, n_frames, _ = frames.shape
    tiles = -(-n_frames // FWD_TILE)
    xp = np.zeros((rows, tiles * FWD_TILE, P), F32)
    xp[:, :n_frames] = frames
    pairs = xp.reshape(rows * tiles, FWD_TILE, P // 2, 2)
    sm = Smem(rows * tiles, FWD_TILE)
    t = np.arange(FFT_THREADS)
    j = t & (P // 4 - 1)
    wa, wc = w512(tw, 2 * j), w512(tw, 4 * j)
    for _, f in frame_iterations(t, FWD_TILE):  # the span-128 pass
        a0 = pairs[:, f, j, 0], pairs[:, f, j, 1]
        a1 = pairs[:, f, j + P // 4, 0], pairs[:, f, j + P // 4, 1]
        d0, d1 = cmul(a0, wa), cmul(mul_mj(a1), wa)
        sm.store(t, f, j, cadd(a0, a1))
        sm.store(t, f, j + P // 4, cmul(csub(a0, a1), wc))
        sm.store(t, f, j + P // 2, cadd(d0, d1))
        sm.store(t, f, j + 3 * P // 4, cmul(csub(d0, d1), wc))
    dif_passes(sm, tw, FWD_TILE)

    spec = np.zeros((rows * tiles, FWD_TILE, BINS, 2), F32)
    t, u, fb = pair_roles(FWD_HALF)
    pk, pmk = pair_positions(u)
    w = w512(tw, bitrev8(pk))
    half = F32(0.5)
    dc, two = u == 0, (u != 0) & (pmk != pk)
    for i in range(FWD_HALF):
        f = fb + i
        a = sm.load(t, f, pk)
        c = a[0].copy(), a[1].copy()  # items 0 and 128: one position
        one = pmk == pk
        cb = sm.load(t[~one], f[~one], pmk[~one])
        c[0][:, ~one], c[1][:, ~one] = cb
        c = conj(c)
        e = half * (a[0] + c[0]), half * (a[1] + c[1])
        o = mul_mj((half * (a[0] - c[0]), half * (a[1] - c[1])))
        wo = cmul(w, o)
        xk = np.stack(cadd(e, wo), -1)
        xmk = np.stack(conj(csub(e, wo)), -1)
        # X[0] = E + O and X[M] = E - O are real
        xk[:, dc] = np.stack([e[0] + o[0], np.zeros_like(e[0])], -1)[:, dc]
        spec[:, f, pk] = xk
        spec[:, f[two], pmk[two]] = xmk[:, two]
        spec[:, f[dc], P, 0] = (e[0] - o[0])[:, dc]
    return spec.reshape(rows, tiles * FWD_TILE, BINS, 2)[:, :n_frames]


def conv_mix(frames, spec, fir, tw, angs, d_frames):
    """Pass 2 of the two-pass kernel: (rows, n_frames, P) output."""
    rows, n_frames, _ = frames.shape
    ns = fir.shape[0] - 2  # the kernel's parts end in two zero rows
    tiles = -(-n_frames // CONV_TILE)
    t, u, fb = pair_roles(CONV_HALF)
    pk, pmk = pair_positions(u)
    qmk = np.where(u == 0, P, pmk)
    # frames outside [0, n_frames) read as zeros
    lo = ns + 1
    sp = np.zeros((rows, lo + n_frames + CONV_FRAMES + CONV_TILE, BINS, 2),
                  F32)
    sp[:, lo : lo + n_frames] = spec
    f0 = np.arange(tiles) * CONV_TILE
    # fr[tile, thread, i]: the frame of sum i
    fr = f0[:, None, None] - 1 + fb[None, :, None] + np.arange(CONV_HALF)
    shape = (rows, tiles, len(t), CONV_HALF)
    yk = [np.zeros(shape, F32), np.zeros(shape, F32)]
    ymk = [np.zeros(shape, F32), np.zeros(shape, F32)]
    for s in range(ns):  # the window's entries at step s: frame fr - s
        src = fr - s + lo
        for acc, q in ((yk, pk), (ymk, qmk)):
            x = sp[:, src, q[None, :, None]]
            g = fir[s, q][:, None]
            acc[0] += x[..., 0] * g[..., 0] - x[..., 1] * g[..., 1]
            acc[1] += x[..., 0] * g[..., 1] + x[..., 1] * g[..., 0]
    blocks = rows * tiles
    yk = [a.reshape(blocks, len(t), CONV_HALF) for a in yk]
    ymk = [a.reshape(blocks, len(t), CONV_HALF) for a in ymk]

    sm = Smem(blocks, CONV_FRAMES)
    wk = bitrev8(pk)
    wn = tw[wk, 0], tw[wk, 1]  # W_N^-k
    inv_n = F32(1.0) / F32(2 * P)
    for i in range(CONV_HALF):
        f = fb + i
        a = f < CONV_FRAMES
        ta, fa, ua = t[a], f[a], u[a]
        # bin k's sums wait in the pair's first slot while bin M - k runs
        sm.store(ta, fa, pk[a], (yk[0][:, a, i], yk[1][:, a, i]))
        yka = sm.load(ta, fa, pk[a])
        yka = yka[0].copy(), yka[1].copy()
        ymka = ymk[0][:, a, i].copy(), ymk[1][:, a, i].copy()
        yka[1][:, ua == 0] = 0.0   # irfft drops Im U[0] and Im U[M]
        ymka[1][:, ua == 0] = 0.0
        p = cadd(yka, conj(ymka))
        q = cmul((wn[0][a], wn[1][a]), csub(yka, conj(ymka)))
        sm.store(ta, fa, pk[a], scale(cadd(p, mul_pj(q)), inv_n))
        two = pmk[a] != pk[a]
        wmk = scale(cadd(conj(p), mul_pj(conj(q))), inv_n)
        sm.store(ta[two], fa[two], pmk[a][two],
                 (wmk[0][:, two], wmk[1][:, two]))
    dit_passes(sm, tw, CONV_FRAMES)

    zf = sm.z.reshape(blocks, CONV_FRAMES * 2 * P)
    m = np.arange(P)
    head = 2 * slot(m >> 1) + (m & 1)
    tail = 2 * slot(P // 2 + (m >> 1)) + (m & 1)
    out = np.zeros((rows, tiles, CONV_TILE, P), F32)
    for f in range(1, CONV_FRAMES):
        sm.log.append((m, f * 2 * P + head, 4))
        sm.log.append((m, (f - 1) * 2 * P + tail, 4))
        h = (zf[:, f * 2 * P + head]
             + zf[:, (f - 1) * 2 * P + tail]).reshape(rows, tiles, P)
        if angs is not None:
            frn = f0 - 1 + f  # (tiles,)
            ok = (frn < n_frames)[:, None]
            dsrc = np.clip(frn - d_frames, 0, n_frames - 1)
            dry = np.where((frn >= d_frames)[:, None],
                           frames[:, dsrc], F32(0.0))
            ang = angs[:, np.minimum(frn, n_frames - 1)]
            rad = (ang[..., :1] + ang[..., 1:] * m.astype(F32)) * TWO_PI
            sn = np.sin(rad.astype(np.float64)).astype(F32)
            cs = np.cos(rad.astype(np.float64)).astype(F32)
            h = np.where(ok, cs * dry + sn * h, F32(0.0))
        out[:, :, f - 1] = h
    return out.reshape(rows, tiles * CONV_TILE, P)[:, :n_frames]




def two_pass(frames: np.ndarray, fir_taps: int, angs=None):
    """Both passes on (B, n_frames, P) frames as their wrapper ran them."""
    fir = sc._fir_parts(fir_taps, CPU).numpy()
    tw = sc._twiddles(CPU).numpy()
    d_frames = (fir_taps // 2) // P if angs is not None else 0
    spec = fft_forward(frames, tw)
    return conv_mix(frames, spec, fir, tw, angs, d_frames)


def framed(x: np.ndarray, n_frames: int) -> np.ndarray:
    """(rows, n) -> (rows, n_frames, P), zero padded: the framed copy."""
    rows, n = x.shape
    xp = np.zeros((rows, n_frames * P), F32)
    xp[:, :n] = x
    return xp.reshape(rows, n_frames, P)


def two_pass_hilbert_small(x: np.ndarray, taps: int) -> np.ndarray:
    rows, n = x.shape
    n_frames = -(-n // P) + taps // P
    return two_pass(framed(x, n_frames), taps).reshape(rows, n_frames * P)


def two_pass_rotate_small(x: np.ndarray, turns: np.ndarray,
                          firlen: int) -> np.ndarray:
    rows, n = x.shape
    lat = firlen // 2
    n_frames = -(-(n + lat) // P)
    angs = np.stack([np.repeat(turns[:, None], n_frames, 1),
                     np.zeros((rows, n_frames), F32)], -1).astype(F32)
    out = two_pass(framed(x, n_frames), firlen, angs)
    return out.reshape(rows, n_frames * P)[:, lat : lat + n]


# ---- the one-pass kernel ---------------------------------------------------

NYQUIST = P + 1  # the ring entry of the Nyquist bin
NOT_A_SPECTRUM = -(1 << 40)  # the tag of a ring row that holds no spectrum


class Ring:
    """One block's ring: R rows of BINS float2 (poisoned with NaN, so a
    result that depends on a row never written shows), the stream frame
    whose spectrum each row holds (``tag``) and the access log of
    (threads, address, bytes), the address in units of the access."""

    def __init__(self, R: int, log):
        self.R = R
        self.z = np.full((R, BINS, 2), np.nan, F32)
        self.tag = np.full(R, NOT_A_SPECTRUM, np.int64)
        self.log = log
        self.checks = 0

    def row(self, r0, f):
        """``ring_row``: the ring row of the tile's frame f."""
        r = r0 + np.asarray(f)
        return np.where(r >= self.R, r - self.R, r)

    def load_at(self, t, rows, e):
        if self.log is not None:
            self.log.append((t, rows * BINS + e, 8))
        v = self.z[rows, e]
        return v[..., 0], v[..., 1]

    def store_at(self, t, rows, e, v):
        if self.log is not None:
            self.log.append((t, rows * BINS + e, 8))
        self.z[rows, e, 0], self.z[rows, e, 1] = v

    def expect(self, rows, frames, lo, hi):
        """The rows read for ``frames`` hold them, where [lo, hi) is the
        window of frames whose sums are kept."""
        used = (frames >= lo) & (frames < hi)
        assert np.array_equal(self.tag[rows[used]], frames[used]), \
            "a ring row does not hold the frame the MAC reads"
        self.checks += int(used.sum())


class Tile:
    """The tile's frame f in ring row r0 + f (mod R), elements by slot:
    the memory the butterflies of ``dif_passes`` / ``dit_passes`` see."""

    def __init__(self, ring: Ring, r0: int):
        self.ring, self.r0 = ring, r0

    def load(self, t, f, i):
        return self.ring.load_at(t, self.ring.row(self.r0, f), slot(i))

    def store(self, t, f, i, v):
        self.ring.store_at(t, self.ring.row(self.r0, f), slot(i), v)


class Signal:
    """Rows of n samples in a flat buffer, row r from element off + r*ld
    (the buffer itself 8-byte aligned, as device allocations are)."""

    def __init__(self, buf: np.ndarray, off: int, ld: int, n: int):
        self.buf, self.off, self.ld, self.n = buf, off, ld, n

    def aligned(self, row: int) -> bool:
        return (self.off + row * self.ld) % 2 == 0

    def sample(self, row: int, i):
        """``sample``: x[i] of the row, zero before 0 and at or past n."""
        i = np.asarray(i)
        if len(self.buf) == 0:
            return np.zeros(i.shape, F32)
        ok = (i >= 0) & (i < self.n)
        src = self.off + row * self.ld + np.where(ok, i, 0)
        return np.where(ok, self.buf[np.minimum(src, len(self.buf) - 1)],
                        F32(0.0)).astype(F32)


def forward(ring, r0, cnt, F0, sig, row, tw, stats):
    """``forward``: the spectra of stream frames F0 .. F0 + cnt - 1 into
    ring rows r0 .. r0 + cnt - 1 (mod R)."""
    tile = Tile(ring, r0)
    lo = 0 if F0 >= 0 else min(-F0, cnt)
    for f in range(lo):  # zero rows: threads < BINS write entry t
        t = np.arange(BINS)
        r = ring.row(r0, f)
        ring.store_at(t, np.full(BINS, r), t, (np.zeros(BINS, F32),) * 2)
        ring.tag[r] = F0 + f
    if lo == cnt:
        return
    t = np.arange(FFT_THREADS)
    j = t & (P // 4 - 1)
    wa, wc = w512(tw, 2 * j), w512(tw, 4 * j)
    for a, f in frame_iterations(t, cnt, lo):  # the span-128 pass
        ta, fa, ja = t[a], f[a], j[a]
        s0 = (F0 + fa) * P
        fast = sig.aligned(row) & (s0 + P <= sig.n)
        stats["float2_frames"] += int(fast.sum()) // (P // 4)
        stats["scalar_frames"] += int((~fast).sum()) // (P // 4)
        a0 = sig.sample(row, s0 + 2 * ja), sig.sample(row, s0 + 2 * ja + 1)
        a1 = (sig.sample(row, s0 + 2 * ja + P // 2),
              sig.sample(row, s0 + 2 * ja + P // 2 + 1))
        waa, wca = (wa[0][a], wa[1][a]), (wc[0][a], wc[1][a])
        d0, d1 = cmul(a0, waa), cmul(mul_mj(a1), waa)
        tile.store(ta, fa, ja, cadd(a0, a1))
        tile.store(ta, fa, ja + P // 4, cmul(csub(a0, a1), wca))
        tile.store(ta, fa, ja + P // 2, cadd(d0, d1))
        tile.store(ta, fa, ja + 3 * P // 4, cmul(csub(d0, d1), wca))
    dif_passes(tile, tw, cnt, lo)
    for f in range(lo, cnt):
        ring.tag[ring.row(r0, f)] = F0 + f

    # the untangling, in place
    t, u, fb = untangle_roles()
    pk, pmk = pair_positions(u)
    w = w512(tw, bitrev8(pk))
    half = F32(0.5)
    for i in range(QUARTER):
        f = fb + i
        a = (f >= lo) & (f < cnt)
        ta, fa, ua, pka, pmka = t[a], f[a], u[a], pk[a], pmk[a]
        rows = ring.row(r0, fa)
        x = ring.load_at(ta, rows, slot(pka))
        c = x[0].copy(), x[1].copy()  # items 0 and 128: one position
        two = pmka != pka
        cb = ring.load_at(ta[two], rows[two], slot(pmka[two]))
        c[0][two], c[1][two] = cb
        c = conj(c)
        e = half * (x[0] + c[0]), half * (x[1] + c[1])
        o = mul_mj((half * (x[0] - c[0]), half * (x[1] - c[1])))
        wo = cmul((w[0][a], w[1][a]), o)
        xk, xmk = cadd(e, wo), conj(csub(e, wo))
        dc = ua == 0  # X[0] = E + O and X[M] = E - O are real
        zero = np.zeros(int(dc.sum()), F32)
        ring.store_at(ta[dc], rows[dc], slot(0), ((e[0] + o[0])[dc], zero))
        ring.store_at(ta[dc], rows[dc], np.full(int(dc.sum()), NYQUIST),
                      ((e[0] - o[0])[dc], zero))
        k = ~dc
        ring.store_at(ta[k], rows[k], slot(pka[k]), (xk[0][k], xk[1][k]))
        k2 = k & two
        ring.store_at(ta[k2], rows[k2], slot(pmka[k2]),
                      (xmk[0][k2], xmk[1][k2]))


def mac_bin(ring, r0, fb, t, e, q, ns, fir, F0, cnt):
    """``mac_bin``: the sums of one bin (ring entry e, FIR position q) of
    the threads' HALF frames, over a window of HALF + AHEAD registers:
    full blocks of W steps load unchecked, the last partial block checks
    s < ns."""
    K, W, R = HALF, HALF + AHEAD, ring.R
    lo, hi = F0 - (ns - 1), F0 + cnt
    x = np.zeros((len(t), W, 2), F32)
    r = r0 + fb + 1 - AHEAD
    r = np.where(r >= R, r - R, r)
    for i in range(1 - AHEAD, K):
        ring.expect(r, F0 + fb + i, lo, hi)
        x[:, (i + W) % W] = np.stack(ring.load_at(t, r, e), -1)
        r = np.where(r + 1 == R, 0, r + 1)
    r = r0 + fb - AHEAD
    r = np.where(r < 0, r + R, r)
    r = np.where(r >= R, r - R, r)
    y = np.zeros((len(t), K, 2), F32)
    full = ns - ns % W
    for s in [*range(full), *range(full, min(ns, full + W - 1))]:
        j = s % W
        ring.expect(r, F0 + fb - s - AHEAD, lo, hi)
        x[:, (W - (j + AHEAD) % W) % W] = np.stack(ring.load_at(t, r, e), -1)
        r = np.where(r == 0, R - 1, r - 1)
        g = fir[s, q][:, None]
        xi = x[:, (np.arange(K) - j + W) % W]
        y[..., 0] += xi[..., 0] * g[..., 0] - xi[..., 1] * g[..., 1]
        y[..., 1] += xi[..., 0] * g[..., 1] + xi[..., 1] * g[..., 0]
    return y


def conv_tile(ring, r0, cnt, F0, fs, sig, row, tw, fir, ns, carry, mix,
              out):
    """One tile after its forward stage: MAC, packing into the oldest
    rows, inverse, overlap-add with ``carry``, mix and write.  Returns the
    tail of the tile's last frame."""
    out_buf, out_off, out_ld, out_len, d_out, d_dry = out
    t, u, fb, upper = mac_roles()
    pk, pmk = pair_positions(u)
    emk = np.where(u == 0, NYQUIST, slot(pmk))
    e = np.where(upper, emk, slot(pk))
    q = np.where(upper, np.where(u == 0, P, pmk), pk)
    y = mac_bin(ring, r0, fb, t, e, q, ns, fir, F0, cnt)

    rz = (r0 + TILE) % ring.R
    for f in range(cnt):  # the oldest rows now hold no spectrum
        ring.tag[ring.row(rz, f)] = NOT_A_SPECTRUM
    for i in range(HALF):  # the sums of bin M - k wait there
        a = upper & (fb + i < cnt)
        ring.store_at(t[a], ring.row(rz, fb[a] + i), emk[a],
                      (y[a, i, 0], y[a, i, 1]))
    wk = bitrev8(pk)
    wn = tw[wk, 0], tw[wk, 1]  # W_N^-k
    inv_n = F32(1.0) / F32(2 * P)
    for i in range(HALF):
        f = fb + i
        a = ~upper & (f < cnt)
        ta, rows, ua = t[a], ring.row(rz, f[a]), u[a]
        ya = y[a, i, 0].copy(), y[a, i, 1].copy()
        ymka = ya[0].copy(), ya[1].copy()  # item 128: one bin
        two = ua != PAIRS
        c = ring.load_at(ta[two], rows[two], emk[a][two])
        ymka[0][two], ymka[1][two] = c
        ya[1][ua == 0] = 0.0   # irfft drops Im U[0] and Im U[M]
        ymka[1][ua == 0] = 0.0
        p = cadd(ya, conj(ymka))
        q2 = cmul((wn[0][a], wn[1][a]), csub(ya, conj(ymka)))
        ring.store_at(ta, rows, slot(pk[a]), scale(cadd(p, mul_pj(q2)),
                                                   inv_n))
        b = pmk[a] != pk[a]
        wmk = scale(cadd(conj(p), mul_pj(conj(q2))), inv_n)
        ring.store_at(ta[b], rows[b], slot(pmk[a][b]), (wmk[0][b], wmk[1][b]))
    dit_passes(Tile(ring, rz), tw, cnt)

    zf = ring.z.reshape(ring.R, 2 * BINS)
    t = np.arange(2 * P)  # thread (m, t // 256): frames fo .. fo + 7
    m, fo = t & (P - 1), (t >> 8) * HALF
    head = 2 * slot(m >> 1) + (m & 1)
    tail = 2 * slot(P // 2 + (m >> 1)) + (m & 1)
    rows = np.asarray(ring.row(rz, np.maximum(fo - 1, 0)))
    tl = np.where(fo == 0, np.tile(carry, 2), zf[rows, tail])
    if ring.log is not None:
        ring.log.append((t[fo > 0], (rows * 2 * BINS + tail)[fo > 0], 4))
    for i in range(HALF):
        f = fo + i
        a = f < cnt
        if not a.any():
            continue
        ta, fa, ma = t[a], f[a], m[a]
        rows = np.asarray(ring.row(rz, fa))
        if ring.log is not None:
            ring.log.append((ta, rows * 2 * BINS + head[a], 4))
            ring.log.append((ta, rows * 2 * BINS + tail[a], 4))
        h = zf[rows, head[a]] + tl[a]
        tl[a] = zf[rows, tail[a]]
        F = F0 + fa
        keep = F > fs  # the segment's first frame: its tail only
        pos = (F - d_out) * P + ma
        if mix is not None:
            ang = np.stack([mix(Fi) for Fi in F])
            rad = (ang[:, 0] + ang[:, 1] * ma.astype(F32)) * TWO_PI
            sn = np.sin(rad.astype(np.float64)).astype(F32)
            cs = np.cos(rad.astype(np.float64)).astype(F32)
            dry = sig.sample(row, (F - d_dry) * P + ma)
            h = cs * dry + sn * h
        ok = keep & (pos < out_len)
        out_buf[out_off + row * out_ld + pos[ok]] = h[ok]
    # the first half's carry: the tail of the tile's last frame
    return zf[int(ring.row(rz, cnt - 1)), tail[:P]].copy()


def run_start(b, total, grid):
    return (b * total) // grid


def stream_runs(sig, rows, fir_taps, n_out, out, grid, angs=None,
                log_block=None):
    """The kernel over ``rows`` rows of ``sig`` with ``grid`` blocks:
    ``out`` = (flat buffer, offset, row stride, out_len, d_out, d_dry),
    ``angs`` = (flat float2 buffer (k, 2), row stride, frame stride) or
    None.  Returns the stats (frames read each way, ring checks) and the
    access log of block ``log_block``."""
    fir = sc._fir_parts(fir_taps, CPU).numpy()
    tw = sc._twiddles(CPU).numpy()
    ns = fir.shape[0] - 2  # two zero rows last
    R = ns - 1 + TILE
    d_out = out[4]
    stats = dict(float2_frames=0, scalar_frames=0, checks=0, segments=0,
                 log=[])
    total = rows * n_out
    for b in range(grid):
        g, g1 = run_start(b, total, grid), run_start(b + 1, total, grid)
        while g < g1:
            row = g // n_out
            o0 = g - row * n_out
            o1 = min(g1 - row * n_out, n_out)
            g = row * n_out + o1
            stats["segments"] += 1
            # a segment poisons the ring: nothing of the last one survives
            ring = Ring(R, stats["log"] if b == log_block else None)
            mix = None
            if angs is not None:
                buf, ang_ld, ang_fs = angs
                mix = (lambda F, row=row: buf[row * ang_ld + F * ang_fs]
                       if F >= 0 else np.zeros(2, F32))
            fs, fe = o0 + d_out - 1, o1 + d_out
            r0 = 0
            for w in range(fs - (ns - 1), fs, TILE):  # the warm-up
                cnt = min(TILE, fs - w)
                forward(ring, r0, cnt, w, sig, row, tw, stats)
                r0 += cnt
            carry = np.zeros(P, F32)
            for F0 in range(fs, fe, TILE):
                cnt = min(TILE, fe - F0)
                forward(ring, r0, cnt, F0, sig, row, tw, stats)
                carry = conv_tile(ring, r0, cnt, F0, fs, sig, row, tw, fir,
                                  ns, carry, mix, out)
                r0 = (r0 + cnt) % R
            stats["checks"] += ring.checks
    return stats


def emulated_hilbert_small(x: np.ndarray, taps: int, grid: int = 3,
                           stats: dict | None = None) -> np.ndarray:
    rows, n = x.shape
    n_out = -(-n // P) + taps // P
    out = np.full((rows, n_out * P), np.nan, F32)
    st = stream_runs(Signal(x.reshape(-1), 0, n, n), rows, taps, n_out,
                     (out.reshape(-1), 0, n_out * P, n_out * P, 0, 0), grid)
    if stats is not None:
        stats.update(st)
    return out


def emulated_rotate_small(x: np.ndarray, turns: np.ndarray, firlen: int,
                          grid: int = 3) -> np.ndarray:
    rows, n = x.shape
    d = (firlen // 2) // P
    out = np.full((rows, n), np.nan, F32)
    angs = np.stack([turns, np.zeros_like(turns)], -1).astype(F32)
    stream_runs(Signal(x.reshape(-1), 0, n, n), rows, firlen, -(-n // P),
                (out.reshape(-1), 0, n, n, d, d), grid, (angs, 1, 0))
    return out


def emulated_stream_mix(frames: np.ndarray, params: np.ndarray, firlen: int,
                        grid: int = 3, log_block=None):
    b, n_frames, _ = frames.shape
    n = n_frames * P
    out = np.full((b, n), np.nan, F32)
    st = stream_runs(Signal(frames.reshape(-1), 0, n, n), b, firlen,
                     n_frames, (out.reshape(-1), 0, n, n, 0,
                                (firlen // 2) // P), grid,
                     (params.reshape(-1, 2), n_frames, 1), log_block)
    return out.reshape(b, n_frames, P), st


# ---- a stand-in for the C library: the wrappers' launches, emulated --------


def _floats(ptr: int, count: int) -> np.ndarray:
    """The ``count`` float32 at address ``ptr`` as a numpy view."""
    if count <= 0:
        return np.zeros(0, F32)
    return np.ctypeslib.as_array((ctypes.c_float * count).from_address(ptr))


class FakeLib:
    """``prt_stream_conv`` / ``prt_stream_conv_grid`` over CPU memory: the
    launch runs :func:`stream_runs` on the extent of each pointer that its
    arguments allow the kernel to touch, and writes the output there."""

    def __init__(self, grid: int):
        self.grid, self.calls = grid, []

    def prt_stream_conv_grid(self, ns, mix, info):
        info[0], info[1] = self.grid, THREADS
        return 0

    def prt_stream_conv(self, x, x_ld, n, fir, tw, angs, ang_ld, ang_fs, out,
                        out_ld, out_len, rows, n_out, ns, d_out, d_dry, grid,
                        stream):
        self.calls.append(dict(x_ld=x_ld, n=n, ang_ld=ang_ld, ang_fs=ang_fs,
                               out_ld=out_ld, out_len=out_len, rows=rows,
                               n_out=n_out, ns=ns, d_out=d_out, d_dry=d_dry,
                               grid=grid))
        assert 1 <= grid <= rows * n_out and out_len <= n_out * P
        xbuf = _floats(x, (rows - 1) * x_ld + n if n else 0)
        obuf = _floats(out, (rows - 1) * out_ld + out_len)
        a = None
        if angs is not None:
            frames = (rows - 1) * ang_ld + (n_out + d_out - 1) * ang_fs + 1
            a = (_floats(angs, 2 * frames).reshape(-1, 2), ang_ld, ang_fs)
        stream_runs(Signal(xbuf, 0, x_ld, n), rows, ns * P, n_out,
                    (obuf, 0, out_ld, out_len, d_out, d_dry), grid, a)
        return 0


@contextlib.contextmanager
def fake_card(monkeypatch, grid):
    """Route ``sc._launch`` to :class:`FakeLib` for CPU tensors."""
    lib = FakeLib(grid)
    real_empty = torch.empty

    def empty(*args, **kwargs):  # outputs are poisoned, so gaps show
        return real_empty(*args, **kwargs).fill_(float("nan"))

    monkeypatch.setattr(sc._build, "lib", lambda: lib)
    monkeypatch.setattr(sc.torch, "empty", empty)
    monkeypatch.setattr(sc.torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(sc.torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    sc.kernel_geometry.cache_clear()
    try:
        yield lib
    finally:
        sc.kernel_geometry.cache_clear()



def _signal(seed: int, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(F32)


def test_constants_and_slot_are_the_kernels():
    text = SRC.read_text()
    body = re.search(r"int slot\(int i\) \{\s*return ([^;]+);", text).group(1)
    assert body == "i ^ (((i >> 4) & 3) * 5)"
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    emulated = {"kP": "256", "kLog2M": "8", "kThreads": "544",
                "kFftThreads": "512", "kTile": "16", "kAhead": "1",
                "kMinNs": "2", "kMaxNs": "64"}
    assert {k: consts[k] for k in emulated} == emulated
    assert "constexpr int kHalf = kTile / 2;" in text
    assert "constexpr int kQuarter = kTile / 4;" in text
    assert "constexpr int kNyquist = kP + 1;" in text
    # the one-pass map's formulas, as emulated above
    for formula in (
            "const int R = ns - 1 + kTile;",
            "static_cast<long long>(o0) + d_out - 1;",
            "for (long long w = fs - (ns - 1); w < fs; w += kTile)",
            "r0 + kTile < R ? r0 + kTile : r0 + kTile - R;",
            "const int w_lo = F0 + fo > fs ? 0 : 1;",
            "const long long p0 = (F0 + fo - d_out) * kP + m;",
            "const long long d0 = (F0 + fo - d_dry) * kP + m;",
            "angs[row * ang_ld + F * ang_fs]",
            "if (aligned && s0 + kP <= n)",
            "return (b * total) / grid;"):
        assert formula in text, formula
    # one kernel, no spectrum buffer, no direct transform
    assert text.count("__global__") == 1 and "spec" not in text.split(
        "extern \"C\" int prt_stream_conv(")[1]
    assert "tw_s[((n + q) * k)" not in text and "(2 * kp * m)" not in text


def test_pair_walk_covers_every_position_once():
    u = np.arange(PAIRS + 1)
    pk, pmk = pair_positions(u)
    k = bitrev8(pk)
    assert np.array_equal(np.sort(k), np.arange(PAIRS + 1))
    assert np.array_equal(bitrev8(pmk), (P - k) % P)
    both = np.concatenate([pk, pmk[pmk != pk]])
    assert np.array_equal(np.sort(both), np.arange(P))
    # the untangling: every (item, frame) of a tile owned by one thread
    t, tu, fb = untangle_roles()
    owned = sorted((a, b) for ui, f in zip(tu, fb)
                   for a, b in [(ui, f + i) for i in range(QUARTER)])
    assert owned == [(a, b) for a in range(PAIRS + 1) for b in range(TILE)]
    # the MAC: every (item, frame, bin) by one thread, item 128 one bin
    t, tu, fb, upper = mac_roles()
    owned = sorted((a, b, int(c)) for ui, f, c in zip(tu, fb, upper)
                   for a, b in [(ui, f + i) for i in range(HALF)])
    assert owned == [(a, b, c) for a in range(PAIRS + 1)
                     for b in range(TILE) for c in range(1 + (a < PAIRS))]
    assert len(t) == 4 * PAIRS + 2 and t.max() < THREADS


def test_pass_twiddles_are_the_tables_entries():
    """The stage-major pass table the kernel fills (``kPassTw``,
    ``pass_off``) holds, for each radix-4 pass and butterfly j, the
    entries the passes read from the 512-entry table, and a half-warp's
    reads are contiguous or one broadcast (one wavefront)."""
    text = SRC.read_text()
    assert "constexpr int kPassTw = 1 + 4 + 16 + 64;" in text
    assert "return ((1 << (log2h - 1)) - 1) / 3;" in text
    assert ("const int log2h = t < 1 ? 1 : (t < 5 ? 3 : (t < 21 ? 5 : 7));"
            in text)
    tw = sc._twiddles(CPU).numpy()

    def pass_off(log2h):
        return ((1 << (log2h - 1)) - 1) // 3

    table = np.zeros((85, 4), F32)
    for t in range(85):
        log2h = 1 if t < 1 else 3 if t < 5 else 5 if t < 21 else 7
        j = t - pass_off(log2h)
        table[t, :2] = tw[j << (LOG2M - log2h)]
        table[t, 2:] = tw[(2 * j) << (LOG2M - log2h)]
    g = np.arange(P // 4)
    for log2h in (1, 3, 5, 7):
        j = g & ((1 << (log2h - 1)) - 1)
        e = table[pass_off(log2h) + j]
        np.testing.assert_array_equal(e[:, :2], tw[j << (LOG2M - log2h)])
        np.testing.assert_array_equal(e[:, 2:],
                                      tw[(2 * j) << (LOG2M - log2h)])
        # float4 reads: a quarter-warp is one wavefront when its entries
        # are contiguous or the same
        w, best = wavefronts(g, pass_off(log2h) + j, 16)
        assert w == best


@pytest.mark.parametrize("taps", TAPS)
def test_fir_parts_are_in_position_order(taps):
    parts = sc._fir_parts(taps, CPU)
    spec = _partition_fir_spectra_np(taps, P)
    assert parts.shape == (taps // P + 2, BINS, 2)  # two zero rows last
    want = np.zeros((taps // P + 2, BINS, 2), F32)
    ns = taps // P
    want[:ns, :P, 0] = spec[:, bitrev8(np.arange(P))].real
    want[:ns, :P, 1] = spec[:, bitrev8(np.arange(P))].imag
    want[:ns, P, 0], want[:ns, P, 1] = spec[:, P].real, spec[:, P].imag
    np.testing.assert_array_equal(parts.numpy(), want)


def test_forward_rows_are_the_rfft_in_position_order():
    """The ring rows after a forward stage, read through slot(), are the
    rfft in position order: the same rows, bit for bit, as the two-pass
    kernel's pass 1
    wrote to device memory; frames before the stream are zero rows."""
    x = _signal(1, (1, 37 * P))
    tw = sc._twiddles(CPU).numpy()
    ring = Ring(40, None)
    stats = dict(float2_frames=0, scalar_frames=0)
    sig = Signal(x.reshape(-1), 0, x.shape[1], x.shape[1])
    forward(ring, 0, 16, -3, sig, 0, tw, stats)   # 3 zero rows, 13 frames
    forward(ring, 16, 16, 13, sig, 0, tw, stats)
    forward(ring, 32, 8, 29, sig, 0, tw, stats)
    assert list(ring.tag) == list(range(-3, 37))
    pos = np.append(slot(np.arange(P)), NYQUIST)  # position order
    got = ring.z[:, pos]
    assert np.all(got[:3] == 0)
    frames = x.reshape(37, P)
    want = fft_forward(frames[None], tw)[0][:, : P + 1]
    np.testing.assert_array_equal(got[3:], want)
    ref = np.fft.rfft(frames.astype(np.float64), n=2 * P)
    c = got[3:, ..., 0] + 1j * got[3:, ..., 1]
    np.testing.assert_allclose(c[:, :P], ref[:, bitrev8(np.arange(P))],
                               atol=2e-4)
    np.testing.assert_allclose(c[:, P], ref[:, P], atol=2e-4)
    assert np.all(got[3:, [0, P], 1] == 0)
    assert stats == dict(float2_frames=37, scalar_frames=0)


@pytest.mark.parametrize("taps", TAPS)
def test_emulated_conv_matches_plain_twin(taps):
    x = _signal(taps, (2, 5003))
    got = emulated_hilbert_small(x, taps)
    want = sc.hilbert_small_plain(torch.from_numpy(x), taps).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("firlen", TAPS)
def test_emulated_mix_matches_plain_twin(firlen):
    x = _signal(firlen + 1, (3, 4999))
    degs = np.asarray([0.0, 35.0, -120.0], F32)
    turns = degrees_to_turns(degs).numpy()
    got = emulated_rotate_small(x, turns, firlen)
    want = sc.rotate_small_plain(torch.from_numpy(x), torch.from_numpy(turns),
                                 firlen).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() < 2e-5
    np.testing.assert_array_equal(got[0], x[0])  # cos 0 = 1, sin 0 = 0


def _ramp(seed, rows, n_frames):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((rows, n_frames, P)).astype(F32)
    params = np.stack([rng.uniform(-0.5, 0.5, (rows, n_frames)),
                       rng.uniform(-2e-4, 2e-4, (rows, n_frames))],
                      -1).astype(F32)
    return frames, params


@pytest.mark.parametrize("firlen", TAPS)
def test_emulated_ramp_matches_plain_twin(firlen):
    frames, params = _ramp(firlen + 2, 2, 70)
    got, _ = emulated_stream_mix(frames, params, firlen)
    want = sc.fused_stream_mix_plain(torch.from_numpy(frames),
                                     torch.from_numpy(params), firlen).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("taps", [3072, 8192])
def test_emulated_conv_matches_jax_kernel(taps):
    x = _signal(taps + 3, (2, 5000))
    want = np.asarray(j_sc.fused_hilbert_small(x, taps, t_blocks=16))
    got = emulated_hilbert_small(x, taps)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("firlen", [3072, 8192])
def test_emulated_mix_matches_jax_kernel(firlen):
    x = _signal(firlen + 4, (3, 9000))
    degs = np.asarray([0.0, 90.0, -77.0], F32)
    want = np.asarray(j_sc.fused_rotate_small(x, j_turns(degs), firlen,
                                              t_blocks=16))
    got = emulated_rotate_small(x, degrees_to_turns(degs).numpy(), firlen)
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_emulated_ramp_matches_jax_kernel():
    frames, params = _ramp(5, 2, 45)
    want = np.asarray(j_sc.fused_stream_mix(frames, params, 3072,
                                            t_blocks=16))
    got, _ = emulated_stream_mix(frames, params, 3072)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_shared_memory_is_conflict_free():
    frames, params = _ramp(9, 2, 2 * TILE + 5)
    _, st = emulated_stream_mix(frames, params, 3072, grid=2, log_block=1)
    assert len(st["log"]) > 500
    total = ideal = 0
    for threads, addr, nbytes in st["log"]:
        w, best = wavefronts(threads, addr, nbytes)
        assert w == best, (len(threads), nbytes)
        total, ideal = total + w, ideal + best
    assert total == ideal


# (taps, rows, n, grid): runs inside one row, across row boundaries,
# one block for everything, a block per frame, odd n, n < 256, n = 0
RUN_CASES = [
    (512, 2, 5003, 1),      # ns 2: one run crosses the row boundary
    (512, 3, 700, 13),      # ns 2: a block per frame (13 = 3 x 4 + 1 ...)
    (3072, 2, 5003, 3),     # ns 12: runs cross rows mid-row
    (3072, 3, 1001, 2),     # odd n: rows 1 and 2 start at odd elements
    (8192, 2, 255, 5),      # ns 32: n < 256
    (8192, 3, 0, 4),        # n = 0: the whole output is the FIR's support
    (16384, 2, 2 * 4096 + 17, 3),  # ns 64: a warm-up of four chunks
]


@pytest.mark.parametrize("taps,rows,n,grid", RUN_CASES)
def test_runs_equal_the_two_pass_kernel(taps, rows, n, grid):
    """hilbert_small's map at any grid, bit for bit the two passes."""
    x = _signal(taps + rows + n + grid, (rows, n))
    stats = {}
    got = emulated_hilbert_small(x, taps, grid, stats)
    assert np.array_equal(got, two_pass_hilbert_small(x, taps))
    assert stats["checks"] > 0
    assert stats["segments"] >= max(rows, grid)
    plain = sc.hilbert_small_plain(torch.from_numpy(x), taps).numpy()
    assert np.abs(got - plain).max() < 1e-5


@pytest.mark.parametrize("taps,rows,n,grid", RUN_CASES)
def test_runs_mix_equal_the_two_pass_kernel(taps, rows, n, grid):
    """rotate_small's time-aligned writes (output frame o is stream frame
    o + lat/256) at any grid, bit for bit the two passes and slice."""
    x = _signal(taps + 2 * n + grid, (rows, n))
    turns = np.random.default_rng(grid).uniform(-0.5, 0.5, rows).astype(F32)
    got = emulated_rotate_small(x, turns, taps, grid) if n else None
    if n == 0:  # no output frame: nothing to launch
        return
    assert np.array_equal(got, two_pass_rotate_small(x, turns, taps))
    plain = sc.rotate_small_plain(torch.from_numpy(x), torch.from_numpy(turns),
                                  taps).numpy()
    assert np.abs(got - plain).max() < 2e-5


@pytest.mark.parametrize("grid", [1, 2, 7, 2 * 45])
def test_ramp_runs_equal_the_two_pass_kernel(grid):
    frames, params = _ramp(grid, 2, 45)
    got, _ = emulated_stream_mix(frames, params, 3072, grid)
    assert np.array_equal(got, two_pass(frames, 3072, params))


def test_history_resets_at_row_start():
    """One run over three rows: row 0 all NaN, rows 1 and 2 finite, so a
    history carried across a row boundary would show as NaN."""
    x = _signal(3, (3, 3000))
    x[0] = np.nan
    got = emulated_hilbert_small(x, 3072, grid=1)
    assert np.isnan(got[0]).all() and np.isfinite(got[1:]).all()
    assert np.array_equal(got[1:], emulated_hilbert_small(x[1:], 3072, 1))
    plain = sc.hilbert_small_plain(torch.from_numpy(x[1:]), 3072).numpy()
    assert np.abs(got[1:] - plain).max() < 1e-5


def test_in_place_reads_at_odd_n():
    """Odd n puts every other row's start at an odd element: those rows,
    and every frame that reaches past n, take the scalar loads."""
    n = 4 * P + 1
    x = _signal(4, (4, n))
    stats = {}
    got = emulated_hilbert_small(x, 512, grid=1, stats=stats)
    assert np.array_equal(got, two_pass_hilbert_small(x, 512))
    # rows 0 and 2 aligned: their four whole frames by float2
    assert stats["float2_frames"] == 2 * 4
    assert stats["scalar_frames"] > 0


def _x_view(seed, rows, n, lead=7):
    """(rows, n) at an odd row stride and offset, inside a larger buffer:
    a view the wrappers read in place."""
    base = torch.from_numpy(_signal(seed, (rows, n + 2 * lead + 1)))
    return base, base[:, lead : lead + n]


@pytest.mark.parametrize("taps,rows,n", [(512, 3, 1000), (3072, 2, 5003),
                                         (8192, 2, 100), (3072, 2, 0)])
def test_wrapper_launches_read_in_place(monkeypatch, taps, rows, n):
    """The wrappers' own arguments (row strides, offsets, frame counts,
    the dry delay, the angle strides) through the stand-in library: the
    output equals the two passes and the plain twins, no copy of x."""
    base, xv = _x_view(taps + n, rows, n)
    x_np = xv.numpy().copy()
    turns = torch.from_numpy(np.random.default_rng(n).uniform(
        -0.5, 0.5, rows).astype(F32))
    with fake_card(monkeypatch, 3) as lib:
        assert sc._rows(xv).data_ptr() == xv.data_ptr()  # a view
        h = sc._hilbert_small_kernel(sc._rows(xv), taps)
        y = sc._rotate_small_kernel(sc._rows(xv), turns, taps)
    assert np.array_equal(h.numpy(), two_pass_hilbert_small(x_np, taps))
    assert lib.calls[0]["x_ld"] == base.shape[1] and lib.calls[0]["n"] == n
    assert float((h - sc.hilbert_small_plain(xv, taps)).abs().max()) < 1e-5
    if n == 0:
        assert y.shape == (rows, 0) and len(lib.calls) == 1
        return
    assert lib.calls[1]["d_out"] == lib.calls[1]["d_dry"] == taps // 2 // P
    assert lib.calls[1]["out_len"] == n and lib.calls[1]["ang_fs"] == 0
    assert np.array_equal(y.numpy(), two_pass_rotate_small(
        x_np, turns.numpy(), taps))
    err = float((y - sc.rotate_small_plain(xv, turns, taps)).abs().max())
    assert err < 2e-5


def test_wrapper_stream_mix_reads_a_frame_slice(monkeypatch):
    """The engine passes a slice of its frames (B, F, 256)[:, a:b]: read
    in place at the full row stride."""
    frames, params = _ramp(11, 2, 60)
    ft, pt = torch.from_numpy(frames), torch.from_numpy(params)
    with fake_card(monkeypatch, 4) as lib:
        got = sc._stream_mix_kernel(ft[:, 10:50], pt[:, 10:50].contiguous(),
                                    3072)
    assert lib.calls[0]["x_ld"] == 60 * P and lib.calls[0]["ang_fs"] == 1
    want = two_pass(np.ascontiguousarray(frames[:, 10:50]), 3072,
                    np.ascontiguousarray(params[:, 10:50]))
    assert np.array_equal(got.numpy(), want)
