"""The FFT of csrc/stream_conv.cu, on the CPU.

A numpy float32 emulation of both passes of the kernel, written with its
own thread roles and index formulas:

- ``fft_forward``: the packed frame ``z[n] = x[2n] + j*x[2n+1]`` loaded
  straight into the first decimation-in-frequency pass, the three further
  radix-4 passes through ``slot()`` with twiddles from the 512-entry
  table, and the untangling of the pair items into spectrum rows in
  bit-reversed position order;
- ``conv_mix``: the multiply-accumulate over the partitions from a
  sliding window of frames, bin k then bin M - k, against the FIR parts
  that the wrapper permutes into the same order (``_fir_parts``), the
  packing of each pair for the decimation-in-time inverse, the inverse,
  the overlap-add of a frame's head and the tail of the frame before it
  (the recomputed frame ``f0 - 1`` at every tile edge) and the mix with
  its rounding.

The output is held against the plain twins and the JAX package's Pallas
kernels; every shared-memory access is logged with the thread that makes
it, and each one is checked to take one wavefront per half-warp (64-bit)
or warp (32-bit) under the bank model of
tests/test_torch_fused_conv_layout.py.
"""

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
THREADS = 288
FFT_THREADS = 256     # 4 groups of 64 butterflies
GROUPS = FFT_THREADS // (P // 4)
FWD_TILE = 16
CONV_TILE = 16
CONV_FRAMES = CONV_TILE + 1
FWD_HALF = FWD_TILE // 2
CONV_HALF = (CONV_FRAMES + 1) // 2
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
    """``pair_role`` over the block: the active threads, their items and
    their first frames."""
    t = np.arange(THREADS)
    lo = t < 2 * PAIRS
    u = np.where(lo, t & (PAIRS - 1), PAIRS)
    fb = np.where(lo, t >> 7, (t - 2 * PAIRS) >> 4) * half_len
    active = lo | (((t - 2 * PAIRS) & 15) == 0)
    return t[active], u[active], fb[active]


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


def frame_iterations(t, n_frames):
    """A group's frames t // 64, + 4, ...: (active mask, frame) per
    iteration of the per-thread frame loop."""
    for it in range(-(-n_frames // GROUPS)):
        f = t // (P // 4) + GROUPS * it
        yield f < n_frames, f


def dif_passes(sm, tw, n_frames):
    for log2h in (5, 3, 1):
        t, j, p = radix4(log2h)
        wa = w512(tw, j << (LOG2M - log2h))
        wc = w512(tw, (2 * j) << (LOG2M - log2h))
        for a, f in frame_iterations(t, n_frames):
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


def fft_forward(frames: np.ndarray, tw: np.ndarray):
    """Pass 1 over (rows, n_frames, P) frames: the spectrum rows (rows,
    n_frames, BINS, 2) and one block's access log."""
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
    spec = spec.reshape(rows, tiles * FWD_TILE, BINS, 2)[:, :n_frames]
    return spec, sm.log


def conv_mix(frames, spec, fir, tw, angs, d_frames):
    """Pass 2: (rows, n_frames, P) output and one block's access log."""
    rows, n_frames, _ = frames.shape
    ns = fir.shape[0]
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
    out = out.reshape(rows, tiles * CONV_TILE, P)[:, :n_frames]
    return out, sm.log


def emulate(frames: np.ndarray, fir_taps: int, angs=None):
    """Both passes on (B, n_frames, P) frames as ``sc._launch`` runs them:
    the output and the access log of one block of each pass."""
    fir = sc._fir_parts(fir_taps, CPU).numpy()
    tw = sc._twiddles(CPU).numpy()
    d_frames = (fir_taps // 2) // P if angs is not None else 0
    spec, log1 = fft_forward(frames, tw)
    out, log2 = conv_mix(frames, spec, fir, tw, angs, d_frames)
    return out, log1 + log2


def emulated_hilbert_small(x: np.ndarray, taps: int) -> np.ndarray:
    rows, n = x.shape
    n_frames = -(-n // P) + taps // P
    frames = sc._frames(torch.from_numpy(x), n_frames).numpy()
    return emulate(frames, taps)[0].reshape(rows, n_frames * P)


def emulated_rotate_small(x: np.ndarray, turns: np.ndarray,
                          firlen: int) -> np.ndarray:
    rows, n = x.shape
    lat = firlen // 2
    n_frames = -(-(n + lat) // P)
    frames = sc._frames(torch.from_numpy(x), n_frames).numpy()
    angs = np.stack([np.repeat(turns[:, None], n_frames, 1),
                     np.zeros((rows, n_frames), F32)], -1).astype(F32)
    out = emulate(frames, firlen, angs)[0].reshape(rows, n_frames * P)
    return out[:, lat : lat + n]


def _signal(seed: int, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(F32)


def test_constants_and_slot_are_the_kernels():
    text = SRC.read_text()
    body = re.search(r"int slot\(int i\) \{\s*return ([^;]+);", text).group(1)
    assert body == "i ^ (((i >> 4) & 3) * 5)"
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    emulated = {"kP": "256", "kLog2M": "8", "kThreads": "288",
                "kFftThreads": "256", "kFwdTile": "16", "kConvTile": "16"}
    assert {k: consts[k] for k in emulated} == emulated
    assert "constexpr int kConvFrames = kConvTile + 1;" in text
    assert "constexpr int kConvHalf = (kConvFrames + 1) / 2;" in text
    # no direct transform is left: no loop over all bins per sample
    assert "tw_s[((n + q) * k)" not in text and "(2 * kp * m)" not in text


def test_pair_walk_covers_every_position_once():
    u = np.arange(PAIRS + 1)
    pk, pmk = pair_positions(u)
    k = bitrev8(pk)
    assert np.array_equal(np.sort(k), np.arange(PAIRS + 1))
    assert np.array_equal(bitrev8(pmk), (P - k) % P)
    both = np.concatenate([pk, pmk[pmk != pk]])
    assert np.array_equal(np.sort(both), np.arange(P))
    t, tu, fb = pair_roles(CONV_HALF)
    # every (item, frame) of a tile is owned by exactly one thread
    owned = sorted((a, b) for ui, f in zip(tu, fb)
                   for a, b in [(ui, f + i) for i in range(CONV_HALF)]
                   if b < CONV_FRAMES)
    assert owned == [(a, b) for a in range(PAIRS + 1)
                     for b in range(CONV_FRAMES)]


@pytest.mark.parametrize("taps", TAPS)
def test_fir_parts_are_in_position_order(taps):
    parts = sc._fir_parts(taps, CPU)
    spec = _partition_fir_spectra_np(taps, P)
    assert parts.shape == (taps // P, BINS, 2)
    want = np.zeros((taps // P, BINS, 2), F32)
    want[:, :P, 0] = spec[:, bitrev8(np.arange(P))].real
    want[:, :P, 1] = spec[:, bitrev8(np.arange(P))].imag
    want[:, P, 0], want[:, P, 1] = spec[:, P].real, spec[:, P].imag
    np.testing.assert_array_equal(parts.numpy(), want)


def test_forward_rows_are_the_rfft_in_position_order():
    frames = _signal(1, (2, 37, P))
    spec, _ = fft_forward(frames, sc._twiddles(CPU).numpy())
    want = np.fft.rfft(frames.astype(np.float64), n=2 * P)
    got = spec[..., 0] + 1j * spec[..., 1]
    np.testing.assert_allclose(got[..., :P], want[..., bitrev8(np.arange(P))],
                               atol=2e-4)
    np.testing.assert_allclose(got[..., P], want[..., P], atol=2e-4)
    assert np.all(spec[:, :, [0, P], 1] == 0)
    assert np.all(spec[:, :, P + 1] == 0)


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


@pytest.mark.parametrize("firlen", TAPS)
def test_emulated_ramp_matches_plain_twin(firlen):
    rng = np.random.default_rng(firlen + 2)
    n_frames = 70
    frames = rng.standard_normal((2, n_frames, P)).astype(F32)
    params = np.stack([rng.uniform(-0.5, 0.5, (2, n_frames)),
                       rng.uniform(-2e-4, 2e-4, (2, n_frames))],
                      -1).astype(F32)
    got, _ = emulate(frames, firlen, params)
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


def test_shared_memory_is_conflict_free():
    frames = np.zeros((1, CONV_FRAMES + 2, P), F32)
    _, log = emulate(frames, 3072, np.zeros((1, CONV_FRAMES + 2, 2), F32))
    total = ideal = 0
    for threads, addr, nbytes in log:
        w, best = wavefronts(threads, addr, nbytes)
        assert w == best, (len(threads), nbytes)
        total, ideal = total + w, ideal + best
    assert total == ideal
