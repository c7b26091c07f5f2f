"""The shared-memory layout of csrc/fused_conv.cu ``ola_frames``, on the CPU.

A numpy float32 emulation of pass 1 (copy in, ``fft_dif``,
``spectrum_product``, ``ifft_dit``, copy out) plus the overlap-add of
pass 2, written with the kernel's own index formulas (``p0``, ``j``,
``stage_tw``, ``slot``, the position-order product walk) and the permuted
tables that the wrapper builds (``_product_tables``).  Every shared-memory
access is logged, so the same run gives

- the output, held against the plain twin ``fused_ola_conv_plain`` at the
  budgets of tests/test_torch_cuda.py;
- the bank-conflict count under Hopper's model: 32 four-byte banks, a
  64-bit access served per half-warp (16 bank pairs, index mod 16), a
  128-bit access per quarter-warp (8 bank quads); a wavefront serves one
  distinct address per bank pair (quad), so a request costs the largest
  number of distinct addresses in any one of them.

Threads walk items ``g = threadIdx.x + it * blockDim.x`` with blockDim a
multiple of 32, so one warp instruction covers the 32 aligned items
``32w .. 32w+31`` and a half-warp the items ``16h .. 16h+15``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from phaserotate_tpu_torch.kernels import fused_conv as fc

PARSIZ = [2048, 4096, 8192, 16384]
SRC = Path(fc.__file__).resolve().parent.parent / "csrc" / "fused_conv.cu"


def slot(i):
    return i ^ (((i >> 4) & 3) * 5)


class Smem:
    """One frame batch in shared memory: (frames, M, 2) float32 in slot
    order, with a log of (items, addresses, bytes) per access."""

    def __init__(self, n_frames: int, m: int):
        self.z = np.zeros((n_frames, m, 2), np.float32)
        self.log = []

    def load(self, items, i):
        s = slot(i)
        self.log.append((items, s, 8))
        return self.z[:, s, 0], self.z[:, s, 1]

    def store(self, items, i, v):
        s = slot(i)
        self.log.append((items, s, 8))
        self.z[:, s, 0], self.z[:, s, 1] = v


def cadd(a, b):
    return a[0] + b[0], a[1] + b[1]


def csub(a, b):
    return a[0] - b[0], a[1] - b[1]


def cmul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def conj(a):
    return a[0], -a[1]


def mul_mj(a):
    return a[1], -a[0]


def mul_pj(a):
    return -a[1], a[0]


def stage_tw(tw, j, log2m, log2h):
    t = tw[j << (log2m - log2h)]
    return t[:, 0], t[:, 1]


def radix4_indices(m, log2h):
    q = 1 << (log2h - 1)
    g = np.arange(m >> 2)
    j = g & (q - 1)
    p0 = ((g >> (log2h - 1)) << (log2h + 1)) + j
    return g, j, (p0, p0 + q, p0 + 2 * q, p0 + 3 * q)


def radix2(sm, m):
    g = np.arange(m >> 1)
    a, c = sm.load(g, 2 * g), sm.load(g, 2 * g + 1)
    sm.store(g, 2 * g, cadd(a, c))
    sm.store(g, 2 * g + 1, csub(a, c))


def fft_dif(sm, tw, log2m):
    m = 1 << log2m
    log2h = log2m - 1
    while log2h >= 1:
        g, j, p = radix4_indices(m, log2h)
        a0, a1, a2, a3 = (sm.load(g, pi) for pi in p)
        wa = stage_tw(tw, j, log2m, log2h)
        wc = stage_tw(tw, 2 * j, log2m, log2h)
        s0, d0 = cadd(a0, a2), cmul(csub(a0, a2), wa)
        s1, d1 = cadd(a1, a3), cmul(mul_mj(csub(a1, a3)), wa)
        sm.store(g, p[0], cadd(s0, s1))
        sm.store(g, p[1], cmul(csub(s0, s1), wc))
        sm.store(g, p[2], cadd(d0, d1))
        sm.store(g, p[3], cmul(csub(d0, d1), wc))
        log2h -= 2
    if log2h == 0:
        radix2(sm, m)


def ifft_dit(sm, tw, log2m):
    m = 1 << log2m
    log2h = 1
    if log2m & 1:
        radix2(sm, m)
        log2h = 2
    while log2h < log2m:
        g, j, p = radix4_indices(m, log2h)
        a0, a1, a2, a3 = (sm.load(g, pi) for pi in p)
        wa = conj(stage_tw(tw, j, log2m, log2h))
        wc = conj(stage_tw(tw, 2 * j, log2m, log2h))
        t1, t3 = cmul(a1, wc), cmul(a3, wc)
        s0, s1 = cadd(a0, t1), csub(a0, t1)
        s2, s3 = cadd(a2, t3), csub(a2, t3)
        u = cmul(s2, wa)
        v = cmul(mul_pj(s3), wa)
        sm.store(g, p[0], cadd(s0, u))
        sm.store(g, p[2], csub(s0, u))
        sm.store(g, p[1], cadd(s1, v))
        sm.store(g, p[3], csub(s1, v))
        log2h += 2


def spectrum_product(sm, h, wp, m):
    pk, pmk, _ = fc._product_order(m)
    u = np.arange(m // 2 + 1)
    half = np.float32(0.5)
    inv_n = np.float32(1.0) / np.float32(2 * m)
    a, b = sm.load(u, pk), conj(sm.load(u, pmk))
    e = (half * (a[0] + b[0]), half * (a[1] + b[1]))
    o = mul_mj((half * (a[0] - b[0]), half * (a[1] - b[1])))
    w = (wp[:, 0], wp[:, 1])
    wo = cmul(w, o)
    hk, hmk = (h[pk, 0], h[pk, 1]), (h[pmk, 0], h[pmk, 1])
    yk = cmul(cadd(e, wo), hk)
    ymk = cmul(conj(csub(e, wo)), hmk)
    # item 0: X[0] = E + O and X[M] = E - O, real parts only
    yk[0][:, 0] = (e[0][:, 0] + o[0][:, 0]) * h[0, 0]
    yk[1][:, 0] = 0.0
    ymk[0][:, 0] = (e[0][:, 0] - o[0][:, 0]) * h[m, 0]
    ymk[1][:, 0] = 0.0
    p = cadd(yk, conj(ymk))
    t = cmul(conj(w), csub(yk, conj(ymk)))
    wk = cadd(p, mul_pj(t))
    sm.store(u, pk, (wk[0] * inv_n, wk[1] * inv_n))
    two = pmk != pk
    wmk = cadd(conj(p), mul_pj(conj(t)))
    sm.store(u[two], pmk[two], (wmk[0][:, two] * inv_n,
                                wmk[1][:, two] * inv_n))


def pair_order(v, s):
    """(frames, n, 4) float4s; halves swapped where slot s is odd."""
    return np.where((s & 1)[None, :, None], v[..., [2, 3, 0, 1]], v)


def ola_frames(frames: np.ndarray, h: np.ndarray, wp: np.ndarray,
               tw: np.ndarray):
    """Pass 1 over (F, parsiz) frames: (head, tail, access log)."""
    n_frames, m = frames.shape
    log2m = m.bit_length() - 1
    p4 = m >> 2
    sm = Smem(n_frames, m)
    smem4 = sm.z.reshape(n_frames, m // 2, 4)  # a view: float4 slots
    i = np.arange(p4)
    s = slot(2 * i)
    smem4[:, s >> 1] = pair_order(frames.reshape(n_frames, p4, 4), s)
    smem4[:, p4 + i] = 0.0
    sm.log += [(i, s >> 1, 16), (i, p4 + i, 16)]
    fft_dif(sm, tw, log2m)
    spectrum_product(sm, h, wp, m)
    ifft_dit(sm, tw, log2m)
    st = slot(2 * (p4 + i))
    head = pair_order(smem4[:, s >> 1], s).reshape(n_frames, m)
    tail = pair_order(smem4[:, st >> 1], st).reshape(n_frames, m)
    sm.log += [(i, s >> 1, 16), (i, st >> 1, 16)]
    return head, tail, sm.log


def emulated_ola_conv(frames: np.ndarray, spectrum: torch.Tensor,
                      parsiz: int) -> np.ndarray:
    """Both passes: (B, n_blocks, parsiz) -> (B, n_blocks*parsiz)."""
    b, n_blocks, _ = frames.shape
    h, wp = (t.numpy() for t in fc._product_tables(spectrum, parsiz))
    head, tail, _ = ola_frames(frames.reshape(-1, parsiz), h, wp,
                               fc._twiddles_np(parsiz))
    head = head.reshape(b, n_blocks, parsiz)
    head[:, 1:] += tail.reshape(b, n_blocks, parsiz)[:, :-1]
    return head.reshape(b, n_blocks * parsiz)


def wavefronts(items, addr, nbytes):
    """Wavefronts of one warp instruction over all its items, and the
    ideal count (one per active half- or quarter-warp)."""
    lanes = 128 // nbytes  # threads one wavefront serves
    banks = lanes
    group = items // lanes
    key = np.unique((group << 32) | addr)
    g, a = key >> 32, key & 0xFFFFFFFF
    keys, counts = np.unique((g << 8) | (a % banks), return_counts=True)
    _, first = np.unique(keys >> 8, return_index=True)  # keys are sorted
    return int(np.maximum.reduceat(counts, first).sum()), len(first)


def test_slot_is_the_kernels_and_a_bijection():
    body = re.search(r"int slot\(int i\) \{\s*return ([^;]+);",
                     SRC.read_text()).group(1)
    assert body == "i ^ (((i >> 4) & 3) * 5)"
    for parsiz in PARSIZ:
        i = np.arange(parsiz)
        s = slot(i)
        assert np.array_equal(np.sort(s), i), parsiz
        # each aligned 16-element run maps onto itself: no padding, and
        # the zero half of a frame stays where it was
        assert np.array_equal(s >> 4, i >> 4), parsiz


@pytest.mark.parametrize("parsiz", PARSIZ)
def test_product_walk_visits_every_pair_once(parsiz):
    m = parsiz
    pk, pmk, k = fc._product_order(m)
    assert len(k) == m // 2 + 1
    assert np.array_equal(np.sort(k[:-1]), np.arange(m // 2))
    assert k[0] == 0 and k[-1] == m // 2
    # each item's partner position holds M - k (mod M)
    bits = m.bit_length() - 1
    assert np.array_equal(fc._bitrev(pmk, bits), (m - k) % m)
    # the positions of all items and partners cover [0, M) exactly once
    both = np.concatenate([pk, pmk[pmk != pk]])
    assert np.array_equal(np.sort(both), np.arange(m))
    # item u holds the pair at u + hb (lower half of [2hb, 4hb)) and its
    # complement, with k at the even position
    u = np.arange(1, m // 2)
    hb = 1 << (np.frexp(u)[1] - 1)
    lo = u + hb
    assert np.array_equal(np.minimum(pk[1:-1] % (2 * hb) + 2 * hb,
                                     pmk[1:-1] % (2 * hb) + 2 * hb), lo)
    assert np.array_equal(pk[1:-1] ^ pmk[1:-1], 2 * hb - 1)
    assert np.all(pk[1:-1] % 2 == 0)


@pytest.mark.parametrize("parsiz", PARSIZ)
def test_permuted_tables_are_the_spectrum_and_twiddles(parsiz):
    spec = fc.hilbert_fir_spectrum(parsiz - 1024, parsiz)
    h, wp = fc._product_tables(spec, parsiz)
    assert h.shape == (parsiz + 1, 2) and wp.shape == (parsiz // 2 + 1, 2)
    pk, pmk, k = fc._product_order(parsiz)
    bits = parsiz.bit_length() - 1
    ri = torch.view_as_real(spec)
    pos = np.arange(parsiz)
    assert torch.equal(h[:parsiz], ri[torch.from_numpy(fc._bitrev(pos, bits))])
    assert torch.equal(h[parsiz], ri[parsiz])
    assert torch.equal(wp, torch.from_numpy(fc._twiddles_np(parsiz)[k]))


@pytest.mark.parametrize("parsiz", PARSIZ)
def test_emulated_kernel_matches_plain_twin(parsiz):
    rng = np.random.default_rng(parsiz)
    frames = rng.standard_normal((2, 3, parsiz)).astype(np.float32)
    tol = 3e-6 if parsiz <= 4096 else 1e-5
    for firlen in (parsiz - 1024, parsiz):
        spec = fc.hilbert_fir_spectrum(firlen, parsiz)
        got = emulated_ola_conv(frames, spec, parsiz)
        want = fc.fused_ola_conv_plain(torch.from_numpy(frames), spec,
                                       parsiz).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() < tol, firlen


@pytest.mark.parametrize("parsiz", PARSIZ)
def test_shared_memory_is_conflict_free(parsiz):
    frames = np.zeros((1, parsiz), np.float32)
    h, wp = (t.numpy() for t in fc._product_tables(
        fc.hilbert_fir_spectrum(parsiz, parsiz), parsiz))
    _, _, log = ola_frames(frames, h, wp, fc._twiddles_np(parsiz))
    total = ideal = 0
    for items, addr, nbytes in log:
        w, best = wavefronts(items, addr, nbytes)
        total, ideal = total + w, ideal + best
        if nbytes == 8 and len(items) == parsiz // 4:  # a radix-4 pass
            assert w == best, "a radix-4 pass access has a bank conflict"
        if nbytes == 8 and len(items) == parsiz // 2:  # the radix-2 stage
            assert w == best, "the radix-2 stage has a bank conflict"
        if nbytes == 16:  # the copies
            assert w == best, "a frame copy has a bank conflict"
    assert total <= 1.15 * ideal, total / ideal
