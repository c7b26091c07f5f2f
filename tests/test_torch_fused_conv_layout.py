"""The layout and scheduling of csrc/fused_conv.cu ``ola_runs``, on the CPU.

A numpy float32 emulation of one frame's work (copy in, ``fft_dif``,
``spectrum_product``, ``ifft_dit``, copy out), written with the kernel's
own index formulas (``p0``, ``j``, ``pass_offset``, ``slot``, the
position-order product walk) and the tables that the wrapper builds
(``_product_tables``, the stage-major pass twiddles
``_stage_twiddles_np``); then the overlap-add of the kernel's persistent
grid (``run_start``, the carry, one tail per run, ``ola_fixup``).  Every
shared-memory access and every twiddle read is logged, so the same run
gives

- the output, held against the plain twin ``fused_ola_conv_plain`` at the
  budgets of tests/test_torch_cuda.py, and bit for bit against the same
  emulation reading the natural-order twiddle table as the earlier kernel did
  (``stage_tw``) and overlapping in two passes;
- the bank-conflict count under Hopper's model: 32 four-byte banks, a
  64-bit access served per half-warp (16 bank pairs, index mod 16), a
  128-bit access per quarter-warp (8 bank quads); a wavefront serves one
  distinct address per bank pair (quad), so a request costs the largest
  number of distinct addresses in any one of them;
- the 128-byte lines each warp's twiddle read touches, were the table
  read from global memory.

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
CSRC = Path(fc.__file__).resolve().parent.parent / "csrc"
SRC = CSRC / "fused_conv.cu"


def kernel_source() -> str:
    """fused_conv.cu with the ``csrc/`` headers it includes in place, as
    the compiler reads it (the transform and the product walk live in
    ``ola_fft.cuh``, shared with hilbert32k.cu)."""
    return re.sub(r'^#include "([\w.]+)"$',
                  lambda m: (CSRC / m.group(1)).read_text(),
                  SRC.read_text(), flags=re.M)


def slot(i):
    return i ^ (((i >> 4) & 3) * 5)


class Smem:
    """One frame batch in shared memory: (frames, M, 2) float32 in slot
    order, with a log of (items, addresses, bytes) per access, and a log
    of (items, byte addresses, bytes) per read of the pass twiddles."""

    def __init__(self, n_frames: int, m: int):
        self.z = np.zeros((n_frames, m, 2), np.float32)
        self.log = []
        self.twlog = []

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
    """The earlier read: W_M^(j * M / (2h)), row j * M / h of the natural-order
    table W_N^i, i < M."""
    t = tw[j << (log2m - log2h)]
    return t[:, 0], t[:, 1]


def pass_offset(m, log2h):
    return (m - (2 << log2h)) // 3


def table_len(m):
    return (m - 1) // 3


def run_start(b, n_frames, grid):
    return (b * n_frames) // grid


class NaturalTwiddles:
    """The pass twiddles as the earlier kernel read them: two strided reads of
    the natural-order table per butterfly."""

    def __init__(self, tw):
        self.tw = tw

    def pass_pair(self, sm, g, j, log2m, log2h):
        for jj in (j, 2 * j):  # byte addresses of float2 rows
            sm.twlog.append((g, (jj << (log2m - log2h)) * 8, 8))
        return (stage_tw(self.tw, j, log2m, log2h),
                stage_tw(self.tw, 2 * j, log2m, log2h))


class StageTwiddles:
    """The pass twiddles as ``ola_runs`` reads them: row
    ``pass_offset(M, log2h) + j`` of the stage-major table, one float4
    {W_2h^j, W_h^j}, logged."""

    def __init__(self, table):
        self.table = table

    def pass_pair(self, sm, g, j, log2m, log2h):
        row = pass_offset(1 << log2m, log2h) + j
        sm.twlog.append((g, row * 16, 16))
        t = self.table[row]
        return (t[:, 0], t[:, 1]), (t[:, 2], t[:, 3])


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
        wa, wc = tw.pass_pair(sm, g, j, log2m, log2h)
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
        wa, wc = (conj(w) for w in tw.pass_pair(sm, g, j, log2m, log2h))
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


def ola_frames(frames: np.ndarray, h: np.ndarray, wp: np.ndarray, tw):
    """One frame's work over (F, parsiz) frames, every frame alike:
    (head, tail, Smem with its logs).  ``tw`` reads the pass twiddles
    (:class:`StageTwiddles` as the kernel does)."""
    n_frames, m = frames.shape
    log2m = m.bit_length() - 1
    p4 = m >> 2
    sm = Smem(n_frames, m)
    smem4 = sm.z.reshape(n_frames, m // 2, 4)  # a view: float4 slots
    i = np.arange(p4)
    s, st = slot(2 * i), slot(2 * (p4 + i))
    smem4[:, s >> 1] = pair_order(frames.reshape(n_frames, p4, 4), s)
    smem4[:, st >> 1] = 0.0  # the zero half: the slots this thread reads
    sm.log += [(i, s >> 1, 16), (i, st >> 1, 16)]
    fft_dif(sm, tw, log2m)
    spectrum_product(sm, h, wp, m)
    ifft_dit(sm, tw, log2m)
    head = pair_order(smem4[:, s >> 1], s).reshape(n_frames, m)
    tail = pair_order(smem4[:, st >> 1], st).reshape(n_frames, m)
    sm.log += [(i, s >> 1, 16), (i, st >> 1, 16)]
    return head, tail, sm


def _tables(spectrum, parsiz):
    return tuple(t.numpy() for t in fc._product_tables(spectrum, parsiz))


def emulated_ola_conv(frames: np.ndarray, spectrum: torch.Tensor,
                      parsiz: int) -> np.ndarray:
    """Every frame, then the overlap-add in a second pass over the whole
    stream, as the earlier kernel did: (B, n_blocks, parsiz) ->
    (B, n_blocks*parsiz)."""
    b, n_blocks, _ = frames.shape
    head, tail, _ = ola_frames(
        frames.reshape(-1, parsiz), *_tables(spectrum, parsiz),
        StageTwiddles(fc._stage_twiddles_np(parsiz)))
    head = head.reshape(b, n_blocks, parsiz)
    head[:, 1:] += tail.reshape(b, n_blocks, parsiz)[:, :-1]
    return head.reshape(b, n_blocks * parsiz)


def two_pass_mix(frames, h, cs, lat):
    """The earlier second pass in mix mode: ``ca * x[m - lat] + sa * h``, each
    product and the sum rounded to float32, zeros before a row's start."""
    b = frames.shape[0]
    x = frames.reshape(b, -1)
    dry = np.zeros_like(x)
    dry[:, lat:] = x[:, : x.shape[1] - lat]
    return cs[:, :1] * dry + cs[:, 1:] * h


def emulated_runs(frames: np.ndarray, spectrum: torch.Tensor, parsiz: int,
                  grid: int, cs=None, lat: int = 0) -> np.ndarray:
    """``ola_runs`` on ``grid`` blocks, then ``ola_fixup``, with the
    kernel's run bounds, carry, dry index and tail scratch, over float4s
    (B, n_blocks, parsiz) -> (B, n_blocks*parsiz); ``cs`` (B, 2) (ca, sa)
    for mix mode."""
    b, n_blocks, _ = frames.shape
    n_frames, p4 = b * n_blocks, parsiz // 4
    head, tail, _ = ola_frames(
        frames.reshape(-1, parsiz), *_tables(spectrum, parsiz),
        StageTwiddles(fc._stage_twiddles_np(parsiz)))
    head4 = head.reshape(n_frames, p4, 4)
    tail4 = tail.reshape(n_frames, p4, 4)
    src = frames.reshape(-1, 4)  # the input as float4s
    out = np.full((n_frames * p4, 4), np.nan, np.float32)
    run_tails = np.full((max(grid - 1, 1), p4, 4), np.nan, np.float32)
    i = np.arange(p4)
    for blk in range(grid):
        f0 = run_start(blk, n_frames, grid)
        f1 = run_start(blk + 1, n_frames, grid)
        assert f1 > f0, "every run holds a frame"
        carry = None
        for f in range(f0, f1):
            row = f // n_blocks
            s0 = (f - row * n_blocks) * parsiz
            has_carry = f != f0 and s0 != 0
            done = has_carry or s0 == 0
            v = head4[f]
            if has_carry:
                v = v + carry
            if cs is not None and done:
                before = s0 + 4 * i < lat
                dry = src[np.where(before, 0, f * p4 + i - lat // 4)]
                dry[before] = 0.0
                v = cs[row, 0] * dry + cs[row, 1] * v
            out[f * p4 + i] = v
            carry = tail4[f]
        if f1 < n_frames and f1 % n_blocks != 0:
            run_tails[blk] = carry
    out = out.reshape(-1)
    x = frames.reshape(-1)
    for blk in range(grid - 1):  # ola_fixup: block blk, run blk + 1
        f = run_start(blk + 1, n_frames, grid)
        if f % n_blocks == 0:
            continue
        idx = f * parsiz + np.arange(parsiz)
        v = out[idx] + run_tails[blk].reshape(-1)
        if cs is not None:
            c = cs[f // n_blocks]
            v = c[0] * x[idx - lat] + c[1] * v
        out[idx] = v
    return out.reshape(b, n_blocks * parsiz)


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
                     kernel_source()).group(1)
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
    h, wp = _tables(fc.hilbert_fir_spectrum(parsiz, parsiz), parsiz)
    _, _, sm = ola_frames(frames, h, wp,
                          StageTwiddles(fc._stage_twiddles_np(parsiz)))
    total = ideal = 0
    for items, addr, nbytes in sm.log:
        w, best = wavefronts(items, addr, nbytes)
        total, ideal = total + w, ideal + best
        if nbytes == 8 and len(items) == parsiz // 4:  # a radix-4 pass
            assert w == best, "a radix-4 pass access has a bank conflict"
        if nbytes == 8 and len(items) == parsiz // 2:  # the radix-2 stage
            assert w == best, "the radix-2 stage has a bank conflict"
        if nbytes == 16:  # the copies
            assert w == best, "a frame copy has a bank conflict"
    assert total <= 1.15 * ideal, total / ideal


# ---- the stage-major twiddle table ------------------------------------------


def test_table_formulas_are_the_kernels():
    src = kernel_source()
    assert re.search(r"int pass_offset\(int m, int log2h\) \{\s*"
                     r"return \(m - \(2 << log2h\)\) / 3;", src)
    assert re.search(r"int table_len\(int m\) \{\s*return \(m - 1\) / 3;",
                     src)
    assert re.search(r"run_start\(long long b,\s*long long n_frames,\s*"
                     r"long long grid\) \{\s*return \(b \* n_frames\) / grid;",
                     src)


@pytest.mark.parametrize("parsiz", PARSIZ)
def test_stage_table_holds_the_twiddles_each_pass_reads(parsiz):
    """Row pass_offset(M, log2h) + j is {W_2h^j, W_h^j} as the earlier kernel
    read them from the natural-order table, for every pass and j < h/2;
    the passes tile the table without a gap."""
    table = fc._stage_twiddles_np(parsiz)
    tw = fc._twiddles_np(parsiz)
    log2m = parsiz.bit_length() - 1
    assert table.dtype == np.float32
    assert table.shape == (table_len(parsiz), 4)
    assert table.nbytes == {2048: 10912, 4096: 21840, 8192: 43680,
                            16384: 87376}[parsiz]
    rows = []
    for log2h in range(log2m - 1, 0, -2):
        j = np.arange(1 << (log2h - 1))
        row = pass_offset(parsiz, log2h) + j
        wa, wc = stage_tw(tw, j, log2m, log2h), stage_tw(tw, 2 * j, log2m,
                                                         log2h)
        assert np.array_equal(table[row], np.stack([*wa, *wc], axis=1))
        rows.append(row)
    assert np.array_equal(np.concatenate(rows), np.arange(len(table)))


@pytest.mark.parametrize("parsiz", PARSIZ)
def test_stage_table_reads_equal_the_natural_reads(parsiz):
    """The emulation reading the stage-major table gives the same bits as
    the same emulation reading the natural-order table."""
    rng = np.random.default_rng(parsiz + 1)
    frames = rng.standard_normal((2, parsiz)).astype(np.float32)
    h, wp = _tables(fc.hilbert_fir_spectrum(parsiz - 1024, parsiz), parsiz)
    new = ola_frames(frames, h, wp,
                     StageTwiddles(fc._stage_twiddles_np(parsiz)))
    old = ola_frames(frames, h, wp, NaturalTwiddles(fc._twiddles_np(parsiz)))
    assert np.array_equal(new[0], old[0]) and np.array_equal(new[1], old[1])


def _lines_per_warp(twlog):
    """The most 128-byte lines one warp's read touches, per read."""
    most = []
    for items, addr, _ in twlog:
        lines = np.unique(((items // 32) << 32) | (addr // 128))
        most.append(np.unique(lines >> 32, return_counts=True)[1].max())
    return most


@pytest.mark.parametrize("parsiz", PARSIZ)
def test_twiddle_reads_are_contiguous(parsiz):
    """Each warp's read of a pass twiddle touches at most four 128-byte
    lines, were the table in global memory (512 contiguous bytes at
    most), and is one wavefront per quarter-warp from shared memory, as
    the kernel stages it; the natural-order reads it replaced touched up
    to 32 lines a warp, twice per butterfly."""
    frames = np.zeros((1, parsiz), np.float32)
    h, wp = _tables(fc.hilbert_fir_spectrum(parsiz, parsiz), parsiz)
    _, _, sm = ola_frames(frames, h, wp,
                          StageTwiddles(fc._stage_twiddles_np(parsiz)))
    log2m = parsiz.bit_length() - 1
    assert len(sm.twlog) == 2 * (log2m // 2)  # every radix-4 pass, twice
    assert max(_lines_per_warp(sm.twlog)) <= 4
    for items, addr, nbytes in sm.twlog:
        w, best = wavefronts(items, addr // nbytes, nbytes)
        assert w == best, "a twiddle read has a bank conflict"
    _, _, old = ola_frames(frames, h, wp,
                           NaturalTwiddles(fc._twiddles_np(parsiz)))
    assert len(old.twlog) == 2 * len(sm.twlog)
    assert max(_lines_per_warp(old.twlog)) == 32


# ---- the persistent grid: runs, carry, tail scratch, fix-up -----------------


RUN_CASES = [  # (rows, n_blocks, grid)
    (1, 7, 7),    # one row, runs of one frame: every frame fixed up
    (1, 9, 2),    # one row, two runs
    (3, 5, 4),    # runs cross rows; 15 frames, not a multiple of 4
    (4, 1, 3),    # n_blocks = 1: every frame a row's first
    (2, 6, 1),    # one block holds everything: no fix-up
    (5, 3, 7),    # more rows than blocks, runs of 2 and 3
    (3, 4, 12),   # as many blocks as frames
]


@pytest.mark.parametrize("rows,n_blocks,grid", RUN_CASES)
def test_runs_equal_the_two_pass_overlap_add(rows, n_blocks, grid):
    parsiz = 2048
    rng = np.random.default_rng(rows * 100 + n_blocks * 10 + grid)
    frames = rng.standard_normal((rows, n_blocks, parsiz)).astype(np.float32)
    spec = fc.hilbert_fir_spectrum(parsiz - 1024, parsiz)
    got = emulated_runs(frames, spec, parsiz, grid)
    want = emulated_ola_conv(frames, spec, parsiz)
    assert np.array_equal(got, want)
    plain = fc.fused_ola_conv_plain(torch.from_numpy(frames), spec,
                                    parsiz).numpy()
    assert np.abs(got - plain).max() < 3e-6


@pytest.mark.parametrize("rows,n_blocks,grid", RUN_CASES)
def test_runs_mix_equals_the_two_pass_mix(rows, n_blocks, grid):
    """Mix mode, as fused_rotate_fir frames it (FIR 1024, lat 512, parsiz
    2048): finished heads mixed in the copy-out, run-first frames in the
    fix-up, bit-equal to the mix after a two-pass overlap-add and within
    the mix budget of the plain twin."""
    firlen = 1024
    n = n_blocks * 2048 - firlen // 2  # n_blocks frames cover n + lat
    rng = np.random.default_rng(rows * 7 + n_blocks + grid)
    x = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32))
    turns = torch.from_numpy(rng.uniform(-0.5, 0.5, rows).astype(np.float32))
    frames, cs, spec, parsiz, lat = fc._rotate_operands(x, turns, firlen)
    assert (parsiz, lat) == (2048, 512) and frames.shape[1] == n_blocks
    frames, cs = frames.numpy(), cs.numpy()
    got = emulated_runs(frames, spec, parsiz, grid, cs, lat)
    want = two_pass_mix(frames, emulated_ola_conv(frames, spec, parsiz), cs,
                        lat)
    assert np.array_equal(got, want)
    plain = fc.fused_rotate_fir_plain(x, turns, firlen).numpy()
    assert np.abs(got[:, lat : lat + n] - plain).max() < 2e-5
