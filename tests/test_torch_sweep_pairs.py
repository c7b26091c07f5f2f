"""The mirror-pair sweep of csrc/rotate_peak.cu, on the CPU.

A numpy float32 emulation of ``sweep_kernel``, written with its own thread
map (``SWEEP_*`` of kernels/rotate_peak.py, which the kernel's ``kSweep*``
mirror) and thread roles:

- staging: the tile's (b0, b1) pairs, and whether every one is finite;
- the check of the table that decides the block's path: 360 angles,
  mirror pairs bit for bit (cos[360 - u] == -cos[u], sin[360 - u] ==
  sin[u] for u = 1..179) and every |cos|, |sin| <= 1;
- the pair units: group g holds units 9g .. 9g + 8, lane l walks samples
  i = l (mod 8), unit u gives |p + q| for angle u and |q - p| for angle
  360 - u (p = c*x, q = s*h), unit 0 angles 0 and 180 in the general
  form, as warp 0's first unit of every group; then the xor-shuffle
  combine of a group's 8 lanes, the groups' maxima by angle in shared
  memory and one atomicMax per angle on the float bits;
- the general map (any other table, or a tile with a NaN or inf): K =
  ``general_slots(A)`` angles per thread (``GENERAL_SLOTS`` of
  kernels/rotate_peak.py, which the kernel's ``kGeneralSlots`` mirrors),
  slot j of group g in chunk c being angle c * 20K + g * K + j, lane l
  walking samples i = l (mod 8); the block's form, ``fmaxf`` where the tile
  is finite and every |cos|, |sin| <= 1, else the abs-max on the bits as
  unsigned int; the xor-shuffle combine on the bits, the leaders' maxima
  by angle and one atomicMax per angle.

The emulated table is held bit for bit against the plain twin and the JAX
package's Pallas kernel (interpret mode).  On the CPU, XLA contracts the
Pallas kernel's ``ca * b0 + sa * b1`` into a fused multiply-add, so its
table can differ from the unfused twin's by one unit in the last place;
inputs whose products are exact (powers of two) take that rounding out and
are compared bit for bit, the others within one unit.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from phaserotate_tpu.core.angles import all_angle_cos_sin as j_cos_sin
from phaserotate_tpu.kernels import rotate_peak_sweep_kernel as j_sweep
from phaserotate_tpu_torch.core.angles import all_angle_cos_sin
from phaserotate_tpu_torch.kernels import rotate_peak as rp

SRC = Path(rp.__file__).resolve().parent.parent / "csrc" / "rotate_peak.cu"
F32 = np.float32
ANGLES, GROUPS, LANES, UNITS = (rp.SWEEP_ANGLES, rp.SWEEP_GROUPS,
                                rp.SWEEP_LANES, rp.SWEEP_UNITS)
WARP = 32
SIGN = np.uint32(0x80000000)


def unit_angles(u):
    """The two angles of unit u."""
    return (u, ANGLES - u) if u else (0, ANGLES // 2)


def general_form(g, j):
    """Warp 0 runs its first unit with the second angle's own cos/sin."""
    return g < WARP // LANES and j == 0


def slots():
    """(group, slot, unit) of every unit a thread of the block holds."""
    return [(g, j, g * UNITS + j) for g in range(GROUPS) for j in range(UNITS)]


def bits(a):
    return np.ascontiguousarray(a, F32).view(np.uint32)


def table_ok(cs):
    """The block's check of the table, on the bits."""
    cs = np.asarray(cs, F32)
    if cs.shape != (2, ANGLES):
        return False
    cb = bits(cs)
    u = np.arange(1, ANGLES // 2)
    mirror = ((cb[0, ANGLES - u] == (cb[0, u] ^ SIGN)).all()
              and (cb[1, ANGLES - u] == cb[1, u]).all())
    return bool(mirror and (np.abs(cs) <= 1).all())


def pair_tile(x, h, cs):
    """The pair units and the combine over one staged tile: (A,) uint32
    maxima, one per angle, as the group leaders write them to shared
    memory."""
    units = [unit_angles(u) for _, _, u in slots()]
    a = np.array([p[0] for p in units])
    b = np.array([p[1] for p in units])
    gen = np.array([general_form(g, j) for g, j, _ in slots()])[:, None, None]
    ca, sa = cs[0][a][:, None, None], cs[1][a][:, None, None]
    cb, sb = cs[0][b][:, None, None], cs[1][b][:, None, None]
    pad = -len(x) % LANES  # a lane with fewer samples: |0| adds nothing
    xl = np.pad(x, (0, pad)).reshape(-1, LANES)[None]  # [k, lane] = x[l + 8k]
    hl = np.pad(h, (0, pad)).reshape(-1, LANES)[None]
    p, q = ca * xl, sa * hl
    y1 = p + q
    y2 = np.where(gen, cb * xl + sb * hl, q - p)
    zero = F32(0)
    m1 = np.fmax.reduce(np.abs(y1), axis=1, initial=zero)  # (unit, lane)
    m2 = np.fmax.reduce(np.abs(y2), axis=1, initial=zero)
    lane = np.arange(LANES)
    d = LANES // 2
    while d:  # __shfl_xor_sync over the group's 8 lanes
        m1 = np.fmax(m1, m1[:, lane ^ d])
        m2 = np.fmax(m2, m2[:, lane ^ d])
        d //= 2
    assert (m1 == m1[:, :1]).all() and (m2 == m2[:, :1]).all()
    out = np.zeros(ANGLES, np.uint32)
    out[a] = bits(m1[:, 0])
    out[b] = bits(m2[:, 0])
    return out


def general_map(a_count):
    """(chunk, group, slot, angle) of every slot the general map runs on an
    ``a_count``-angle table; an angle >= a_count is a padded slot."""
    k = rp.general_slots(a_count)
    per_chunk = GROUPS * k
    return [(c, g, j, c * per_chunk + g * k + j)
            for c in range(-(-a_count // per_chunk))
            for g in range(GROUPS) for j in range(k)]


def fmax_form(x, h, cs):
    """The block's form of the general map: fmaxf where every staged
    sample is finite and every |cos|, |sin| <= 1 (no |y| is NaN), else the
    abs-max on the bits."""
    return bool(np.isfinite(x).all() and np.isfinite(h).all()
                and (np.abs(cs) <= 1).all())


def general_tile(x, h, cs):
    """The general map over one staged tile: (A,) uint32 maxima, one per
    angle, as the group leaders write them to shared memory."""
    a_count = cs.shape[1]
    slots = general_map(a_count)
    ang = np.array([a for *_, a in slots])
    inside = ang < a_count
    at = np.minimum(ang, a_count - 1)
    c = np.where(inside, cs[0][at], F32(0)).astype(F32)  # (0, 0) past
    s = np.where(inside, cs[1][at], F32(0)).astype(F32)  # the table
    fin = fmax_form(x, h, cs)
    m = np.zeros((len(slots), LANES), np.uint32)
    with np.errstate(invalid="ignore", over="ignore"):  # -0 * inf: NaN
        for lane in range(LANES):  # samples i = lane (mod 8)
            y = (c[:, None] * x[None, lane::LANES]
                 + s[:, None] * h[None, lane::LANES])
            if fin:
                m[:, lane] = bits(np.fmax.reduce(np.abs(y), axis=1,
                                                 initial=F32(0)))
            else:
                m[:, lane] = bits(np.abs(y)).max(axis=1,
                                                 initial=np.uint32(0))
    lane = np.arange(LANES)
    d = LANES // 2
    while d:  # __shfl_xor_sync over the group's 8 lanes, on the bits
        m = np.maximum(m, m[:, lane ^ d])
        d //= 2
    assert (m == m[:, :1]).all()
    peak = np.zeros(a_count, np.uint32)
    written = np.zeros(a_count, int)
    for a, v in zip(ang[inside], m[inside, 0]):  # lane 0 of each group
        peak[a] = v
        written[a] += 1
    assert (written == 1).all()
    return peak


def emulate(b0, b1, cs, tile_len):
    """The kernel's table for (rows, n) inputs; also the number of tiles
    that took the pair units and the general loop."""
    b0, b1, cs = (np.asarray(v, F32) for v in (b0, b1, cs))
    rows, n = b0.shape
    out = np.zeros((rows, cs.shape[1]), np.uint32)
    paths = {"pairs": 0, "general": 0}
    ok_table = table_ok(cs)
    for r in range(rows):
        for start in range(0, n, tile_len):
            end = start + tile_len
            x, h = b0[r, start:end], b1[r, start:end]
            if ok_table and np.isfinite(x).all() and np.isfinite(h).all():
                tile_max = pair_tile(x, h, cs)
                paths["pairs"] += 1
            else:
                tile_max = general_tile(x, h, cs)
                paths["general"] += 1
            out[r] = np.maximum(out[r], tile_max)  # atomicMax on the bits
    return out.view(F32), paths


def plain(b0, b1, cs):
    return rp.rotate_peak_sweep_plain(
        torch.from_numpy(np.asarray(b0, F32)),
        torch.from_numpy(np.asarray(b1, F32)),
        torch.from_numpy(np.asarray(cs, F32))).numpy()


def music_pair(rng, rows, n):
    """Normal samples at scales 1e-3 .. 300, shuffled over the row, with
    +0 and -0 in both signals."""
    scale = np.logspace(-3, np.log10(300), n)
    b0 = rng.standard_normal((rows, n)) * rng.permutation(scale)
    b1 = rng.standard_normal((rows, n)) * rng.permutation(scale)
    b0, b1 = b0.astype(F32), b1.astype(F32)
    b0[:, 7], b0[:, 8], b1[:, 8], b1[:, 9] = 0.0, -0.0, -0.0, 0.0
    b0[:, 10] = b1[:, 10] = -0.0
    return b0, b1


def pow2_pair(rng, rows, n):
    """+-2^k for k = -10..8 (about 1e-3 .. 256) and +-0: every product
    with a table entry is exact, so fused and unfused rounding agree."""
    def one():
        v = np.ldexp(F32(1), rng.integers(-10, 9, (rows, n)))
        v = v * rng.choice(np.array([-1, 1], F32), (rows, n))
        v[rng.random((rows, n)) < 0.02] = 0.0
        v[rng.random((rows, n)) < 0.02] = -0.0
        return v.astype(F32)
    return one(), one()


N = 5003  # odd: the last tile and the lanes are ragged


def test_cu_mirrors_the_map():
    consts = dict(re.findall(r"constexpr int (kSweep\w+) = (\d+);",
                             SRC.read_text()))
    assert {k: int(v) for k, v in consts.items() if k != "kSweepThreads"} == {
        "kSweepAngles": ANGLES, "kSweepGroups": GROUPS,
        "kSweepLanes": LANES, "kSweepUnits": UNITS}
    assert "kSweepThreads = kSweepGroups * kSweepLanes" in SRC.read_text()
    assert WARP % LANES == 0 and (GROUPS * LANES) % WARP == 0


def test_map_covers_each_angle_once():
    angles = [a for _, _, u in slots() for a in unit_angles(u)]
    assert sorted(angles) == list(range(ANGLES))  # no angle twice or missed
    padded = 2 * GROUPS * UNITS - ANGLES
    assert padded == 0 and padded / ANGLES <= 0.01
    gen = [(g, j) for g, j, _ in slots() if general_form(g, j)]
    assert gen == [(0, 0), (1, 0), (2, 0), (3, 0)]  # all of warp 0, unit 0
    assert unit_angles(0) == (0, ANGLES // 2)
    # every group lies in one warp, so the xor shuffle stays in the group
    assert all((g * LANES) // WARP == (g * LANES + LANES - 1) // WARP
               for g in range(GROUPS))


def test_instruction_model():
    """FP32 instructions per sample: a pair unit is 2 FMUL + 2 FADD + 2
    FMNMX, the general form 4 + 2 + 2.  Useful work counts unit 0 alone in
    the general form (1,082, 3.006 per sample-angle); the block issues
    warp 0's three other general-form units too (1,088).  One LDS.64 per
    group feeds a thread's 9 units."""
    cost = {False: 6, True: 8}
    useful = sum(cost[u == 0] for _, _, u in slots())
    issued = sum(cost[general_form(g, j)] for g, j, _ in slots())
    assert useful == 179 * 6 + 8 == 1082
    assert issued == 1088 and (issued - useful) / issued < 0.01
    assert round(useful / ANGLES, 3) == 3.006  # one angle at a time: 4
    per_lds = sum(cost[general_form(WARP // LANES, j)] for j in range(UNITS))
    assert per_lds == 54 and GROUPS == 20  # 20 LDS.64 per sample


@pytest.mark.parametrize("table, ops", [
    ("canonical", 179 * 6 + 8),
    ("slice", 59 * 6 + 8),      # pairs 121..179 / 181..239; 120, 180 alone
    ("random", 4 * 37),
])
def test_smoke_bound_counts_mirror_pairs(table, ops):
    """chip_smoke.py's sweep bound counts the operations the function needs
    on the table passed: the canonical table's 1,082 per sample (as the
    model above), 6 per mirror pair of a slice, 4 per other angle."""
    path = SRC.parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cs = all_angle_cos_sin(device="cpu")
    cs = {"canonical": cs, "slice": cs[:, 120:240],
          "random": torch.from_numpy(np.random.default_rng(7).uniform(
              -1, 1, (2, 37)).astype(F32))}[table]
    assert smoke.sweep_flops_per_sample(cs) == ops


@pytest.mark.parametrize("tile_len", [4096, 1024, 100])
@pytest.mark.parametrize("rows", [1, 3])
def test_emulation_bit_equal_to_plain(rows, tile_len):
    rng = np.random.default_rng(100 * rows + tile_len)
    b0, b1 = music_pair(rng, rows, N)
    cs = all_angle_cos_sin().numpy()
    got, paths = emulate(b0, b1, cs, tile_len)
    assert paths["general"] == 0
    assert paths["pairs"] == rows * -(-N // tile_len)
    np.testing.assert_array_equal(bits(got), bits(plain(b0, b1, cs)))


@pytest.mark.parametrize("rows", [1, 3])
def test_emulation_against_jax_kernel(rows):
    rng = np.random.default_rng(7 + rows)
    cs = all_angle_cos_sin().numpy()
    b0, b1 = pow2_pair(rng, rows, N)
    got, _ = emulate(b0, b1, cs, 1024)
    want = np.asarray(j_sweep(b0, b1, j_cos_sin(), tile_len=2048))
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(bits(got), bits(plain(b0, b1, cs)))
    b0, b1 = music_pair(rng, rows, N)
    got, _ = emulate(b0, b1, cs, 1024)
    want = np.asarray(j_sweep(b0, b1, j_cos_sin(), tile_len=2048))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def _flipped(angle, row, bit):
    cs = all_angle_cos_sin().numpy().copy()
    cs.view(np.uint32)[row, angle] ^= np.uint32(1 << bit)
    return cs


# (name, table, accepted by the check)
TABLES = [
    ("canonical", lambda: all_angle_cos_sin().numpy(), True),
    ("slice A=120", lambda: all_angle_cos_sin().numpy()[:, 120:240], False),
    ("A=359", lambda: all_angle_cos_sin().numpy()[:, :359], False),
    ("cos[5] last bit", lambda: _flipped(5, 0, 0), False),
    ("sin[300] last bit", lambda: _flipped(300, 1, 0), False),
    ("cos[0] last bit: |cos| > 1", lambda: _flipped(0, 0, 0), False),
    ("cos[180] exponent: |cos| > 1", lambda: _flipped(180, 0, 30), False),
    # angles 0 and 180 have no mirror: any bounded value keeps the pairs
    ("sin[0] last bit", lambda: _flipped(0, 1, 0), True),
]


@pytest.mark.parametrize("name,make,accepted", TABLES,
                         ids=[t[0] for t in TABLES])
def test_mirror_check(name, make, accepted):
    cs = np.ascontiguousarray(make())
    assert table_ok(cs) is accepted
    rng = np.random.default_rng(len(name))
    b0, b1 = music_pair(rng, 2, 1500)
    got, paths = emulate(b0, b1, cs, 512)
    assert paths["general" if not accepted else "pairs"] == 2 * 3
    np.testing.assert_array_equal(bits(got), bits(plain(b0, b1, cs)))


def test_random_table_takes_the_general_loop():
    rng = np.random.default_rng(3)
    cs = rng.uniform(-2, 2, (2, ANGLES)).astype(F32)
    assert not table_ok(cs)
    b0, b1 = music_pair(rng, 2, 1500)
    got, paths = emulate(b0, b1, cs, 512)
    assert paths == {"pairs": 0, "general": 6}
    np.testing.assert_array_equal(bits(got), bits(plain(b0, b1, cs)))


def _non_finite(rng, n):
    """Row 0: a NaN in b0; row 1: +inf in b1; row 2: +inf / -inf in one
    pair; row 3: finite."""
    b0, b1 = music_pair(rng, 4, n)
    b0[0, 1234] = np.nan
    b1[1, 2345] = np.inf
    b0[2, 3456], b1[2, 3456] = np.inf, -np.inf
    return b0, b1


def test_non_finite_plain_equals_jax_kernel():
    """The semantics the card must meet: NaN propagates to the row's
    angles, and sin[0] = -0 times an inf gives NaN at angle 0."""
    b0, b1 = _non_finite(np.random.default_rng(5), N)
    cs = all_angle_cos_sin().numpy()
    want = plain(b0, b1, cs)
    got = np.asarray(j_sweep(b0[:3], b1[:3], j_cos_sin(), tile_len=2048))
    np.testing.assert_array_equal(got, want[:3])  # NaN equal to NaN
    assert np.isnan(want[0]).all()
    assert np.isnan(want[1, 0]) and np.isposinf(want[1, 1:]).all()
    assert not np.isfinite(want[2]).any() and np.isnan(want[2]).any()
    assert np.isfinite(want[3]).all()


@pytest.mark.parametrize("tile_len", [4096, 1024, 100])
def test_non_finite_emulation(tile_len):
    b0, b1 = _non_finite(np.random.default_rng(6), N)
    cs = all_angle_cos_sin().numpy()
    got, paths = emulate(b0, b1, cs, tile_len)
    assert paths["general"] == 3  # the three tiles with a NaN or an inf
    np.testing.assert_array_equal(got, plain(b0, b1, cs))
    for table in (cs[:, 120:240], _flipped(5, 0, 0)):
        got, _ = emulate(b0, b1, table, tile_len)
        np.testing.assert_array_equal(got, plain(b0, b1, table))


# ---- the general map ----

def test_cu_mirrors_the_general_map():
    text = SRC.read_text()
    slots = re.search(r"constexpr int kGeneralSlots = (\d+);", text)
    assert int(slots.group(1)) == rp.GENERAL_SLOTS
    # the host's choice of K, as general_slots makes it
    assert ("const int per_group = (a_count + kSweepGroups - 1) / "
            "kSweepGroups;") in text
    assert ("const int k = per_group < kGeneralSlots ? per_group : "
            "kGeneralSlots;") in text
    # slot j of group g in chunk c: angle c * 20K + g * K + j
    assert ("for (int base = 0; base < a_count; base += kSweepGroups * K)"
            in text)
    assert "const int a0 = base + g * K;" in text
    assert "const bool in = a0 + j < a_count;" in text
    # an instantiation for every K, and the canonical table takes the one
    # that carries the pair units
    ks = {int(k) for k in re.findall(r"sweep_kernel<(\d+)>", text)}
    assert ks == set(range(1, rp.GENERAL_SLOTS + 1))
    assert "if constexpr (K == kGeneralSlots)" in text
    assert rp.general_slots(ANGLES) == rp.GENERAL_SLOTS


@pytest.mark.parametrize("k", range(1, rp.GENERAL_SLOTS + 1))
def test_general_map_covers_each_angle_once(k):
    """Every A in 1..512 whose K is k: each angle in exactly one (chunk,
    group, slot); every group full where A allows (fewer than one padded
    slot per group in a table of one chunk)."""
    tables = [a for a in range(1, rp._MAX_ANGLES + 1)
              if rp.general_slots(a) == k]
    assert tables
    for a_count in tables:
        slots = general_map(a_count)
        angles = sorted(a for *_, a in slots if a < a_count)
        assert angles == list(range(a_count))
        assert len({(c, g, j) for c, g, j, _ in slots}) == len(slots)
        chunks = -(-a_count // (GROUPS * k))
        assert len(slots) == chunks * GROUPS * k
        if k < rp.GENERAL_SLOTS:
            assert chunks == 1 and len(slots) - a_count < GROUPS
    if k < rp.GENERAL_SLOTS:  # every K below 9 has its full table
        assert GROUPS * k in tables
    else:
        assert tables[0] == GROUPS * (k - 1) + 1 and tables[-1] == 512


FINITE_OPS = 4  # 2 FMUL, FADD, FMNMX with the |.| operand modifier
BITS_OPS = 5    # 2 FMUL, FADD, the |.| and an integer max on the bits


def issued_per_sample_angle(a_count, ops):
    """FP32 and LDS instructions per useful sample-angle, thread slots
    counted as a warp issues them: per chunk, every warp with a group
    inside the table runs its loop, one LDS.64 and ``ops`` per slot for
    each sample of its lanes."""
    k = rp.general_slots(a_count)
    groups_per_warp = WARP // LANES
    issued = 0
    for chunk in range(-(-a_count // (GROUPS * k))):
        warps = {g // groups_per_warp for c, g, _, a in
                 general_map(a_count) if c == chunk and a < a_count}
        issued += len(warps) * WARP * (1 + ops * k) / LANES
    return issued / a_count


@pytest.mark.parametrize("a_count, finite, bits_form", [
    (20, 5.0, 6.0),                  # K = 1
    (60, 4 + 1 / 3, 5 + 1 / 3),      # K = 3
    (120, 4 + 1 / 6, 5 + 1 / 6),     # K = 6, a 3-way slice
    (90, 14 / 3, 52 / 9),            # K = 5 over 18 groups: warp 4 issues
    (180, 4 + 1 / 9, 5 + 1 / 9),     # K = 9, one chunk
    (360, 4 + 1 / 9, 5 + 1 / 9),     # two chunks: the canonical bit form
    (512, 4.3359375, 5.390625),      # three chunks, 28 padded slots
])
def test_general_instruction_model(a_count, finite, bits_form):
    """4 + 1/K instructions per sample-angle in the fmaxf form and 5 + 1/K
    in the bit form where every group is full, against ~6 of one thread
    per angle walking the tile alone (a broadcast LDS.64, 2 FMUL, FADD, a
    LOP and an IMNMX; 6.4 at A = 120, whose 120 threads fill 4 warps)."""
    assert issued_per_sample_angle(a_count, FINITE_OPS) == pytest.approx(
        finite, rel=1e-12)
    assert issued_per_sample_angle(a_count, BITS_OPS) == pytest.approx(
        bits_form, rel=1e-12)
    if a_count == 120:
        one_angle_loop = 4 * WARP * 6 / a_count  # 4 warps, 6 per sample
        assert one_angle_loop == 6.4
        assert finite / one_angle_loop == pytest.approx(0.651, abs=1e-3)


def _shuffled_360():
    cs = all_angle_cos_sin().numpy()
    return cs[:, np.random.default_rng(360).permutation(ANGLES)]


# (name, table); all take the general map
GENERAL_TABLES = [
    ("A=1", lambda: all_angle_cos_sin().numpy()[:, 37:38]),
    ("A=7", lambda: all_angle_cos_sin().numpy()[:, 100:107]),
    ("A=90 4-way slice 0", lambda: all_angle_cos_sin().numpy()[:, :90]),
    *[(f"A=120 3-way slice {i}",
       lambda i=i: all_angle_cos_sin().numpy()[:, 120 * i : 120 * (i + 1)])
      for i in range(3)],
    ("A=180", lambda: all_angle_cos_sin().numpy()[:, 180:]),
    ("A=250", lambda: all_angle_cos_sin().numpy()[:, 50:300]),
    ("A=360 shuffled", _shuffled_360),
    ("A=512 random", lambda: np.random.default_rng(512).uniform(
        -1, 1, (2, 512)).astype(F32)),
]


@pytest.mark.parametrize("name,make", GENERAL_TABLES,
                         ids=[t[0] for t in GENERAL_TABLES])
def test_general_emulation_against_plain_and_jax(name, make):
    """Bit-equal to the plain twin; to the JAX kernel (interpret mode) bit
    for bit on power-of-two samples and within one ulp on the others."""
    cs = np.ascontiguousarray(make(), F32)
    assert not table_ok(cs)
    rng = np.random.default_rng(cs.shape[1])
    b0, b1 = pow2_pair(rng, 2, N)
    got, paths = emulate(b0, b1, cs, 1024)
    assert paths == {"pairs": 0, "general": 2 * -(-N // 1024)}
    np.testing.assert_array_equal(bits(got), bits(plain(b0, b1, cs)))
    want = np.asarray(j_sweep(b0, b1, cs, tile_len=2048))
    np.testing.assert_array_equal(bits(got), bits(want))
    b0, b1 = music_pair(rng, 2, N)
    got, _ = emulate(b0, b1, cs, 1024)
    np.testing.assert_array_equal(bits(got), bits(plain(b0, b1, cs)))
    want = np.asarray(j_sweep(b0, b1, cs, tile_len=2048))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


# (name, table, the fmaxf form on a finite tile)
NON_FINITE_TABLES = [
    ("canonical", lambda: all_angle_cos_sin().numpy(), True),
    ("A=90", lambda: all_angle_cos_sin().numpy()[:, :90], True),
    ("A=120 middle", lambda: all_angle_cos_sin().numpy()[:, 120:240], True),
    ("A=250 |c| up to 2", lambda: np.random.default_rng(250).uniform(
        -2, 2, (2, 250)).astype(F32), False),
]


@pytest.mark.parametrize("tile_len", [2048, 4096])
@pytest.mark.parametrize("name,make,fmax_on_finite", NON_FINITE_TABLES,
                         ids=[t[0] for t in NON_FINITE_TABLES])
def test_general_non_finite_tiles(name, make, fmax_on_finite, tile_len):
    """A NaN, a +inf, a -inf: the tiles that hold them take the bit form
    (the canonical table its two chunks at K = 9) and the table equals the
    plain twin's, NaN equal to NaN; the other tiles take fmaxf where the
    table is bounded."""
    cs = np.ascontiguousarray(make(), F32)
    b0, b1 = _non_finite(np.random.default_rng(tile_len), N)
    forms = [fmax_form(b0[r, t : t + tile_len], b1[r, t : t + tile_len], cs)
             for r in range(4) for t in range(0, N, tile_len)]
    tiles = -(-N // tile_len)
    assert forms.count(False) == (3 if fmax_on_finite else 4 * tiles)
    got, paths = emulate(b0, b1, cs, tile_len)
    general = 3 if table_ok(cs) else 4 * tiles
    assert paths["general"] == general
    np.testing.assert_array_equal(got, plain(b0, b1, cs))
    if name == "canonical":
        assert len({c for c, *_ in general_map(ANGLES)}) == 2
