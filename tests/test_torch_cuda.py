"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs where JAX is
absent; this repository's tests/conftest.py imports JAX, so run it there
without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import phaserotate_tpu_torch as pr
from phaserotate_tpu_torch import cli
from phaserotate_tpu_torch.core.angles import all_angle_cos_sin
from phaserotate_tpu_torch.core.angles import degrees_to_turns
from phaserotate_tpu_torch.core.sizes import stream_geometry_for_rate
from phaserotate_tpu_torch.kernels import _build
from phaserotate_tpu_torch.kernels import fused_conv as fc
from phaserotate_tpu_torch.kernels import stream_conv as sc
from phaserotate_tpu_torch.io import write_wav
from phaserotate_tpu_torch.kernels.rotate_peak import (
    peak_kernel,
    rotate_peak_sweep_kernel,
    rotate_peak_sweep_plain,
)
from phaserotate_tpu_torch.ops.rotate import hilbert_fir, rotate_fir
from phaserotate_tpu_torch.stream import rotate_streamed
from phaserotate_tpu_torch.stream.engine import (
    _internal_angle_params,
    angle_sequence,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


@pytest.fixture
def x(dev):
    rng = np.random.default_rng(0x5EED)
    return torch.from_numpy(
        rng.standard_normal((3, 20011)).astype(np.float32)).to(dev)


def _equal_nan(a, b):
    return bool(torch.isclose(a, b, rtol=0, atol=0, equal_nan=True).all())


def test_sweep_bit_equal(x):
    """The canonical table (mirror-pair units), an angle slice and a
    random 360-angle table (the kernel's general map), on unaligned
    views; then NaN and inf samples, equal with NaN equal to NaN."""
    cs = all_angle_cos_sin(x.device)
    rng = np.random.default_rng(12)
    tables = (cs, cs[:, 120:240], torch.from_numpy(
        rng.uniform(-1, 1, (2, 360)).astype(np.float32)).to(x.device))
    for table in tables:
        for tile in (4096, 1024, 100):
            got = rotate_peak_sweep_kernel(x[:, 50:], x[:, :-50], table, tile)
            assert torch.equal(got, rotate_peak_sweep_plain(
                x[:, 50:], x[:, :-50], table))
    b0, b1 = x[:, 50:].clone(), x[:, :-50].clone()
    b0[0, 777] = float("nan")                              # NaN in b0
    b1[1, 5000] = float("inf")                             # +inf in b1
    b0[2, 9000], b1[2, 9000] = float("inf"), float("-inf")  # one pair
    for table in tables:
        for tile in (4096, 1024, 100):
            got = rotate_peak_sweep_kernel(b0, b1, table, tile)
            want = rotate_peak_sweep_plain(b0, b1, table)
            assert _equal_nan(got, want)
    got = rotate_peak_sweep_kernel(b0, b1, cs)
    assert torch.isnan(got[0]).all() and torch.isnan(got[1, 0])
    assert torch.isposinf(got[1, 1:]).all() and not got[2].isfinite().any()


@pytest.mark.parametrize("a_count", [1, 7, 20, 21, 90, 120, 160, 161,
                                     180, 181, 250, 359, 512])
def test_sweep_general_map(x, a_count):
    """Every K of the general map and one, two and three chunks: random
    tables within [-1, 1] (the fmaxf form) and within [-2, 2] (the bit
    form), at three tile lengths; then NaN and inf samples."""
    rng = np.random.default_rng(a_count)
    b0, b1 = x[:, 50:].clone(), x[:, :-50].clone()
    for scale in (1.0, 2.0):
        table = torch.from_numpy(rng.uniform(
            -scale, scale, (2, a_count)).astype(np.float32)).to(x.device)
        for tile in (4096, 2048, 100):
            got = rotate_peak_sweep_kernel(b0, b1, table, tile)
            assert torch.equal(got, rotate_peak_sweep_plain(b0, b1, table))
    b0[0, 777] = float("nan")
    b1[1, 5000] = float("inf")
    b0[2, 9000], b1[2, 9000] = float("inf"), float("-inf")
    for tile in (4096, 2048):
        got = rotate_peak_sweep_kernel(b0, b1, table, tile)
        assert _equal_nan(got, rotate_peak_sweep_plain(b0, b1, table))
    assert torch.isnan(got[0]).all()


@pytest.mark.parametrize("taps", [512, 1024, 3072, 8192, 16384])
def test_hilbert_small(x, taps):
    got = sc.hilbert_small(x, taps)
    want = sc.hilbert_small_plain(x, taps)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() < 1e-5


@pytest.mark.parametrize("firlen", [3072, 4096, 8192])
def test_rotate_small(x, firlen):
    turns = degrees_to_turns([0.0, 35.0, -120.0], device=x.device)
    got = sc.rotate_small(x, turns, firlen)
    assert (got - sc.rotate_small_plain(x, turns, firlen)).abs().max() < 2e-5
    assert torch.equal(got[0], x[0])  # cos 0 = 1, sin 0 = 0 exactly


@pytest.mark.parametrize("taps", [512, 3072, 8192, 16384])
@pytest.mark.parametrize("n", [0, 1, 255, 257, 5003])
def test_stream_conv_short_and_odd(dev, taps, n):
    """ns = 2, 12, 32, 64 at n = 0, n < 256 and odd n (rows start at odd
    elements, read in place); rotate_small writes (rows, n)."""
    rng = np.random.default_rng(taps + n)
    x = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32)).to(
        dev)
    got = sc.hilbert_small(x, taps)
    want = sc.hilbert_small_plain(x, taps)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() < 1e-5
    turns = degrees_to_turns([0.0, 35.0, -120.0], device=dev)
    got = sc.rotate_small(x, turns, taps)
    assert got.shape == x.shape
    if n:
        want = sc.rotate_small_plain(x, turns, taps)
        assert (got - want).abs().max().item() < 2e-5
        assert torch.equal(got[0], x[0])


@pytest.mark.parametrize("taps", [512, 3072, 16384])
def test_stream_conv_any_grid_same_bits(dev, taps):
    """Runs that cross row boundaries, a run per frame and one run for
    everything give the same bits as the card's resident grid."""
    rng = np.random.default_rng(taps)
    n = 3001
    x = torch.from_numpy(rng.standard_normal((5, n)).astype(np.float32)).to(
        dev)
    turns = torch.from_numpy(rng.uniform(-0.5, 0.5, 5).astype(
        np.float32)).to(dev)
    h = sc.hilbert_small(x, taps)
    y = sc.rotate_small(x, turns, taps)
    n_out = h.shape[-1] // sc.P
    angs = torch.stack([turns, torch.zeros_like(turns)], dim=-1)
    y_out = -(-n // sc.P)
    for grid in (1, 2, 3, 7, 5 * y_out, 5 * n_out - 1):
        out = torch.empty_like(h)
        sc._launch(x, taps, n_out, out, n_out * sc.P, grid=grid)
        assert torch.equal(out, h), grid
        out = torch.empty_like(y)
        sc._launch(x, taps, y_out, out, n, d_out=taps // 2 // sc.P,
                   angs=angs, ang_fs=0, grid=min(grid, 5 * y_out))
        assert torch.equal(out, y), grid


def test_stream_conv_reads_views_in_place(x):
    """A strided, unaligned view gives the bits of its contiguous copy."""
    view = x[:, 7:-6]
    assert not view.is_contiguous()
    assert torch.equal(sc.hilbert_small(view, 3072),
                       sc.hilbert_small(view.contiguous(), 3072))
    turns = degrees_to_turns([10.0, 35.0, -120.0], device=x.device)
    assert torch.equal(sc.rotate_small(view, turns, 3072),
                       sc.rotate_small(view.contiguous(), turns, 3072))
    frames = x[:, : 78 * sc.P].reshape(3, 78, sc.P)
    params = torch.zeros(3, 78, 2, device=x.device)
    params[..., 0] = 0.1
    assert torch.equal(sc.fused_stream_mix(frames[:, 5:70], params[:, 5:70],
                                           3072),
                       sc.fused_stream_mix(frames[:, 5:70].contiguous(),
                                           params[:, 5:70], 3072))


def test_stream_conv_nan_input(x):
    """A NaN reaches the frames its partitions reach and no other row."""
    xn = x.clone()
    xn[1, 4321] = float("nan")
    for taps in (512, 8192):
        got = sc.hilbert_small(xn, taps)
        want = sc.hilbert_small_plain(xn, taps)
        assert torch.equal(got.isnan(), want.isnan())
        assert got.isnan().any() and not got[[0, 2]].isnan().any()
        ok = ~want.isnan()
        assert (got[ok] - want[ok]).abs().max().item() < 1e-5
    turns = degrees_to_turns([10.0, 35.0, -120.0], device=x.device)
    got = sc.rotate_small(xn, turns, 3072)
    want = sc.rotate_small_plain(xn, turns, 3072)
    assert torch.equal(got.isnan(), want.isnan())
    assert not got[[0, 2]].isnan().any()


def test_stream_conv_geometry(dev):
    """The persistent grid fills the card."""
    for ns in (2, 12, 32, 64):
        for mix in (False, True):
            geo = sc.kernel_geometry(ns, mix, dev)
            assert geo["blocks"] >= torch.cuda.get_device_properties(
                dev).multi_processor_count, (ns, mix, geo)
            assert geo["threads"] == 544, geo


def test_launches_counted(x):
    _build.reset_launches()
    sc.hilbert_small(x, 1024)
    sc.rotate_small(x, degrees_to_turns(10.0, device=x.device), 3072)
    rotate_peak_sweep_kernel(x, x, all_angle_cos_sin(x.device))
    hilbert_fir(x, 3072)
    fc.fused_rotate_fir(x, degrees_to_turns(10.0, device=x.device), 3072)
    peak_kernel(x[0])
    frames = x[:, : 78 * sc.P].reshape(3, 78, sc.P)
    sc.fused_stream_mix(frames, torch.zeros(3, 78, 2, device=x.device), 3072)
    from phaserotate_tpu_torch.kernels.unpack import wire_unpack
    from phaserotate_tpu_torch.search.packed import pack_residual

    pk = pack_residual(_pcm_tones((2, 9000), 3))
    wire_unpack(*(torch.from_numpy(np.ascontiguousarray(a)).to(x.device)
                  for a in pk.arrays()), pk.n)
    assert _build.launches == {
        "rotate_peak_sweep": 1, "hilbert_small": 1, "rotate_small": 1,
        "stream_mix": 1, "fused_hilbert": 1, "fused_rotate_fir": 1,
        "peak": 1, "pcm24_widen": 0, "hilbert_32k": 0, "wire_unpack": 3}


def test_rows_beyond_65535(dev):
    """Any number of rows in one launch: 65536 + 7 rows."""
    rng = np.random.default_rng(7)
    rows = 65536 + 7
    xs = torch.from_numpy(
        rng.standard_normal((rows, 300)).astype(np.float32)).to(dev)
    got = sc.hilbert_small(xs, 512)
    assert (got - sc.hilbert_small_plain(xs, 512)).abs().max() < 1e-5
    turns = torch.from_numpy(rng.uniform(-0.5, 0.5, rows).astype(
        np.float32)).to(dev)
    got = sc.rotate_small(xs, turns, 512)
    assert (got - sc.rotate_small_plain(xs, turns, 512)).abs().max() < 2e-5
    cs = all_angle_cos_sin(dev)
    assert torch.equal(rotate_peak_sweep_kernel(xs[:, 1:], xs[:, :-1], cs),
                       rotate_peak_sweep_plain(xs[:, 1:], xs[:, :-1], cs))


@pytest.mark.parametrize("parsiz", [2048, 4096, 8192, 16384])
def test_fused_conv_conv_mode(x, parsiz):
    """Against the single-partition OLA on torch.fft, at the JAX suite's
    budgets (tests/test_kernels.py:67, 172)."""
    n_blocks = -(-x.shape[-1] // parsiz) + 1
    frames = torch.nn.functional.pad(
        x, (0, n_blocks * parsiz - x.shape[-1])).reshape(3, n_blocks, parsiz)
    for firlen in {parsiz // 2, parsiz - 1024, parsiz}:
        spec = fc.hilbert_fir_spectrum(firlen, parsiz, x.device)
        got = fc.fused_ola_conv(frames, spec, parsiz)
        want = fc.fused_ola_conv_plain(frames, spec, parsiz)
        assert got.shape == want.shape
        tol = 3e-6 if parsiz <= 4096 else 1e-5
        assert (got - want).abs().max().item() < tol, firlen


@pytest.mark.parametrize("parsiz", [2048, 4096, 8192, 16384])
def test_fused_conv_product_tables_on_card(dev, parsiz):
    """The FIR spectrum and twiddles the kernel's spectrum product reads,
    permuted into its position order on the card, equal the CPU's."""
    spec = fc.hilbert_fir_spectrum(parsiz - 1024, parsiz)
    h, wp = fc._product_tables(spec, parsiz)
    h_dev, wp_dev = fc._product_tables(spec.to(dev), parsiz)
    assert h_dev.device.type == wp_dev.device.type == "cuda"
    assert torch.equal(h_dev.cpu(), h) and torch.equal(wp_dev.cpu(), wp)


@pytest.mark.parametrize("firlen", [1024, 3072, 8192, 16384])
def test_fused_conv_mix_mode(x, firlen):
    assert fc.mix_supported(firlen)
    turns = degrees_to_turns([0.0, 35.0, -120.0], device=x.device)
    got = fc.fused_rotate_fir(x, turns, firlen)
    want = fc.fused_rotate_fir_plain(x, turns, firlen)
    assert got.shape == x.shape
    assert (got - want).abs().max().item() < 2e-5
    assert torch.equal(got[0], x[0])  # cos 0 = 1, sin 0 = 0 exactly


# (rows, n_blocks) against the persistent grid of ``blocks`` blocks: every
# frame a row's first; one row in runs of one frame; one row in runs of
# two or three frames; more rows than blocks, runs crossing rows.  No
# frame count but the first two is a multiple of the grid.
RUN_SHAPES = {
    "n_blocks_1": lambda blocks: (7, 1),
    "one_row_runs_of_one": lambda blocks: (1, 5),
    "one_row": lambda blocks: (1, 2 * blocks + 3),
    "rows_beyond_grid": lambda blocks: (blocks + 5, 3),
}


@pytest.mark.parametrize("case", list(RUN_SHAPES))
@pytest.mark.parametrize("parsiz", [2048, 4096, 8192, 16384])
def test_fused_conv_runs_conv_mode(dev, parsiz, case):
    """The persistent grid's runs, carries and fix-up against the plain
    twin at chip_smoke.py's budgets."""
    geo = fc.kernel_geometry(parsiz, False, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert geo["blocks"] >= sms and geo["local_bytes"] == 0, geo
    rows, n_blocks = RUN_SHAPES[case](geo["blocks"])
    rng = np.random.default_rng(parsiz + rows)
    frames = torch.from_numpy(rng.standard_normal(
        (rows, n_blocks, parsiz)).astype(np.float32)).to(dev)
    spec = fc.hilbert_fir_spectrum(parsiz - 1024, parsiz, dev)
    got = fc.fused_ola_conv(frames, spec, parsiz)
    want = fc.fused_ola_conv_plain(frames, spec, parsiz)
    tol = 3e-6 if parsiz <= 4096 else 1e-5
    assert (got - want).abs().max().item() < tol


@pytest.mark.parametrize("case", list(RUN_SHAPES))
@pytest.mark.parametrize("firlen", [1024, 3072, 8192, 16384])
def test_fused_conv_runs_mix_mode(dev, firlen, case):
    parsiz = fc.fused_parsiz_for(firlen)
    geo = fc.kernel_geometry(parsiz, True, dev)
    assert geo["local_bytes"] == 0, geo
    rows, n_blocks = RUN_SHAPES[case](geo["blocks"])
    n = n_blocks * parsiz - firlen // 2  # n_blocks frames cover n + lat
    rng = np.random.default_rng(firlen + rows)
    x = torch.from_numpy(rng.standard_normal((rows, n)).astype(
        np.float32)).to(dev)
    turns = torch.from_numpy(rng.uniform(-0.5, 0.5, rows).astype(
        np.float32)).to(dev)
    got = fc.fused_rotate_fir(x, turns, firlen)
    want = fc.fused_rotate_fir_plain(x, turns, firlen)
    assert (got - want).abs().max().item() < 2e-5


def test_peak_kernel_bit_equal(dev):
    rng = np.random.default_rng(11)
    big = torch.from_numpy(
        rng.standard_normal(1_000_003).astype(np.float32)).to(dev)
    for n in (1, 3, 100, 65536, 100001, 1_000_003):
        for off in (0, 1, 2, 3):
            v = big[off : off + n]
            assert torch.equal(peak_kernel(v), v.abs().max()), (n, off)
    v = big.clone()
    v[777] = -9.5
    assert peak_kernel(v).item() == 9.5
    v[123457] = float("nan")
    assert torch.isnan(peak_kernel(v))
    assert peak_kernel(big[:0]).item() == 0.0


def test_fused_stream_mix_ramp(dev):
    """The per-sample angle ramp (nonzero slopes) against its plain twin."""
    geom = stream_geometry_for_rate(48000)
    rng = np.random.default_rng(3)
    n_frames = 400
    targets = np.repeat(rng.uniform(-180, 180, n_frames // 50),
                        50).astype(np.float32)
    angles, das, interp, _ = angle_sequence(np.float32(0.0), targets, geom)
    assert interp.any() and (das != 0).any()
    params = torch.from_numpy(
        _internal_angle_params(angles, das, geom)).to(dev)[None]
    frames = torch.from_numpy(rng.standard_normal(
        (1, params.shape[1], sc.P)).astype(np.float32)).to(dev)
    got = sc.fused_stream_mix(frames, params, geom.firlen)
    want = sc.fused_stream_mix_plain(frames, params, geom.firlen)
    assert (got - want).abs().max().item() < 1e-5


def test_hilbert_fir_and_rotate_fir_run_fused_conv(x):
    _build.reset_launches()
    h = hilbert_fir(x, 3072)
    y = rotate_fir(x, 30.0, firlen=2816)  # rows not 8-aligned: no mix
    assert _build.launches["fused_hilbert"] == 2
    xc = x.cpu()
    assert (h.cpu() - hilbert_fir(xc, 3072)).abs().max() < 1e-5
    assert (y.cpu() - rotate_fir(xc, 30.0, firlen=2816)).abs().max() < 1e-5


def test_phase_rotator_on_card(dev):
    """The streaming model on the card: equal to the CPU run, host block
    size independent, and pipelined mode an exact D*parsiz delay (the
    pinned-buffer copies)."""
    from phaserotate_tpu_torch.models import PhaseRotator
    from phaserotate_tpu_torch.stream import StreamingRotator

    rng = np.random.default_rng(5)
    x = (0.5 * rng.standard_normal((2, 40 * 256 + 77))).astype(np.float32)

    def run(rot, block):
        return np.concatenate(
            [rot.process(x[:, i : i + block], 35.0 if i < 5000 else -60.0)
             for i in range(0, x.shape[1], block)], axis=1)

    y = run(PhaseRotator(rate=48000, channels=2, device=dev), 1024)
    np.testing.assert_allclose(
        y, run(PhaseRotator(rate=48000, channels=2), 1024), atol=1e-5)
    np.testing.assert_array_equal(
        run(PhaseRotator(rate=48000, channels=2, device=dev), 333), y)
    piped = StreamingRotator(rate=48000, channels=2, pipeline_depth=3,
                             device=dev)
    d = 3 * 256
    y3 = run(piped, 333)
    np.testing.assert_array_equal(y3[:, d:], y[:, :-d])


def test_entry_points_default_to_the_card(dev):
    """Numpy input and no device argument: the work runs on the card, and
    the kernels' launch counters rise."""
    rng = np.random.default_rng(9)
    x = (0.4 * rng.standard_normal((2, 30000))).astype(np.float32)
    _build.reset_launches()
    assert pr.rotate(x, 35.0, method="fir").device.type == "cuda"
    assert rotate_streamed(x[0], 35.0).device.type == "cuda"
    assert pr.OfflineRotator(method="fir")(x, 20.0).device.type == "cuda"
    res = pr.find_min_peak_angle(x, rate=48000)
    assert pr.AngleAnalyzer().analyze(x).angles_units == res.angles_units
    assert pr.PhaseRotator(rate=48000, channels=2).device.type == "cuda"
    counts = dict(_build.launches)
    assert counts["rotate_small"] == 2 and counts["stream_mix"] == 1
    assert counts["hilbert_small"] == 2 and counts["rotate_peak_sweep"] == 2
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.wav")
        write_wav(src, x, 48000, bits=16, float_format=False)
        assert cli.main([src]) == 0
    assert _build.launches["hilbert_small"] == 3
    # an explicit device moves a CPU tensor to the card
    xc = torch.from_numpy(x)
    assert pr.rotate(xc, 35.0, method="fir",
                     device="cuda").device.type == "cuda"
    assert pr.find_min_peak_angle(xc, device="cuda").angles_units \
        == res.angles_units
    assert _build.launches["rotate_small"] == 3


def _harmonics(n=48000):
    t = np.arange(n) / 48000.0
    return (0.6 * np.sin(2 * np.pi * 997 * t)
            + 0.35 * np.sin(2 * np.pi * 1994 * t + 0.7)
            + 0.15 * np.sin(2 * np.pi * 2991 * t + 1.9)).astype(np.float32)


@pytest.mark.parametrize("blksiz,steps", [(1024, 24), (8192, 24),
                                          (8192, 48)])
def test_refine_angle_on_card_equals_cpu(dev, blksiz, steps):
    """Numpy input goes to the card (the stream_conv launch counter
    rises); the refined peak equals the CPU's within the float32 budget
    of the descent, and is never above the grid start."""
    from phaserotate_tpu_torch.core.sizes import OfflineGeometry
    from phaserotate_tpu_torch.search import (peak_at_angle, refine_angle,
                                              sweep_peaks)

    x = _harmonics()
    geom = OfflineGeometry(blksiz)
    table = sweep_peaks(x[None], geom)[0].cpu().numpy()
    a0 = int(table.argmin())
    _build.reset_launches()
    theta, peak = refine_angle(x, a0, geom, steps=steps)
    assert _build.launches["hilbert_small"] == 1
    _, cpu_peak = refine_angle(x, a0, geom, steps=steps, device="cpu")
    assert _build.launches["hilbert_small"] == 1
    assert np.isfinite(theta) and abs(theta - a0) < 4
    assert peak <= table[a0] + 1e-6
    assert abs(peak - cpu_peak) <= 2e-5
    p = peak_at_angle(x, theta, geom)
    assert p.device.type == "cuda" and p.ndim == 0
    assert abs(float(p) - peak) <= 3e-6
    assert abs(float(p) - float(peak_at_angle(x, theta, geom,
                                              device="cpu"))) <= 3e-6


def test_refine_angle_degenerate_on_card(dev):
    from phaserotate_tpu_torch.core.sizes import OfflineGeometry
    from phaserotate_tpu_torch.search import refine_angle

    for x in (np.zeros(4096, np.float32), np.full(4096, 0.25, np.float32),
              np.eye(1, 4096, 2048, dtype=np.float32)[0]):
        theta, peak = refine_angle(x, 0, OfflineGeometry(1024), steps=16)
        assert np.isfinite(theta) and np.isfinite(peak)
        assert peak <= np.abs(x).max() + 2e-6


@pytest.mark.parametrize("shape", [(2, 50000), (3, 2, 20011)])
def test_sweep_pcm16_bit_equal_on_card(dev, shape):
    from phaserotate_tpu_torch.core.sizes import OfflineGeometry
    from phaserotate_tpu_torch.search import sweep_peaks_aux
    from phaserotate_tpu_torch.search.sweep import sweep_peaks_aux_pcm16

    rng = np.random.default_rng(5)
    x16 = (rng.standard_normal(shape) * 7000).clip(
        -32768, 32767).astype(np.int16)
    geom = OfflineGeometry(8192)
    table, rot0 = sweep_peaks_aux_pcm16(x16, geom)
    assert table.device.type == "cuda"
    floats = x16.astype(np.float32) / 32768.0
    w_table, w_rot0 = sweep_peaks_aux(floats, geom)
    assert torch.equal(table, w_table) and torch.equal(rot0, w_rot0)
    with pytest.raises(TypeError):
        sweep_peaks_aux_pcm16(floats, geom)


def _pcm_tones(shape, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 48000.0
    x = 0.4 * np.sin(2 * np.pi * 300 * t) + 0.02 * rng.standard_normal(shape)
    return np.clip(np.rint(32768 * x), -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("shape", [(3, 2, 50001), (2, 4096), (5, 31)])
def test_unpack_on_card_equals_the_cpu_unpack(dev, shape):
    """The kernel gives the samples of the CPU unpack, whole and on the
    metadata of groups of streams; the packed sweep equals the pcm16 sweep
    bit for bit."""
    from phaserotate_tpu_torch.core.sizes import OfflineGeometry
    from phaserotate_tpu_torch.search import packed
    from phaserotate_tpu_torch.search.sweep import sweep_peaks_aux_pcm16

    x16 = _pcm_tones(shape, 21)
    x16[0, ..., : shape[-1] // 2] = np.random.default_rng(2).integers(
        -32768, 32768, shape[-1] // 2)  # an order-0 stretch at full scale
    pk = packed.pack_residual(x16)
    parts = [np.ascontiguousarray(a)
             for a in (pk.words, pk.widths, pk.woffs, pk.order)]
    want = packed.unpack_residual(*map(torch.from_numpy, parts), pk.n)
    assert np.array_equal(want.numpy().reshape(shape),
                          x16.astype(np.float32) / 32768.0)
    words = torch.from_numpy(parts[0]).to(dev)
    S = parts[1].shape[0]
    for step in (S, 1, 2):
        for a in range(0, S, step):
            got = packed.unpack_residual(
                words, *(torch.from_numpy(m[a : a + step]).to(dev)
                         for m in parts[1:]), pk.n)
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), want[a : a + step])
    geom = OfflineGeometry(1024)
    t_pk, r_pk = packed.sweep_peaks_aux_packed(pk, geom)
    t_16, r_16 = sweep_peaks_aux_pcm16(x16, geom)
    assert t_pk.device.type == "cuda"
    assert torch.equal(t_pk, t_16) and torch.equal(r_pk, r_16)


WIRE_LENGTHS = (1, 31, 4096, 1100 * 4096 - 3)
WIRE_CASES = (["orders"] + [f"len{n}" for n in WIRE_LENGTHS]
              + [f"adversarial{seed}" for seed in range(3)])


def _wire_case(name):
    """(words, widths, woffs, order, n): packer-made wires (orders 0-3,
    one and many blocks a stream, odd lengths, more blocks a stream than
    the carries' scan has threads) and adversarial ones (random words
    under every width 1-32, offsets anywhere in the words: unaligned,
    overlapping, out of order; an order outside 0-3)."""
    from phaserotate_tpu_torch.search import packed

    if name == "orders":
        rng = np.random.default_rng(31)
        n = 3 * packed.BLOCK + 17
        t = np.arange(n)
        streams = np.stack([
            rng.integers(-32768, 32768, n),
            np.clip(np.cumsum(rng.integers(-20, 21, n)), -32768, 32767),
            np.rint(30000 * np.sin(0.002 * t)),
            np.rint(30000 * np.sin(0.02 * t)),
            np.where(t % 2 == 0, -32768, 32767), np.zeros(n)]).astype(np.int16)
        return packed.pack_residual(streams).arrays() + (n,)
    if name.startswith("len"):
        n = int(name[3:])
        return packed.pack_residual(_pcm_tones((2, n), n % 97)).arrays() + (n,)
    seed = int(name[len("adversarial"):])
    r = np.random.default_rng(seed)
    S, nb = 5, 9
    widths = r.integers(1, 33, (S, nb)).astype(np.int32)
    widths.flat[:32] = np.arange(1, 33)
    W = 40 * 128 * 32
    words = r.integers(-2**31, 2**31, W, dtype=np.int64).astype(np.int32)
    woffs = r.integers(0, W - 128 * widths - 1).astype(np.int32)
    if seed == 1:
        woffs -= woffs % 4  # 16-byte aligned blocks: the vector loads
    order = np.array([0, 1, 2, 3, 9], np.int32)
    return words, widths, woffs, order, nb * packed.BLOCK - 1000 * seed


@pytest.mark.parametrize("name", WIRE_CASES)
def test_wire_unpack_bit_equal(dev, name):
    """The kernel against its plain twin on the CPU, bit for bit, in
    three launches; the words at an offset of 4 bytes too (the 4-byte
    loads)."""
    from phaserotate_tpu_torch.kernels.unpack import (wire_unpack,
                                                      wire_unpack_plain)

    *arrays, n = _wire_case(name)
    cpu = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
           for a in arrays]
    want = wire_unpack_plain(*cpu, n)
    card = [a.to(dev) for a in cpu]
    _build.reset_launches()
    got = wire_unpack(*card, n)
    assert _build.launches["wire_unpack"] == 3
    assert torch.equal(got.cpu(), want)
    shifted = torch.zeros(card[0].numel() + 1, dtype=torch.int32,
                          device=dev)
    shifted[1:] = card[0]
    got = wire_unpack(shifted[1:], *card[1:], n)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_fleet_16bit_on_card_equals_the_cpu(dev, tmp_path):
    """A 16-bit catalogue through ``auto`` and ``packed`` on the card: the
    16-bit WAV reader into pinned slots, the unpack kernel (three launches
    a packed batch, none on the CPU), tables and ``rot0`` equal to the CPU
    run's (peaks bit-equal: the same samples), selections equal."""
    from phaserotate_tpu_torch import fleet
    from phaserotate_tpu_torch.utils.profiling import (CountRecord, drain,
                                                       recording)

    paths = []
    for i in range(5):
        p = str(tmp_path / f"w{i}.wav")
        x = _pcm_tones((2, 150000 - 20000 * i), 80 + i) / 32768.0
        write_wav(p, x.astype(np.float32), 48000, bits=16,
                  float_format=False)
        paths.append(p)
    select = fleet.select_min_peak_angles_batch
    for transport in ("auto", "packed"):
        runs = {}
        for where in ("cuda", "cpu"):
            rows = []

            def capture(t, *a, _rows=rows, **kw):
                _rows.extend(zip(np.array(t), np.array(kw["rot0"])))
                return select(t, *a, **kw)

            fleet.select_min_peak_angles_batch = capture
            try:
                _build.reset_launches()
                drain()
                with recording():
                    res = fleet.analyze_paths(paths, batch=3,
                                              transport=transport,
                                              device=where)
                records = drain()
            finally:
                fleet.select_min_peak_angles_batch = select
            kinds = [r.attrs["transport"] for r in records
                     if r.name == "fleet.pack"]
            copied = [r.n for r in records if isinstance(r, CountRecord)
                      and r.name == "fleet.decode_copied"]
            assert copied == [0] * len(kinds)
            assert _build.launches["wire_unpack"] == (
                3 * kinds.count("packed") if where == "cuda" else 0)
            runs[where] = (res, rows, kinds)
        (c_res, c_rows, c_kinds), (p_res, p_rows, p_kinds) = (
            runs["cuda"], runs["cpu"])
        assert c_kinds == p_kinds and "packed" in c_kinds
        for (ct, cr), (pt, pr) in zip(c_rows, p_rows):
            assert np.array_equal(ct[:, 0], pt[:, 0])
            assert np.abs(ct - pt).max() < 2e-5
            assert np.abs(cr - pr).max() < 2e-5
        for p in paths:
            assert c_res[p][0].angles_units == p_res[p][0].angles_units


def test_mesh_of_the_card_four_times_over(dev):
    """Sample and angle sharding over a mesh that names the one card four
    (three) times: the halo copies, the masked first shard, the maximum and
    the angle slices run with the real kernels."""
    from phaserotate_tpu_torch.core.sizes import OfflineGeometry
    from phaserotate_tpu_torch.parallel import (
        angle_sharded_sweep_peaks, batch_rotate, batch_sweep_peaks,
        file_mesh, grid_mesh, sharded_rotate, sharded_sweep_peaks)
    from phaserotate_tpu_torch.search import sweep_peaks_aux

    geom = OfflineGeometry(8192)
    rng = np.random.default_rng(8)
    x = (0.3 * rng.standard_normal((2, 30 * 8192 - 555))).astype(np.float32)
    want, want_r = sweep_peaks_aux(x, geom)
    mesh4 = file_mesh(4, devices=[dev] * 4)
    _build.reset_launches()
    p1, r1 = sharded_sweep_peaks(x[0], geom, mesh4, axis="files")
    assert _build.launches["rotate_peak_sweep"] == 4
    assert p1.device.type == "cuda"
    assert (p1 - want[0]).abs().max().item() < 2e-5
    assert abs(float(r1) - float(want_r[0])) < 2e-5
    p2, r2 = sharded_sweep_peaks(x, geom, grid_mesh(2, 2, devices=[dev] * 4),
                                 axis="samples", file_axis="files")
    assert (p2 - want).abs().max().item() < 2e-5
    assert (r2 - want_r).abs().max().item() < 2e-5
    for n_dev in (3, 8):
        t, r = angle_sharded_sweep_peaks(
            x, geom, file_mesh(n_dev, devices=[dev] * n_dev))
        assert torch.equal(t, want) and torch.equal(r, want_r)
    x8 = np.stack([x, x[::-1]] * 4)  # (8 files, 2, n)
    t8, r8 = batch_sweep_peaks(x8, geom, mesh4)
    w8, wr8 = sweep_peaks_aux(x8, geom)
    assert torch.equal(t8, w8) and torch.equal(r8, wr8)
    degs = np.linspace(-150, 150, 8).astype(np.float32)
    y = batch_rotate(x8[:, 0], degs, mesh4)
    assert y.device.type == "cpu"
    assert (y - rotate_fir(x8[:, 0], degs).cpu()).abs().max() < 1e-5
    ys = sharded_rotate(x[0], 35.0, mesh4, firlen=3072, axis="files")
    assert (ys - rotate_fir(x[0], 35.0, firlen=3072).cpu()).abs().max() < 1e-5
    # without devices: the visible cards, and never more than there are
    n_cards = torch.cuda.device_count()
    assert file_mesh().shape == {"files": n_cards}
    with pytest.raises(ValueError, match="device"):
        file_mesh(n_cards + 1)


def _fleet_counts(records) -> dict:
    """{counter: [n per batch]} of the fleet's counters in ``records``."""
    from phaserotate_tpu_torch.utils.profiling import CountRecord

    out: dict = {}
    for r in records:
        if isinstance(r, CountRecord) and r.name.startswith("fleet."):
            out.setdefault(r.name, []).append(r.n)
    return out


def test_fleet_transports_equal_on_card(dev, tmp_path, monkeypatch):
    """pcm16, packed and auto give the same results on the card, equal to
    the per-file search and to the CPU's; every batch ships its wire from
    a pinned slot of the process's staging ring; the batched apply equals
    the per-file apply."""
    from phaserotate_tpu_torch import fleet
    from phaserotate_tpu_torch.io import read_audio
    from phaserotate_tpu_torch.utils.profiling import drain, recording

    paths = []
    for i in range(5):
        p = str(tmp_path / f"f{i}.wav")
        x = _pcm_tones((2, 100000 + 7000 * i), 30 + i) / 32768.0
        write_wav(p, x.astype(np.float32), 48000, bits=16,
                  float_format=False)
        paths.append(p)
    taken = []
    take = fleet._StagingRing.take
    monkeypatch.setattr(fleet._StagingRing, "take", lambda ring: taken.append(
        (ring, ring.pinned)) or take(ring))
    _build.reset_launches()
    drain()
    with recording():
        base = fleet.analyze_paths(paths, transport="pcm16", batch=2)
        assert _build.launches["rotate_peak_sweep"] == 3
        for transport in ("packed", "auto"):
            res = fleet.analyze_paths(paths, transport=transport, batch=2)
            for p in paths:
                assert res[p][0].angles_units == base[p][0].angles_units
                assert np.array_equal(res[p][0].peak_min,
                                      base[p][0].peak_min)
    counts = _fleet_counts(drain())
    assert len(counts["fleet.wire_bytes"]) == 9
    assert taken == [(fleet._RING, True)] * 9
    cpu = fleet.analyze_paths(paths, transport="pcm16", batch=2,
                              device="cpu")
    for p in paths:
        assert cpu[p][0].angles_units == base[p][0].angles_units
        assert np.array_equal(cpu[p][0].peak_zero, base[p][0].peak_zero)
        assert np.abs(np.subtract(cpu[p][0].peak_min,
                                  base[p][0].peak_min)).max() < 2e-5
    for p in paths:
        audio, rate, _ = read_audio(p)
        assert pr.find_min_peak_angle(audio, rate=rate).angles_units \
            == base[p][0].angles_units
    written = fleet.apply_paths(paths, base, str(tmp_path / "out"), batch=2)
    single = str(tmp_path / "single")
    os.makedirs(single)
    for p in paths:
        one = fleet._apply_one(p, single, base[p][0], 0)
        assert np.abs(read_audio(written[p])[0]
                      - read_audio(one)[0]).max() < 1e-6


@pytest.mark.parametrize("rows,channels,n,offset", [
    (3, 2, 5 * 4096, 0), (2, 1, 1000, 0), (2, 2, 1001, 0), (1, 3, 777, 0),
    (4, 2, 4096, 1), (1, 1, 8, 0)])
def test_pcm24_widen_bit_equal(dev, rows, channels, n, offset):
    """The widen kernel against its plain twin on seeded payloads: the
    word-load kernel (mono and stereo, frames a multiple of 4, aligned)
    and the byte kernel (odd lengths, three channels, a payload one byte
    off alignment), with the 24-bit extremes in every row."""
    from phaserotate_tpu_torch.kernels.pcm24 import (pcm24_widen,
                                                     pcm24_widen_plain)

    rng = np.random.default_rng(rows * 1000 + channels * 100 + n + offset)
    width = n * channels * 3
    flat = rng.integers(0, 256, rows * width + offset, np.uint8)
    rows_of = flat[offset:].reshape(rows, width)
    ext = np.array([0x00, 0x00, 0x80, 0xFF, 0xFF, 0xFF, 0x00, 0x00, 0x00,
                    0xFF, 0xFF, 0x7F], np.uint8)  # -2^23, -1, 0, 2^23 - 1
    rows_of[:, : min(ext.size, width)] = ext[:width]
    shape = (rows, n, channels, 3)
    raw = torch.from_numpy(rows_of.copy()).reshape(shape)
    on_card = torch.from_numpy(flat).to(dev)[offset:].reshape(shape)
    before = _build.launches["pcm24_widen"]
    got = pcm24_widen(on_card)
    torch.cuda.synchronize()
    assert _build.launches["pcm24_widen"] == before + 1
    want = pcm24_widen_plain(raw)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


def test_fleet_24bit_on_card_equals_cpu(dev, tmp_path, monkeypatch):
    """A 24-bit stereo fleet at 96 kHz (two buckets, blksiz 16384) on the
    card: the pcm24 wire from pinned slots of the process's staging ring
    in every batch (plain host memory on the CPU)
    and the widen kernel; the same angles and input peaks as on the CPU,
    and tables within 2e-5 (the card's convolution rounds otherwise than
    the CPU's)."""
    from phaserotate_tpu_torch import fleet
    from phaserotate_tpu_torch.utils.profiling import drain, recording

    rng = np.random.default_rng(96)
    paths = []
    for i, n in enumerate((100000, 110001, 300000)):
        q = rng.integers(-(1 << 21), 1 << 21, (2, n))
        t = np.arange(n) / 96000.0
        q += np.rint(5e6 * np.sin(2 * np.pi * (200 + 90 * i) * t)).astype(
            q.dtype)
        p = str(tmp_path / f"hi{i}.wav")
        write_wav(p, (q / float(1 << 23)).astype(np.float32), 96000,
                  bits=24, float_format=False)
        paths.append(p)
    select = fleet.select_min_peak_angles_batch
    taken = []
    take = fleet._StagingRing.take
    monkeypatch.setattr(fleet._StagingRing, "take", lambda ring: taken.append(
        (ring, ring.pinned)) or take(ring))
    runs = {}
    for where in ("cuda", "cpu"):
        tables, order = [], []
        taken.clear()

        def capture(t, *a, _tables=tables, **kw):
            _tables.extend(np.array(row) for row in t)
            return select(t, *a, **kw)

        monkeypatch.setattr(fleet, "select_min_peak_angles_batch", capture)
        _build.reset_launches()
        drain()
        with recording():
            res = fleet.analyze_paths(
                paths, batch=2, device=where,
                progress=lambda p, r, cached, _order=order: _order.append(p))
        counts = _fleet_counts(drain())
        assert len(counts["fleet.wire_bytes"]) == 2
        assert taken == [(fleet._RING, where == "cuda")] * 2
        if where == "cuda":
            assert _build.launches["pcm24_widen"] == 2
        runs[where] = (res, tables, order)
    (card_res, card_tables, card_order), (cpu_res, cpu_tables, cpu_order) = (
        runs["cuda"], runs["cpu"])
    assert card_order == cpu_order and len(card_tables) == len(paths)
    for card, cpu in zip(card_tables, cpu_tables):
        assert np.array_equal(card[:, 0], cpu[:, 0])
        assert np.abs(card - cpu).max() < 2e-5
    for p in paths:
        g, w = card_res[p][0], cpu_res[p][0]
        assert g.angles_units == w.angles_units
        np.testing.assert_array_equal(g.peak_zero, w.peak_zero)


@pytest.mark.parametrize("bits", [16, 24])
def test_fleet_decode_threads_on_card(dev, tmp_path, monkeypatch, bits):
    """A catalogue of six files of mixed lengths a batch, from pinned
    slots of the process's staging ring: decoded on the host's threads
    (``fleet.decode_workers`` above 1 in every batch) it gives the tables
    and ``rot0`` of one decode thread, bit for bit (``auto``: packed at
    16 bits, pcm24 at 24)."""
    from phaserotate_tpu_torch import fleet
    from phaserotate_tpu_torch.utils.profiling import drain, recording

    paths = []
    for i in range(6):
        p = str(tmp_path / f"f{i}.wav")
        x = _pcm_tones((2, 120000 - 9000 * i), 60 + i) / 32768.0
        write_wav(p, x.astype(np.float32), 48000, bits=bits,
                  float_format=False)
        paths.append(p)
    select = fleet.select_min_peak_angles_batch
    taken = []
    take = fleet._StagingRing.take
    monkeypatch.setattr(fleet._StagingRing, "take", lambda ring: taken.append(
        (ring, ring.pinned)) or take(ring))
    runs = {}
    for rule in ("host", "one"):
        if rule == "one":
            monkeypatch.setattr(fleet, "_decode_workers", lambda files: 1)
        rows, order = [], []

        def capture(t, *a, _rows=rows, **kw):
            _rows.extend(zip(np.array(t), np.array(kw["rot0"])))
            return select(t, *a, **kw)

        monkeypatch.setattr(fleet, "select_min_peak_angles_batch", capture)
        taken.clear()
        drain()
        with recording():
            fleet.analyze_paths(
                paths, batch=6,
                progress=lambda p, r, cached, _order=order: _order.append(p))
        runs[rule] = (dict(zip(order, rows)),
                      _fleet_counts(drain())["fleet.decode_workers"])
        assert taken == [(fleet._RING, True)] * len(runs[rule][1])
    (host, host_workers), (one, one_workers) = runs["host"], runs["one"]
    assert one_workers == [1] * len(one_workers)
    assert host_workers and all(w > 1 for w in host_workers), host_workers
    assert list(host) == list(one) == paths
    for p in paths:
        assert np.array_equal(host[p][0], one[p][0]), p
        assert np.array_equal(host[p][1], one[p][1]), p


def _wired_plugin(options, stereo=True, n=1024):
    from phaserotate_tpu_torch import plugin as pp

    p = pp.PhaseRotatePlugin(pp.PLUGIN_URI_STEREO if stereo
                             else pp.PLUGIN_URI, 48000, options=options)
    ports = dict(control=[], notify=[],
                 angles=[np.zeros(1, np.float32) for _ in range(p.n_chn)],
                 io=[np.zeros(n, np.float32) for _ in range(p.n_chn)])
    p.connect_port(pp.PortIndex.ATOM_CONTROL, ports["control"])
    p.connect_port(pp.PortIndex.ATOM_NOTIFY, ports["notify"])
    for c in range(p.n_chn):
        p.connect_port(3 + 3 * c, ports["angles"][c])
        p.connect_port(4 + 3 * c, ports["io"][c])
        p.connect_port(5 + 3 * c, ports["io"][c])
    p.activate()
    ports["control"].append(pp.UiOn())
    return p, ports


@pytest.mark.parametrize("pipeline", [0, 2])
def test_plugin_on_card_equals_cpu(dev, pipeline):
    """The plugin with its engine on the card (the default, and the
    option's index 0) against the same plugin on the CPU: outputs and
    levels within 1e-5; the meters stay on the host either way."""
    from phaserotate_tpu_torch import plugin as pp

    rng = np.random.default_rng(61)
    blocks = [(0.4 * rng.standard_normal((2, 1024))).astype(np.float32)
              for _ in range(12)]
    runs = []
    for options in ({"device": 0}, {"device": "cpu"}, {}):
        if pipeline:
            options["pipeline"] = pipeline
        p, ports = _wired_plugin(options)
        outs, levels = [], []
        for i, b in enumerate(blocks):
            for c in range(2):
                ports["angles"][c][0] = [0.0, 35.0, -160.0][min(i, 2)] * (c + 1)
                ports["io"][c][:] = b[c]
            p.run(1024)
            outs.append(np.stack([io.copy() for io in ports["io"]]))
            levels += [[getattr(m, f) for f in ("in_cur", "out_cur",
                                                "out_peak", "diff_min")]
                       for m in ports["notify"]
                       if isinstance(m, pp.LevelsMsg)]
            ports["notify"].clear()
        assert isinstance(p._mtr.dly, np.ndarray)  # on the host
        runs.append((p.device.type, np.concatenate(outs, axis=1),
                     np.array(levels)))
    assert [r[0] for r in runs] == ["cuda", "cpu", "cuda"]
    np.testing.assert_allclose(runs[0][1], runs[1][1], atol=1e-5)
    np.testing.assert_allclose(runs[0][2], runs[1][2], atol=1e-5)
    np.testing.assert_array_equal(runs[0][1], runs[2][1])


def test_broker_pinned_delivery_on_card(dev):
    """The broker on the card: its outputs come through pinned host
    buffers (one per dispatch, kept until every slot popped it) and equal
    the CPU broker's within 1e-5, three sessions from three threads."""
    import threading

    from phaserotate_tpu_torch.stream.broker import StreamBroker

    geom = stream_geometry_for_rate(48000)
    rng = np.random.default_rng(62)
    xs = [(0.4 * rng.standard_normal((2, 20 * 256))).astype(np.float32)
          for _ in range(3)]
    results = {}
    for where in ("cuda", "cpu"):
        b = StreamBroker(geom, 2, capacity=4, depth=3, device=where)
        slots = [b.open() for _ in range(3)]
        outs = [[] for _ in range(3)]

        def run(s):
            degs = np.array([20.0 * (s + 1), -30.0], np.float32)
            for j in range(20):
                outs[s].append(b.submit(slots[s],
                                        xs[s][:, j * 256 : (j + 1) * 256],
                                        degs).copy())

        threads = [threading.Thread(target=run, args=(s,)) for s in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        if where == "cuda":
            held = [e for pipe in b._pipes for e in pipe]
            assert held and all(h.is_pinned() for h, _, _ in held)
        results[where] = [np.concatenate(o, axis=1) for o in outs]
    for k, c in zip(results["cuda"], results["cpu"]):
        np.testing.assert_allclose(k, c, atol=1e-5)


def test_daemon_analysis_on_card_runs_the_kernels(dev, tmp_path):
    """A daemon on the card (no device argument): ANALYZE runs the
    Hilbert and sweep kernels and answers the in-process search's angles;
    an empty analysis is answered, as the JAX daemon answers it."""
    import threading

    from phaserotate_tpu_torch import bridge

    sock = str(tmp_path / "e.sock")
    r, w = os.pipe()
    threading.Thread(target=bridge.serve, args=(sock,), daemon=True,
                     kwargs=dict(ready_fd=w, batch_sessions=2)).start()
    assert os.read(r, 1) == b"R"
    rng = np.random.default_rng(63)
    x = (0.4 * rng.standard_normal((2, 96000))).astype(np.float32)
    cl = bridge.BridgeClient(sock, 48000, 2, init=False)
    _build.reset_launches()
    got = cl.analyze(x)
    assert _build.launches["rotate_peak_sweep"] > 0
    assert _build.launches["hilbert_small"] > 0
    want = pr.find_min_peak_angle(x, rate=48000)
    assert [g["angle_deg"] for g in got] == \
        [float(np.float32(a)) for a in want.angles_deg]
    empty = cl.analyze(np.zeros((1, 0), np.float32))
    assert empty[0]["found"] is False
    cl.close()


# (rows, n): one sample; one block; a row shorter than a block beside
# ragged ones; the fleet's batch of 8 stereo songs at 192 kHz, short
HIRES_SHAPES = [(1, 1), (1, 32768), (3, 100003), (16, 250001)]


def _hires(dev, rows, n, seed):
    """(rows, n) float32 on the 24-bit grid: partials and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 192000.0
    x = (0.5 * np.sin(2 * np.pi * rng.uniform(100, 5000, (rows, 1)) * t)
         + 0.1 * rng.standard_normal((rows, n)))
    q = np.rint(x / np.abs(x).max() * 0.9 * (1 << 23)) / (1 << 23)
    return torch.from_numpy(q.astype(np.float32)).to(dev)


@pytest.mark.parametrize("rows,n", HIRES_SHAPES)
def test_hilbert_32k_against_plain(dev, rows, n):
    """The blksiz-32768 kernel against its plain twin (partitioned_convolve
    on torch.fft) within 1e-5, contiguous and on row views that float4
    loads cannot take (an odd row stride); one launch each."""
    from phaserotate_tpu_torch.kernels import hilbert32k as hk

    geo = hk.kernel_geometry(dev)
    assert geo["clusters"] >= 1 and geo["local_bytes"] == 0, geo
    x = _hires(dev, rows, n + 1, rows * 7 + n)
    for xin in (x[:, :n].contiguous(), x[:, 1:]):
        _build.reset_launches()
        got = hk.hilbert_32k(xin)
        assert _build.launches["hilbert_32k"] == 1
        want = hk.hilbert_32k_plain(xin)
        assert got.shape == want.shape == (rows, hk.out_len(n))
        assert (got - want).abs().max().item() < 1e-5


@pytest.mark.parametrize("clusters", [1, 2, 5])
def test_hilbert_32k_any_grid(dev, monkeypatch, clusters):
    """Any number of clusters gives the plain twin's answer: runs of
    several frames, runs that cross rows and the fix-up of their first
    frames (5 rows x 4 frames over 1, 2 and 5 clusters)."""
    from phaserotate_tpu_torch.kernels import hilbert32k as hk

    monkeypatch.setattr(hk, "kernel_geometry",
                        lambda device: {"clusters": clusters})
    x = _hires(dev, 5, 3 * 32768 - 5, clusters)
    got = hk.hilbert_32k(x)
    assert (got - hk.hilbert_32k_plain(x)).abs().max().item() < 1e-5


def test_hilbert_offline_32k_launches_the_kernel(dev):
    """hilbert_offline at blksiz 32768 launches hilbert_32k once and
    hilbert_small never, under a ``hilbert.one_partition`` span with its
    device ms; at 16384 the other way round."""
    from phaserotate_tpu_torch.core.sizes import OfflineGeometry
    from phaserotate_tpu_torch.search.sweep import hilbert_offline
    from phaserotate_tpu_torch.utils.profiling import drain, recording

    x = _hires(dev, 2, 70001, 5)
    _build.reset_launches()
    drain()
    with recording():
        h = hilbert_offline(x, OfflineGeometry(32768))
    (rec,) = drain()
    assert rec.name == "hilbert.one_partition"
    assert (rec.attrs["rows"], rec.attrs["n"], rec.attrs["n_out"]) == (
        2, 70001, 4 * 32768)
    assert rec.attrs["device_ms"] > 0
    assert h.shape == (2, 4 * 32768)
    assert (_build.launches["hilbert_32k"],
            _build.launches["hilbert_small"]) == (1, 0)
    hilbert_offline(x, OfflineGeometry(16384))
    assert (_build.launches["hilbert_32k"],
            _build.launches["hilbert_small"]) == (1, 1)


def test_sweep_192k_on_card_equals_cpu(dev):
    """sweep_peaks_aux at blksiz 32768 on the card: the input peaks equal
    the CPU's, the tables and rot0 within 2e-5 (the card's convolution
    rounds otherwise than the CPU's), and the same chosen angles."""
    from phaserotate_tpu_torch.core.sizes import offline_geometry
    from phaserotate_tpu_torch.search import (select_min_peak_angles_batch,
                                              sweep_peaks_aux)

    geom = offline_geometry(192000)
    assert geom.blksiz == 32768
    x = _hires(dev, 4, 400003, 192).reshape(2, 2, -1)
    _build.reset_launches()
    card = [t.cpu().numpy() for t in sweep_peaks_aux(x, geom)]
    assert _build.launches["hilbert_32k"] == 1
    cpu = [t.numpy() for t in sweep_peaks_aux(x.cpu(), geom)]
    assert np.array_equal(card[0][..., 0], cpu[0][..., 0])
    assert np.abs(card[0] - cpu[0]).max() < 2e-5
    assert np.abs(card[1] - cpu[1]).max() < 2e-5
    got, want = (select_min_peak_angles_batch(t, stride=24, rot0=r)
                 for t, r in (card, cpu))
    assert [g.angles_units for g in got] == [w.angles_units for w in want]


def test_apply_angles_32k_on_card_equals_cpu(dev):
    from phaserotate_tpu_torch.core.sizes import OfflineGeometry
    from phaserotate_tpu_torch.search import apply_angles

    geom = OfflineGeometry(32768)
    x = _hires(dev, 2, 150001, 32)
    _build.reset_launches()
    y = apply_angles(x, [70, -130], geom)
    assert _build.launches["hilbert_32k"] == 1
    want = apply_angles(x.cpu(), [70, -130], geom)
    assert y.shape == x.shape
    assert (y.cpu() - want).abs().max().item() < 2e-5
