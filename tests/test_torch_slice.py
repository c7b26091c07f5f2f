"""The port's analyze -> apply slice against the JAX package and the
literal CLI simulator: peak tables, chosen angles, applied audio and the
FIR rotate, on the same numpy-seeded inputs."""

import numpy as np
import pytest
import torch

import phaserotate_tpu as jpr
import phaserotate_tpu_torch as ppr
from phaserotate_tpu.core.sizes import OfflineGeometry as JGeom
from phaserotate_tpu.search import apply_angles as j_apply
from phaserotate_tpu.search import sweep_peaks_aux as j_sweep_aux
from phaserotate_tpu_torch.core.angles import MAXSAMPLE
from phaserotate_tpu_torch.core.sizes import OfflineGeometry as PGeom
from phaserotate_tpu_torch.ops.rotate import hilbert_fir
from phaserotate_tpu_torch.search import sweep_peaks_aux as p_sweep_aux

from ref_cli_sim import RefRotate
from test_search import make_signal

torch.set_num_threads(1)


def _corpus(rng):
    """The make_signal corpus: stereo and mono, block-aligned or not."""
    return [make_signal(rng, 2, 2600), make_signal(rng, 1, 4000),
            make_signal(rng, 2, 8000)]


@pytest.mark.parametrize("blksiz", [1024, 2048, 32768])
def test_sweep_tables_and_rot0_match_jax(rng, blksiz):
    """blksiz 1024/2048 run the stream_conv path; 32768 (beyond the small
    kernel's 64 partitions) the plain single-partition OLA on both sides."""
    for x in _corpus(rng):
        jt, jr = j_sweep_aux(x, JGeom(blksiz))
        pt, pr = p_sweep_aux(torch.from_numpy(x), PGeom(blksiz))
        assert pt.shape == (x.shape[0], MAXSAMPLE)
        np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=3e-6)
        np.testing.assert_allclose(pr.numpy(), np.asarray(jr), atol=3e-6)


def test_sweep_tables_match_cli_simulator(rng):
    geom = PGeom(1024)
    for x in _corpus(rng)[:2]:
        table, _ = p_sweep_aux(torch.from_numpy(x), geom)
        sim = RefRotate(geom.blksiz, x.shape[0])
        sim.analyze_file(x, 0, MAXSAMPLE, 1)
        np.testing.assert_allclose(table.numpy(), sim.peak, atol=3e-5)


@pytest.mark.parametrize("stride", [1, 24, 90])
@pytest.mark.parametrize("link", [False, True])
def test_find_min_peak_angle_equals_jax(rng, stride, link):
    for x in _corpus(rng):
        kw = dict(rate=48000, stride=stride, link_channels=link, blksiz=1024)
        want = jpr.find_min_peak_angle(x, **kw)
        got = ppr.find_min_peak_angle(x, **kw, device="cpu")
        assert got.angles_units == want.angles_units
        assert got.found == want.found
        assert got.coarse_considered == want.coarse_considered
        np.testing.assert_allclose(got.peak_min, want.peak_min, atol=3e-6)


@pytest.mark.parametrize("stride", [1, 24, 90])
def test_find_min_peak_angle_sine_sweep(sine_sweep, stride):
    """The BASELINE config-0 signal (10 s, 44.1 kHz, default blksiz)."""
    x, rate = sine_sweep
    want = jpr.find_min_peak_angle(x, rate=rate, stride=stride)
    got = ppr.find_min_peak_angle(x, rate=rate, stride=stride,
                                  device="cpu")
    assert got.angles_units == want.angles_units
    assert got.found == want.found
    np.testing.assert_allclose(got.peak_zero, want.peak_zero, atol=3e-6)


@pytest.mark.parametrize("n", [3 * 1024, 3000])
def test_apply_angles_matches_jax(rng, n):
    x = make_signal(rng, 2, n)
    angles = np.asarray([70, -44])
    want = np.asarray(j_apply(x, angles, JGeom(1024)))
    got = ppr.apply_angles(torch.from_numpy(x), angles, PGeom(1024))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_apply_negative_wraps_to_negated(rng):
    """-10 deg applies as 170 deg (cli/phase-rotate.cc:463)."""
    x = torch.from_numpy(make_signal(rng, 1, 2600))
    y_neg = ppr.apply_angles(x, [-20], PGeom(1024))
    y_wrap = ppr.apply_angles(x, [340], PGeom(1024))
    assert torch.equal(y_neg, y_wrap)


@pytest.mark.parametrize("firlen", [None, 4096, 20480])
def test_rotate_fir_matches_jax(rng, firlen):
    """None: the 48 kHz plugin FIR (3072, the stream_conv mix path);
    20480: beyond every kernel, the plain hilbert_fir path."""
    x = rng.standard_normal((3, 9000)).astype(np.float32)
    degs = np.asarray([35.0, -120.0, 0.0], np.float32)
    want = np.asarray(jpr.rotate(x, degs, method="fir", firlen=firlen))
    got = ppr.rotate(torch.from_numpy(x), torch.from_numpy(degs),
                     method="fir", firlen=firlen)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_rotate_spectral_sin_to_minus_cos():
    rate = 48000
    t = np.arange(rate) / rate
    x = np.sin(2 * np.pi * 480.0 * t).astype(np.float32)
    y = ppr.rotate(x, 90.0, device="cpu").numpy()
    np.testing.assert_allclose(y, -np.cos(2 * np.pi * 480.0 * t), atol=1e-5)
    np.testing.assert_allclose(y, np.asarray(jpr.rotate(x, 90.0)), atol=1e-6)


def test_rotate_spectral_edges_match_jax(rng):
    """DC and Nyquist scale by cos(theta) (ops/rotate.py:57-61), odd and
    even lengths, batched angles."""
    for n in (1001, 1024):
        x = rng.standard_normal((2, n)).astype(np.float32) + 0.5
        degs = np.asarray([60.0, -135.0], np.float32)
        want = np.asarray(jpr.rotate(x, degs))
        got = ppr.rotate(torch.from_numpy(x), degs).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_hilbert_fir_matches_jax(rng):
    from phaserotate_tpu.ops.rotate import hilbert_fir as j_hilbert_fir

    x = rng.standard_normal((2, 7000)).astype(np.float32)
    want = np.asarray(j_hilbert_fir(x, 3072))
    got = hilbert_fir(torch.from_numpy(x), 3072)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
