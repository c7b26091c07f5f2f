"""The port's fused_conv and peak modules against the JAX package's Pallas
kernels, run as tests/test_kernels.py runs them (interpret mode on the
CPU).  On a CPU tensor each wrapper runs its plain twin; the CUDA kernels
are held to those twins by tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaserotate_tpu.core.angles import degrees_to_turns as j_turns
from phaserotate_tpu.kernels import fused_conv as j_fc
from phaserotate_tpu.kernels import peak_kernel as j_peak
from phaserotate_tpu.ops.rotate import hilbert_fir as j_hilbert_fir
from phaserotate_tpu.ops.rotate import rotate_fir as j_rotate_fir
from phaserotate_tpu_torch.core.angles import degrees_to_turns
from phaserotate_tpu_torch.kernels import _build
from phaserotate_tpu_torch.kernels import fused_conv as p_fc
from phaserotate_tpu_torch.kernels.rotate_peak import peak_kernel
from phaserotate_tpu_torch.ops.rotate import hilbert_fir, rotate_fir

torch.set_num_threads(1)


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_fused_ola_conv_matches_jax(rng):
    firlen, parsiz = 3072, 4096
    frames = _x(rng, (2, 3, parsiz))
    want = np.asarray(j_fc.fused_ola_conv(
        jnp.asarray(frames), j_fc.hilbert_fir_kk(firlen, parsiz), parsiz,
        t_blocks=2))
    got = p_fc.fused_ola_conv(torch.from_numpy(frames),
                              p_fc.hilbert_fir_spectrum(firlen, parsiz),
                              parsiz)
    assert got.shape == want.shape == (2, 3 * parsiz)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-6)


@pytest.mark.parametrize("firlen,parsiz,atol", [
    (3072, None, 3e-6),   # the plugin's 48 kHz FIR at parsiz 4096
    (2048, 2048, 3e-6),   # the offline geometry blksiz 2048
    (8192, None, 1e-5),   # parsiz 8192
])
def test_fused_hilbert_matches_jax(rng, firlen, parsiz, atol):
    x = _x(rng, (2, 10000))
    want = np.asarray(j_fc.fused_hilbert(jnp.asarray(x), firlen, parsiz))
    got = p_fc.fused_hilbert(torch.from_numpy(x), firlen, parsiz)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=atol)


def test_fused_hilbert_offline_geometry_equals_hilbert_offline(rng):
    """parsiz == FIR support (the CLI geometry): the same stream as the
    offline sweep's Hilbert signal."""
    from phaserotate_tpu_torch.core.sizes import OfflineGeometry as PGeom
    from phaserotate_tpu_torch.search.sweep import hilbert_offline

    geom = PGeom(2048)
    x = torch.from_numpy(_x(rng, 2 * geom.parsiz + 123))
    want = hilbert_offline(x, geom)
    got = p_fc.fused_hilbert(x, geom.parsiz, geom.parsiz)
    assert got.shape == want.shape == (4 * geom.parsiz,)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-6)


@pytest.mark.parametrize("firlen", [3072, 4096])
def test_fused_rotate_fir_matches_jax(rng, firlen):
    x = _x(rng, (2, 10000))
    degs = np.asarray([35.0, -120.0], np.float32)
    want = np.asarray(j_fc.fused_rotate_fir(jnp.asarray(x), j_turns(degs),
                                            firlen))
    got = p_fc.fused_rotate_fir(torch.from_numpy(x), degrees_to_turns(degs),
                                firlen)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=3e-6)


def test_fused_rotate_fir_zero_angle_identity(rng):
    x = torch.from_numpy(_x(rng, (1, 9000)))
    got = p_fc.fused_rotate_fir(x, torch.zeros(1), 3072)
    assert torch.equal(got, x)


def test_support_tables_equal_jax():
    for firlen in range(2, 20002, 2):
        parsiz = p_fc.fused_parsiz_for(firlen)
        assert parsiz == j_fc.fused_parsiz_for(firlen), firlen
        assert p_fc.supported_parsiz(parsiz) == \
            j_fc.supported_parsiz(parsiz), firlen
        assert p_fc.mix_supported(firlen) == j_fc.mix_supported(firlen), \
            firlen
    for parsiz in [1 << k for k in range(8, 17)] + [3072, 6144]:
        assert p_fc.supported_parsiz(parsiz) == j_fc.supported_parsiz(parsiz)


def test_spectrum_is_jax_fir_zero_padded():
    from phaserotate_tpu.core.fir import design_hilbert_fir

    fir = np.pad(np.asarray(design_hilbert_fir(2816)), (0, 4096 - 2816))
    want = np.fft.rfft(np.pad(fir, (0, 4096))).astype(np.complex64)
    got = p_fc.hilbert_fir_spectrum(2816, 4096)
    assert got.dtype == torch.complex64 and got.shape == (4097,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("firlen", [2816, 16128])
def test_hilbert_fir_and_rotate_fir_match_jax(rng, firlen):
    """FIRs the small kernel cannot frame: on CUDA they run fused_conv;
    here both packages take the plain single-partition OLA."""
    x = _x(rng, (2, 20000))
    want_h = np.asarray(j_hilbert_fir(x, firlen))
    got_h = hilbert_fir(torch.from_numpy(x), firlen)
    np.testing.assert_allclose(got_h.numpy(), want_h, atol=1e-5)
    degs = np.asarray([30.0, -75.0], np.float32)
    want = np.asarray(j_rotate_fir(x, degs, firlen=firlen))
    got = rotate_fir(torch.from_numpy(x), degs, firlen=firlen)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("n", [1, 100, 65536, 100001])
def test_peak_kernel_matches_jax(rng, n):
    x = _x(rng, n)
    want = np.asarray(j_peak(x))
    got = peak_kernel(torch.from_numpy(x))
    assert got.shape == ()
    assert got.item() == float(want) == float(np.abs(x).max())


def test_peak_kernel_nan_and_empty(rng):
    x = _x(rng, 5000)
    x[1234] = -7.5
    assert peak_kernel(torch.from_numpy(x)).item() == 7.5
    x[99] = np.nan
    assert np.isnan(float(j_peak(x)))
    assert torch.isnan(peak_kernel(torch.from_numpy(x)))
    assert peak_kernel(torch.zeros(0)).item() == 0.0


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        p_fc.fused_hilbert(torch.zeros(100), firlen=3072, parsiz=1024)
    with pytest.raises(ValueError):
        p_fc.fused_hilbert(torch.zeros(100), firlen=8192, parsiz=4096)
    with pytest.raises(ValueError):
        p_fc.fused_rotate_fir(torch.zeros(100), torch.zeros(()), 2816)
    with pytest.raises(ValueError):
        p_fc.fused_ola_conv(torch.zeros(1, 2, 4096),
                            p_fc.hilbert_fir_spectrum(3072, 4096), 2048)
    with pytest.raises(ValueError):
        peak_kernel(torch.zeros(2, 3))


def test_no_launch_on_cpu(rng):
    _build.reset_launches()
    x = torch.from_numpy(_x(rng, (2, 5000)))
    p_fc.fused_hilbert(x, 3072)
    p_fc.fused_rotate_fir(x, torch.zeros(2), 3072)
    peak_kernel(x[0])
    hilbert_fir(x, 3072)
    assert all(v == 0 for v in _build.launches.values())
