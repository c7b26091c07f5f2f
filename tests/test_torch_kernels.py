"""Port kernel modules (phaserotate_tpu_torch.kernels) against the JAX
package's Pallas kernels, run as tests/test_kernels.py runs them (interpret
mode on the CPU).  On a CPU tensor each wrapper runs its plain PyTorch
twin; the CUDA kernels themselves are held to those twins by
tests/test_torch_cuda.py (on the card) and by chip_smoke.py."""

import numpy as np
import pytest
import torch

from phaserotate_tpu.core.angles import all_angle_cos_sin as j_cos_sin
from phaserotate_tpu.core.angles import degrees_to_turns as j_turns
from phaserotate_tpu.kernels import rotate_peak_sweep_kernel as j_sweep
from phaserotate_tpu.kernels import stream_conv as j_sc
from phaserotate_tpu_torch.core.angles import all_angle_cos_sin
from phaserotate_tpu_torch.core.angles import degrees_to_turns
from phaserotate_tpu_torch.kernels import _build
from phaserotate_tpu_torch.kernels import stream_conv as p_sc
from phaserotate_tpu_torch.kernels.rotate_peak import (
    rotate_peak_sweep_kernel,
    rotate_peak_sweep_plain,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(30000,), (2, 3, 4100)])
def test_sweep_matches_jax_kernel(rng, shape):
    b0 = rng.standard_normal(shape).astype(np.float32)
    b1 = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(j_sweep(b0, b1, j_cos_sin(), tile_len=4096))
    got = rotate_peak_sweep_kernel(torch.from_numpy(b0),
                                   torch.from_numpy(b1), all_angle_cos_sin())
    assert got.shape == shape[:-1] + (360,)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_sweep_plain_is_unfused_rounding(rng):
    """The plain twin rounds c*b0 and s*b1 separately before the sum —
    the rounding the CUDA kernel reproduces for its bit-equal table."""
    b0 = rng.standard_normal(3000).astype(np.float32)
    b1 = rng.standard_normal(3000).astype(np.float32)
    cs = all_angle_cos_sin().numpy()
    want = np.abs(cs[0][:, None] * b0[None] + cs[1][:, None] * b1[None])
    got = rotate_peak_sweep_plain(torch.from_numpy(b0), torch.from_numpy(b1),
                                  torch.from_numpy(cs))
    np.testing.assert_array_equal(got.numpy(), want.max(axis=1))


@pytest.mark.parametrize("taps", [1024, 3072, 8192])
def test_hilbert_small_matches_jax_kernel(rng, taps):
    x = rng.standard_normal((2, 5000)).astype(np.float32)
    want = np.asarray(j_sc.fused_hilbert_small(x, taps, t_blocks=16))
    got = p_sc.hilbert_small(torch.from_numpy(x), taps)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_rotate_small_matches_jax_kernel(rng):
    firlen, n = 3072, 9000
    x = rng.standard_normal((3, n)).astype(np.float32)
    degs = np.asarray([0.0, 90.0, -77.0], np.float32)
    want = np.asarray(j_sc.fused_rotate_small(x, j_turns(degs), firlen,
                                              t_blocks=16))
    got = p_sc.rotate_small(torch.from_numpy(x), degrees_to_turns(degs),
                            firlen).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=2e-5)
    # angle 0: exact identity (cos=1, sin=0 exactly at turns=0)
    np.testing.assert_allclose(got[0], x[0], atol=1e-6)


def test_support_tables_equal():
    for taps in list(range(0, 20000, 128)) + [100, 3000, 16384, 16640]:
        assert p_sc.small_conv_supported(taps) == \
            j_sc.small_conv_supported(taps), taps
        assert p_sc.stream_mix_supported(taps) == \
            j_sc.stream_mix_supported(taps), taps
    assert p_sc.P == j_sc.P


def test_wrappers_reject_unsupported_geometry():
    x = torch.zeros(1000)
    with pytest.raises(ValueError):
        p_sc.hilbert_small(x, 256)
    with pytest.raises(ValueError):
        p_sc.rotate_small(x, torch.zeros(()), 1024 + 256)


def test_no_build_or_launch_on_cpu(rng):
    """CPU tensors take the plain twins: no launch is counted."""
    _build.reset_launches()
    x = torch.from_numpy(rng.standard_normal(3000).astype(np.float32))
    p_sc.hilbert_small(x, 1024)
    p_sc.rotate_small(x, degrees_to_turns(30.0), 3072)
    rotate_peak_sweep_kernel(x, x, all_angle_cos_sin())
    assert all(v == 0 for v in _build.launches.values())

