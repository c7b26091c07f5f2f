"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs where JAX is
absent; this repository's tests/conftest.py imports JAX, so run it there
without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from phaserotate_tpu_torch.core.angles import all_angle_cos_sin
from phaserotate_tpu_torch.core.angles import degrees_to_turns
from phaserotate_tpu_torch.kernels import _build
from phaserotate_tpu_torch.kernels import stream_conv as sc
from phaserotate_tpu_torch.kernels.rotate_peak import (
    rotate_peak_sweep_kernel,
    rotate_peak_sweep_plain,
)
from phaserotate_tpu_torch.ops.rotate import hilbert_fir, rotate_fir

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


def test_sweep_bit_equal(x):
    cs = all_angle_cos_sin(x.device)
    for tile in (4096, 1024, 100):
        got = rotate_peak_sweep_kernel(x[:, 50:], x[:, :-50], cs, tile)
        assert torch.equal(got, rotate_peak_sweep_plain(x[:, 50:],
                                                        x[:, :-50], cs))


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


def test_launches_counted(x):
    _build.reset_launches()
    sc.hilbert_small(x, 1024)
    sc.rotate_small(x, degrees_to_turns(10.0, device=x.device), 3072)
    rotate_peak_sweep_kernel(x, x, all_angle_cos_sin(x.device))
    assert _build.launches == {"rotate_peak_sweep": 1, "hilbert_small": 1,
                               "rotate_small": 1}


def test_unported_fused_conv_raises(x):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        hilbert_fir(x, 3072)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rotate_fir(x, 30.0, firlen=2816)  # 11 frames: not 512-aligned
