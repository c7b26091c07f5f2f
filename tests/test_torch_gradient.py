"""The port's continuous angle refinement (search/gradient.py) against the
JAX package's, on the CPU.

``peak_at_angle`` is one evaluation of the objective and is held tightly
(3e-6, the operand budget of the aligned pair, tests/test_torch_slice.py).
``refine_angle`` is held by every guarantee tests/test_gradient.py states
for the JAX one, and its refined *peak* is held within 2e-5 of the JAX
package's.  Its ``theta`` is not compared: the backtracking compares
float32 peaks, XLA's and torch's ``sin``/``cos``/``exp`` differ in the
last place, and one flipped ``improved`` sends the two descents along
different steps, so the two angles can part while both peaks sit on the
same minimum (the surface is flat there).
"""

import numpy as np
import pytest
import torch

from phaserotate_tpu.core.sizes import OfflineGeometry as JGeom
from phaserotate_tpu.search import gradient as j_grad
from phaserotate_tpu_torch.core.sizes import OfflineGeometry
from phaserotate_tpu_torch.search import peak_at_angle, refine_angle
from phaserotate_tpu_torch.search import sweep_peaks
from phaserotate_tpu_torch.search.sweep import aligned_pair

from test_gradient import _multimodal_sig, _sig

torch.set_num_threads(1)

GEOM = OfflineGeometry(blksiz=1024)
J_GEOM = JGeom(blksiz=1024)


def _flat_sig():
    """Incommensurate two-tone: nearly angle-invariant objective."""
    t = np.arange(6000) / 48000.0
    return (0.5 * np.sin(2 * np.pi * 997 * t)
            + 0.31 * np.sin(2 * np.pi * 1601.7 * t + 1.0)).astype(np.float32)


def _noise_sig():
    rng = np.random.default_rng(11)
    return (0.3 * rng.standard_normal(5000)).astype(np.float32)


FIXTURES = {"sig": _sig, "multimodal": _multimodal_sig, "flat": _flat_sig,
            "noise": _noise_sig}
DEGENERATE = {
    "zeros": lambda: np.zeros(4096, np.float32),
    "dc": lambda: np.full(4096, 0.25, np.float32),
    "impulse": lambda: np.eye(1, 4096, 2048, dtype=np.float32)[0],
}


def _table(x):
    return sweep_peaks(x[None], GEOM, device="cpu")[0].numpy()


def _dense_peaks(x, thetas_units):
    """Float64 numpy evaluation of the full sweep objective on the port's
    own operands: the independent oracle of tests/test_gradient.py."""
    b0, b1, h_start, _ = (a.double().numpy() for a in aligned_pair(
        torch.from_numpy(x[None]), GEOM))
    rad = -np.asarray(thetas_units, np.float64)[:, None] * np.pi / 360.0
    aligned = np.max(np.abs(np.cos(rad) * b0 + np.sin(rad) * b1), axis=1)
    return np.maximum(aligned, np.abs(np.sin(rad[:, 0])) * h_start[0])


@pytest.mark.parametrize("angle", [17, 100, 255, 0.25, 33.3, 181.75,
                                   359.9, -12.5])
@pytest.mark.parametrize("name", ["sig", "multimodal"])
def test_peak_at_angle_equals_jax(name, angle):
    x = FIXTURES[name]()
    want = float(j_grad.peak_at_angle(x, np.float32(angle), J_GEOM))
    got = peak_at_angle(x, angle, GEOM, device="cpu")
    assert got.ndim == 0 and got.dtype == torch.float32
    assert abs(float(got) - want) <= 3e-6


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_peak_at_angle_matches_table(name):
    x = FIXTURES[name]()
    table = _table(x)
    for a in (17, 100, 255):
        p = float(peak_at_angle(x, np.float32(a), GEOM, device="cpu"))
        assert p <= table[a] + 1e-5


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_refine_improves_on_grid(name):
    x = FIXTURES[name]()
    table = _table(x)
    a0 = int(table.argmin())
    theta, peak = refine_angle(x, a0, GEOM, device="cpu")
    assert isinstance(theta, float) and isinstance(peak, float)
    assert peak <= table[a0] + 1e-6
    assert abs(theta - a0) < 4.0  # stays in the neighborhood


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_refine_from_poor_start(name):
    x = FIXTURES[name]()
    table = _table(x)
    a0 = int(table.argmin())
    theta, peak = refine_angle(x, a0 + 3, GEOM, steps=40, device="cpu")
    assert peak <= table[(a0 + 3) % 360] + 1e-6


@pytest.mark.parametrize("steps", [48, 64])
def test_refine_beats_dense_grid_near_start(steps):
    """Within its basin the refiner lands on the 0.01-deg brute force's
    minimum (within 2e-5 of the float64 oracle), and strictly below the
    best grid point whenever the dense minimum is.  The multimodal
    fixture only, as in tests/test_gradient.py: where the grid minimum
    sits on a kink of the objective (``_sig``), neither package's descent
    is promised to cross it."""
    x = _multimodal_sig()
    table = _table(x)
    a0 = int(table.argmin())
    theta, peak = refine_angle(x, a0, GEOM, steps=steps, device="cpu")
    dense = np.arange(a0 - 1.0, a0 + 1.0, 0.02)
    dense_min = _dense_peaks(x, dense).min()
    assert peak <= dense_min + 2e-5
    if dense_min < table[a0] - 2e-5:
        assert peak < table[a0]


def test_refine_multimodal_from_each_local_minimum():
    x = _multimodal_sig()
    table = _table(x)
    locs = [a for a in range(360)
            if table[a] <= table[(a - 1) % 360]
            and table[a] <= table[(a + 1) % 360]]
    assert len(locs) >= 3, "surface not multi-modal — bad fixture"
    for a0 in locs[:6]:
        theta, peak = refine_angle(x, a0, GEOM, steps=32, device="cpu")
        assert peak <= table[a0] + 1e-6
        assert abs(theta - a0) <= 4.0


def test_refine_flat_surface_stable():
    x = _flat_sig()
    table = _table(x)
    a0 = int(table.argmin())
    theta, peak = refine_angle(x, a0, GEOM, steps=32, device="cpu")
    assert np.isfinite(theta) and np.isfinite(peak)
    assert peak <= table[a0] + 1e-6
    assert abs(theta - a0) < 8.0


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_refine_from_argmax_never_worsens(name):
    x = FIXTURES[name]()
    table = _table(x)
    a_bad = int(table.argmax())
    p_start = _dense_peaks(x, np.array([float(a_bad)]))[0]
    theta, peak = refine_angle(x, a_bad, GEOM, steps=32, device="cpu")
    assert np.isfinite(peak) and peak <= p_start + 2e-6


@pytest.mark.parametrize("name", sorted(DEGENERATE))
def test_refine_degenerate_inputs(name):
    """Zeros, DC and one impulse: finite results, peak never above the
    start (the gradients of |.| at 0 and of max at ties stay finite)."""
    x = DEGENERATE[name]()
    theta, peak = refine_angle(x, 0, GEOM, steps=16, device="cpu")
    assert np.isfinite(theta) and np.isfinite(peak)
    p0 = _dense_peaks(x, np.array([0.0]))[0]
    assert peak <= p0 + 2e-6
    j_theta, j_peak = j_grad.refine_angle(x, 0, J_GEOM, steps=16)
    assert abs(peak - j_peak) <= 2e-6


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_refine_wraparound_start(name):
    x = FIXTURES[name]()
    theta, peak = refine_angle(x, 359, GEOM, steps=24, device="cpu")
    assert np.isfinite(theta) and np.isfinite(peak)
    p0 = _dense_peaks(x, np.array([359.0]))[0]
    assert peak <= p0 + 2e-6


@pytest.mark.parametrize("steps", [24, 48])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_refined_peak_equals_jax(name, steps):
    """Same input, same start: the two descents end on the same peak
    (2e-5, the float32 budget of tests/test_gradient.py)."""
    x = FIXTURES[name]()
    a0 = int(_table(x).argmin())
    _, want = j_grad.refine_angle(x, a0, J_GEOM, steps=steps)
    _, got = refine_angle(x, a0, GEOM, steps=steps, device="cpu")
    assert abs(got - want) <= 2e-5


def test_refine_takes_tensors_and_frees_its_graph():
    """A CPU tensor needs no device argument, a tensor that requires grad
    is a constant of the descent, and the result carries no graph."""
    x = torch.from_numpy(_sig()).requires_grad_(True)
    a0 = int(_table(_sig()).argmin())
    theta, peak = refine_angle(x, a0, GEOM)
    want = refine_angle(_sig(), a0, GEOM, device="cpu")
    assert (theta, peak) == want
    p = peak_at_angle(x, 17.5, GEOM)
    assert not p.requires_grad and x.grad is None


def test_temperature_schedule_is_float32():
    from phaserotate_tpu_torch.search.gradient import _RAD, _temperatures

    t = _temperatures(24)
    assert len(t) == 24 and t[0] == float(np.float32(1e-3))
    assert all(a > b for a, b in zip(t, t[1:]))
    assert all(float(np.float32(v)) == v for v in t)
    assert _RAD == float(j_grad._RAD)
