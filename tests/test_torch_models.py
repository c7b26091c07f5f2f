"""The port's models (PhaseRotator, OfflineRotator, AngleAnalyzer) against
the JAX package's, on the same numpy-seeded inputs."""

import numpy as np
import pytest
import torch

import phaserotate_tpu_torch as ppr
from phaserotate_tpu.core.sizes import StreamGeometry as JGeom
from phaserotate_tpu.models import AngleAnalyzer as JAnalyzer
from phaserotate_tpu.models import OfflineRotator as JOffline
from phaserotate_tpu.models import PhaseRotator as JRotator
from phaserotate_tpu.search import sweep_peaks_aux as j_sweep_aux
from phaserotate_tpu.stream import engine as je
from phaserotate_tpu_torch.core.convert import (
    stream_state_from_jax,
    stream_state_to_jax,
)
from phaserotate_tpu_torch.core.sizes import StreamGeometry
from phaserotate_tpu_torch.models import (
    AngleAnalyzer,
    OfflineRotator,
    PhaseRotator,
)
from phaserotate_tpu_torch.utils import SweepCheckpoint

from test_search import make_signal

torch.set_num_threads(1)

_LEVELS = ("in_cur", "in_mom", "in_peak", "out_cur", "out_mom", "out_peak",
           "diff_cur", "diff_min", "diff_max")


def _sig(n, chans=1):
    t = np.arange(n) / 48000.0
    return np.stack([
        (0.6 * np.sin(2 * np.pi * 997 * t + c)
         + 0.35 * np.sin(2 * np.pi * 1994 * t + 0.7)).astype(np.float32)
        for c in range(chans)])


def test_phase_rotator_output_and_meters_match_jax(rng):
    x = (0.5 * rng.standard_normal((2, 40 * 333))).astype(np.float32)
    jr = JRotator(rate=48000, channels=2)
    pr = PhaseRotator(rate=48000, channels=2, device="cpu")
    plan = [[0.0, 0.0]] * 8 + [[35.0, -90.0]] * 10 + [[170.0, -90.0]] * 22
    sizes = [333, 1024, 64, 700, 4096]
    pos = 0
    for i, degs in enumerate(plan):
        n = min(sizes[i % len(sizes)], x.shape[1] - pos)
        if n <= 0:
            break
        blk = x[:, pos : pos + n]
        pos += n
        jy = jr.process(blk, degs)
        py = pr.process(blk, degs)
        np.testing.assert_allclose(py, jy, atol=1e-5)
        for c in range(2):
            jl, pl = jr.levels(c), pr.levels(c)
            for f in _LEVELS:
                assert getattr(pl, f).item() == pytest.approx(
                    float(getattr(jl, f)), abs=1e-5, rel=1e-5), (i, c, f)


def test_phase_rotator_mono_and_reset_peaks(rng):
    rot = PhaseRotator(rate=48000, channels=1, device="cpu")
    x = (0.8 * rng.standard_normal(8192)).astype(np.float32)
    y = rot.process(x, 35.0)
    assert y.shape == x.shape
    assert rot.levels(0).in_peak.item() > 0.3
    rot.process(np.zeros(rot.latency + 256, np.float32), 35.0)
    rot.reset_peaks()
    rot.process(np.zeros(256, np.float32), 35.0)
    assert rot.levels(0).in_peak.item() < 0.3
    quiet = PhaseRotator(rate=48000, channels=1, meters=False, device="cpu")
    np.testing.assert_array_equal(
        quiet.process(x, 35.0),
        PhaseRotator(rate=48000, device="cpu").process(x, 35.0))


def test_phase_rotator_checkpoint_resume(tmp_path, rng):
    """Save mid-frame, resume in a fresh rotator: bit-identical."""
    x = rng.standard_normal((2, 16 * 256)).astype(np.float32)
    split = 8 * 256 + 100
    ref = PhaseRotator(rate=48000, channels=2, device="cpu")
    y_ref = np.concatenate([ref.process(x[:, :split], 90.0),
                            ref.process(x[:, split:], 90.0)], axis=1)
    r1 = PhaseRotator(rate=48000, channels=2, device="cpu")
    y1 = r1.process(x[:, :split], 90.0)
    path = str(tmp_path / "s.npz")
    r1.save(path)
    r2 = PhaseRotator(rate=48000, channels=2, device="cpu")
    r2.load(path)
    y2 = r2.process(x[:, split:], 90.0)
    np.testing.assert_array_equal(np.concatenate([y1, y2], axis=1), y_ref)


def test_phase_rotator_resumes_jax_checkpoint(tmp_path, rng):
    """A JAX PhaseRotator's checkpoint continues in the port within 1e-5
    of JAX continuing it, host staging (mid-frame offset) included."""
    x = rng.standard_normal(12 * 256 + 77).astype(np.float32)
    split = 5 * 256 + 31
    jr = JRotator(rate=48000, channels=1)
    jr.process(x[:split], -45.0)
    path = str(tmp_path / "j.npz")
    jr.save(path)
    pr = PhaseRotator(rate=48000, channels=1, device="cpu")
    pr.load(path)
    np.testing.assert_allclose(pr.process(x[split:], -45.0),
                               jr.process(x[split:], -45.0), atol=1e-5)


def test_phase_rotator_checkpoint_validation(tmp_path):
    path = str(tmp_path / "s.npz")
    PhaseRotator(rate=48000, channels=1, device="cpu").save(path)
    with pytest.raises(ValueError, match="channels"):
        PhaseRotator(rate=48000, channels=2, device="cpu").load(path)
    with pytest.raises(ValueError, match="geometry"):
        PhaseRotator(rate=96000, channels=1, device="cpu").load(path)


@pytest.mark.parametrize("method,firlen", [
    ("spectral", None), ("fir", None), ("fir", 16128)])
def test_offline_rotator_matches_jax(rng, method, firlen):
    x = (0.5 * rng.standard_normal((2, 20000))).astype(np.float32)
    geom = None if firlen is None else StreamGeometry(48000.0, 512, firlen)
    jgeom = None if firlen is None else JGeom(48000.0, 512, firlen)
    want = JOffline(rate=48000, method=method, geom=jgeom)(x, 35.0)
    got = OfflineRotator(rate=48000, method=method, geom=geom,
                         device="cpu")(x, 35.0)
    assert isinstance(got, torch.Tensor) and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    with pytest.raises(ValueError):
        OfflineRotator(method="nope")


def test_analyzer_matches_jax(rng):
    x = make_signal(rng, 2, 6000)
    jan = JAnalyzer(rate=48000, blksiz=1024)
    pan = AngleAnalyzer(rate=48000, blksiz=1024, device="cpu")
    jres, pres = jan.analyze(x), pan.analyze(x)
    assert pres.angles_units == jres.angles_units
    np.testing.assert_allclose(pan.apply(x, pres).numpy(),
                               jan.apply(x, jres), atol=1e-5)


def test_analyzer_checkpoint_resume(tmp_path, rng):
    files = {f"f{i}": make_signal(rng, 1 + i % 2, 3000 + 64 * i)
             for i in range(3)}
    ck = str(tmp_path / "sweeps.npz")
    pan = AngleAnalyzer(rate=48000, blksiz=1024, device="cpu")
    first = pan.analyze_many(files, checkpoint=ck)
    want = JAnalyzer(rate=48000, blksiz=1024).analyze_many(files)
    for k, x in files.items():
        assert first[k].angles_units == want[k].angles_units
        jt, _ = j_sweep_aux(x, JAnalyzer(rate=48000, blksiz=1024).geom)
        np.testing.assert_allclose(SweepCheckpoint(ck).get(k)[0],
                                   np.asarray(jt), atol=3e-6)
    # the resume reads the tables: corrupted input, same angles
    broken = {k: np.zeros_like(v) for k, v in files.items()}
    second = pan.analyze_many(broken, checkpoint=ck)
    for k in files:
        assert second[k].angles_units == first[k].angles_units
    # the JAX package resumes from the port's checkpoint file too
    jres = JAnalyzer(rate=48000, blksiz=1024).analyze_many(broken,
                                                           checkpoint=ck)
    for k in files:
        assert jres[k].angles_units == first[k].angles_units
    with pytest.raises(ValueError, match="blksiz"):
        AngleAnalyzer(rate=48000, blksiz=2048,
                      device="cpu").analyze_many(files, checkpoint=ck)


def test_stream_state_from_jax_round_trip(rng):
    jg = JGeom(48000.0, 512, 3072)
    frames = rng.standard_normal((2, 9, 256)).astype(np.float32)
    js, _ = je.stream_process_batched(je.init_state(jg, (2,)), frames,
                                      np.asarray([30.0, 200.0], np.float32),
                                      jg)
    arrays = {f: np.asarray(getattr(js, f))
              for f in ("spec_hist", "time_hist", "tail", "angle")}
    ps = stream_state_from_jax(arrays)
    assert ps.spec_hist.dtype == torch.complex64
    assert ps.spec_hist.shape == (2, 12, 257)
    back = stream_state_to_jax(ps)
    for f, v in arrays.items():
        np.testing.assert_array_equal(back[f], v)


def test_lazy_top_level_exports():
    from phaserotate_tpu_torch.stream import StreamingRotator

    assert ppr.PhaseRotator is PhaseRotator
    assert ppr.OfflineRotator is OfflineRotator
    assert ppr.AngleAnalyzer is AngleAnalyzer
    assert ppr.StreamingRotator is StreamingRotator
    with pytest.raises(AttributeError):
        ppr.NoSuchModel
