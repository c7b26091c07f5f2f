"""The port's public surface against the JAX package's.

Every public name of the JAX top level, ``core``, ``ops``, ``search``
(with ``search.sweep`` and ``search.packed``), ``parallel`` (with its two
modules), ``fleet``, ``io``, ``utils``, ``kernels`` (with its three
modules), ``meter``, ``models``, ``stream`` (with ``stream.engine``,
``stream.host`` and ``stream.broker``) and the plugin role and serving
(``plugin``, ``gui``, ``bridge``, ``hostapp``, ``tui``, ``io.playback``)
exists in the port, apart
from the ones listed below with the reason each stays behind; the small
functions that closed the gaps agree with their JAX twins on seeded input;
the int16 ingest equals the float path; and the profiling hooks work on
the CPU.
"""

import importlib
import inspect
import json
import os
import tomllib

import numpy as np
import pytest
import torch

import phaserotate_tpu as j_pr
import phaserotate_tpu_torch as p_pr
from phaserotate_tpu import core as j_core, ops as j_ops
from phaserotate_tpu.core.sizes import OfflineGeometry as JGeom
from phaserotate_tpu.search import sweep as j_sweep
from phaserotate_tpu_torch import core as p_core, ops as p_ops
from phaserotate_tpu_torch.core.sizes import OfflineGeometry, StreamGeometry
from phaserotate_tpu_torch.search import sweep as p_sweep
from phaserotate_tpu_torch.utils import StageTimer, device_trace, sync

torch.set_num_threads(1)

# names of the JAX package the port leaves behind on purpose: each works
# around the TPU runtime (ROADMAP.md "Left behind on purpose")
LEFT_BEHIND = {
    "core": {
        "enable_persistent_cache": "XLA compile-cache warmup",
        "warmup_offline": "XLA compile-cache warmup",
        "warmup_stream": "XLA compile-cache warmup",
    },
    "utils": {
        "from_ri": "real/imag pairing: complex64 could not cross the "
                   "host/device boundary of the TPU runtime",
        "np_to_ri": "real/imag pairing, as from_ri",
        "to_ri": "real/imag pairing, as from_ri",
    },
    "search.sweep": {
        "pack_pcm16": "int16 -> int32 bitcast: int16 transfers hung on "
                      "the TPU runtime; the port ships int16 as it is",
    },
    "kernels": {
        "use_interpret": "the Pallas interpret-mode switch: the port's "
                         "wrappers take the plain twin for a CPU tensor",
    },
    "kernels.rotate_peak": {
        "on_tpu": "the Pallas interpret-mode switch, as use_interpret",
        "use_interpret": "the Pallas interpret-mode switch: the port's "
                         "wrappers take the plain twin for a CPU tensor",
    },
    "kernels.fused_conv": {
        "fir_kk_layout": "the 4-step matmul FFT's [k1][k2] layout for the "
                         "TPU's matrix unit; the CUDA kernel takes the "
                         "plain half spectrum (hilbert_fir_spectrum)",
        "hilbert_fir_kk": "the FIR in that [k1][k2] layout, as "
                          "fir_kk_layout",
    },
}
SURFACES = ["", "core", "ops", "search", "search.sweep", "search.packed",
            "parallel", "parallel.mesh", "parallel.batch", "fleet", "io",
            "utils", "kernels", "kernels.stream_conv", "kernels.fused_conv",
            "kernels.rotate_peak", "meter", "models", "plugin",
            "plugin.lifecycle", "gui", "stream", "stream.engine",
            "stream.host", "stream.broker", "bridge", "hostapp", "tui",
            "io.playback"]


# parameters of a JAX callable that its port leaves out, each with the
# reason; var-positional and var-keyword parameters (``*arrays``,
# ``**kwargs``) name nothing a caller passes by keyword and are not
# compared
PARAMS_LEFT_BEHIND = {
    "t_blocks": "the Pallas grid's frame tile: each CUDA kernel sizes its "
                "own tiles and grid",
    "bf16": "the one-pass bf16 matrix-unit mode: left behind with the "
            "bf16= sweep flag (ROADMAP.md)",
    "tile_rows": "the Pallas peak kernel's row tile",
    "chunk": "ops.rotated_peak_sweep's angle chunks, which bound XLA's "
             "memory: the sweep kernel takes the whole table at once",
    "fir_kk": "the 4-step matmul FFT's [k1][k2] FIR layout (fir_kk_layout)",
}


def _pair(sub):
    dot = "." + sub if sub else ""
    return (importlib.import_module("phaserotate_tpu" + dot),
            importlib.import_module("phaserotate_tpu_torch" + dot))


def _name_cases():
    cases = []
    for sub in SURFACES:
        j_mod, _ = _pair(sub)
        names = list(j_mod.__all__)
        if sub == "search":
            names.append("refine_angle")  # lazy, outside __all__
        cases += [(sub or "top", n) for n in sorted(names)]
    return cases


@pytest.mark.parametrize("surface,name", _name_cases())
def test_public_name_of_the_jax_package_exists(surface, name):
    sub = "" if surface == "top" else surface
    _, p_mod = _pair(sub)
    if name in LEFT_BEHIND.get(sub, {}):
        assert LEFT_BEHIND[sub][name]  # the reason is written down
        assert not hasattr(p_mod, name), \
            f"{name} is ported now: take it off the list"
        return
    assert getattr(p_mod, name) is not None
    if name != "__version__":
        assert name in p_mod.__all__ or (sub, name) == ("search",
                                                        "refine_angle")


def _signature(obj):
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):  # a builtin without one
        return None


def _param_cases():
    cases = []
    for sub in SURFACES:
        j_mod, _ = _pair(sub)
        for name in sorted(j_mod.__all__):
            obj = getattr(j_mod, name, None)
            if (name in LEFT_BEHIND.get(sub, {}) or not callable(obj)
                    or _signature(obj) is None):
                continue
            cases.append((sub or "top", name))
    return cases


@pytest.mark.parametrize("surface,name", _param_cases())
def test_parameter_names_of_the_jax_package_exist(surface, name):
    """A keyword call that works on the JAX package works on the port:
    every named parameter of a public callable exists in its port, apart
    from PARAMS_LEFT_BEHIND."""
    sub = "" if surface == "top" else surface
    j_mod, p_mod = _pair(sub)
    named = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
    params = _signature(getattr(j_mod, name)).parameters.values()
    want = [p.name for p in params
            if p.kind not in named and p.name not in PARAMS_LEFT_BEHIND]
    got = _signature(getattr(p_mod, name))
    assert got is not None, f"{name} has no signature in the port"
    missing = [p for p in want if p not in got.parameters]
    assert not missing, f"{sub or 'top'}.{name} lacks {missing}"


def test_left_out_parameters_are_parameters_of_the_jax_package():
    seen = set()
    for surface, name in _param_cases():
        j_mod, _ = _pair("" if surface == "top" else surface)
        seen |= set(_signature(getattr(j_mod, name)).parameters)
    assert set(PARAMS_LEFT_BEHIND) <= seen
    assert all(PARAMS_LEFT_BEHIND.values())


def test_stream_step_batched_takes_frames_by_keyword():
    from phaserotate_tpu_torch.stream import engine

    g = p_core.stream_geometry_for_rate(48000)
    frames = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, g.parsiz)).astype(np.float32))
    state = engine.init_state(g, (2,), device="cpu")
    _, by_name = engine.stream_step_batched(
        state=state, frames=frames, target_degrees=torch.tensor([10.0, 20.0]),
        geom=g)
    _, by_place = engine.stream_step(state, frames,
                                     torch.tensor([10.0, 20.0]), g)
    assert torch.equal(by_name, by_place)


def _scripts():
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


@pytest.mark.parametrize("script", sorted(
    k for k, v in _scripts().items() if v.startswith("phaserotate_tpu.")))
def test_every_script_has_a_torch_twin(script):
    """Each entry point of the JAX package has a ``-torch`` script whose
    target is the port's module of the same name, importable and
    callable."""
    scripts = _scripts()
    twin = scripts.get(f"{script}-torch")
    assert twin == scripts[script].replace("phaserotate_tpu.",
                                           "phaserotate_tpu_torch.", 1)
    module, attr = twin.split(":")
    assert callable(getattr(importlib.import_module(module), attr))


def test_left_behind_names_are_names_of_the_jax_package():
    for sub, names in LEFT_BEHIND.items():
        j_mod, _ = _pair(sub)
        for name in names:
            assert name in j_mod.__all__, (sub, name)


def test_jax_kernel_names_are_the_ports_wrappers():
    from phaserotate_tpu_torch.kernels import stream_conv as sc

    assert sc.fused_hilbert_small is sc.hilbert_small
    assert sc.fused_rotate_small is sc.rotate_small


def test_top_level_lazy_names():
    assert p_pr.read_audio is importlib.import_module(
        "phaserotate_tpu_torch.io").read_audio
    assert p_pr.write_audio is importlib.import_module(
        "phaserotate_tpu_torch.io").write_audio
    assert p_pr.MAXSAMPLE == j_pr.MAXSAMPLE == 360
    assert p_pr.SUBSAMPLE == j_pr.SUBSAMPLE == 2
    assert p_pr.offline_geometry(48000) == OfflineGeometry(8192)
    g = p_pr.stream_geometry_for_rate(48000)
    assert isinstance(g, StreamGeometry)
    assert (g.firlen, g.parsiz) == (
        j_pr.stream_geometry_for_rate(48000).firlen,
        j_pr.stream_geometry_for_rate(48000).parsiz)
    with pytest.raises(AttributeError):
        p_pr.no_such_name


# ---- the small functions ---------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_degrees_to_turns_np_equals_jax(seed):
    d = np.random.default_rng(seed).uniform(-400, 400, 257)
    d = np.concatenate([d, [0.0, 180.0, -180.0, 360.0]]).astype(np.float32)
    got = p_core.degrees_to_turns_np(d)
    want = j_core.angles.degrees_to_turns_np(d)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    # and the tensor twin computes the same quotient
    assert np.array_equal(p_core.degrees_to_turns(d, device="cpu").numpy(),
                          got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wrap_turns_delta_equals_jax(seed):
    da = np.random.default_rng(seed).uniform(-1, 1, 300)
    da = np.concatenate([da, [0.5, -0.5, 0.0, 0.75, -0.75]]
                        ).astype(np.float32)
    got = p_core.wrap_turns_delta(da)
    want = np.asarray(j_core.wrap_turns_delta(da))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert float(p_core.wrap_turns_delta(0.75)) == -0.25


@pytest.mark.parametrize("a", [-721, -360, -1, 0, 1, 359, 360, 361, 1000])
def test_wrap_angle_units_equals_jax(a):
    assert p_core.wrap_angle_units(a) == j_core.wrap_angle_units(a)
    assert 0 <= p_core.wrap_angle_units(a % 360 - 360) < 360


@pytest.mark.parametrize("seed", [0, 1])
def test_sin_cos_units_equals_jax(seed):
    a = np.random.default_rng(seed).integers(-360, 720, 200)
    s, c = p_core.sin_cos_units(a)
    js, jc = j_core.sin_cos_units(a)
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(c.numpy(), np.asarray(jc))
    s1, c1 = p_core.sin_cos_units(torch.tensor(-3))
    assert s1.ndim == 0 and c1.ndim == 0
    assert float(s1) == float(j_core.sin_cos_units(-3)[0])


@pytest.mark.parametrize("rate", [44100, 48000, 96000, 192000])
def test_stream_fir_spectra_equals_jax(rate):
    g = p_core.stream_geometry_for_rate(rate)
    jg = j_core.stream_geometry_for_rate(rate)
    got = p_core.stream_fir_spectra(g)
    want = np.asarray(j_core.stream_fir_spectra(jg))  # (..., 2) re/im
    assert got.dtype == torch.complex64
    assert got.shape == (g.firlen // g.parsiz, g.parsiz + 1)
    assert np.array_equal(got.real.numpy(), want[..., 0])
    assert np.array_equal(got.imag.numpy(), want[..., 1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rotated_peak_equals_jax(seed):
    rng = np.random.default_rng(seed)
    b0 = rng.standard_normal((3, 999)).astype(np.float32)
    b1 = rng.standard_normal((3, 999)).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi)
    sa, ca = np.float32(np.sin(th)), np.float32(np.cos(th))
    got = p_ops.rotated_peak(torch.from_numpy(b0), torch.from_numpy(b1),
                             float(sa), float(ca))
    want = np.asarray(j_ops.rotated_peak(b0, b1, sa, ca))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # a running peak above the data wins
    got = p_ops.rotated_peak(torch.from_numpy(b0), torch.from_numpy(b1),
                             float(sa), float(ca), current=99.0)
    assert torch.equal(got, torch.full((3,), 99.0))


def test_coeff_to_db_equals_jax():
    c = np.array([0.0, 1e-16, 1e-15, 1e-6, 0.5, 1.0, 2.0], np.float32)
    got = p_ops.coeff_to_db(c).numpy()
    want = np.asarray(j_ops.coeff_to_db(c))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-5, rtol=0)
    assert float(p_ops.coeff_to_db(1.0)) == 0.0
    assert float(p_ops.coeff_to_db(0.0)) == -np.inf


# ---- the int16 ingest ------------------------------------------------------


def _pcm(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 6000).clip(
        -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("shape,blksiz", [((2, 5000), 1024),
                                          ((3, 2, 4097), 1024),
                                          ((7001,), 2048)])
def test_sweep_pcm16_equals_the_float_path(shape, blksiz):
    x16 = _pcm(sum(shape), shape)
    geom = OfflineGeometry(blksiz)
    table, rot0 = p_sweep.sweep_peaks_aux_pcm16(x16, geom, device="cpu")
    floats = x16.astype(np.float32) * np.float32(1.0 / 32768.0)
    w_table, w_rot0 = p_sweep.sweep_peaks_aux(floats, geom, device="cpu")
    assert torch.equal(table, w_table) and torch.equal(rot0, w_rot0)
    # a CPU int16 tensor needs no device argument
    t2, r2 = p_sweep.sweep_peaks_aux_pcm16(torch.from_numpy(x16), geom)
    assert torch.equal(t2, table) and torch.equal(r2, rot0)
    j_table, j_rot0 = j_sweep.sweep_peaks_aux_pcm16(x16, JGeom(blksiz))
    np.testing.assert_allclose(table.numpy(), np.asarray(j_table),
                               atol=3e-6, rtol=0)
    np.testing.assert_allclose(rot0.numpy(), np.asarray(j_rot0),
                               atol=3e-6, rtol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint16])
def test_sweep_pcm16_rejects_other_dtypes(dtype):
    x = np.zeros((2, 3000), dtype)
    with pytest.raises(TypeError, match="int16"):
        p_sweep.sweep_peaks_aux_pcm16(x, OfflineGeometry(1024),
                                      device="cpu")
    with pytest.raises(TypeError, match="int16"):
        p_sweep.sweep_peaks_aux_pcm16(torch.from_numpy(
            x.astype(np.float32)), OfflineGeometry(1024))


def test_sweep_pcm16_pairs_with_read_audio_pcm16(tmp_path):
    from phaserotate_tpu_torch.io import (read_audio, read_audio_pcm16,
                                          write_wav)

    path = str(tmp_path / "in.wav")
    write_wav(path, _pcm(9, (2, 6000)).astype(np.float32) / 32768.0, 48000,
              bits=16, float_format=False)
    x16, rate, _ = read_audio_pcm16(path)
    floats, f_rate, _ = read_audio(path)
    assert x16.dtype == np.int16 and rate == f_rate == 48000
    geom = OfflineGeometry(1024)
    table, rot0 = p_sweep.sweep_peaks_aux_pcm16(x16, geom, device="cpu")
    w_table, w_rot0 = p_sweep.sweep_peaks_aux(floats, geom, device="cpu")
    assert torch.equal(table, w_table) and torch.equal(rot0, w_rot0)


# ---- profiling -------------------------------------------------------------


def test_stage_timer_accumulates():
    t = StageTimer()
    for _ in range(3):
        with t.stage("a"):
            sync(torch.zeros(4))
    with pytest.raises(ValueError):
        with t.stage("b"):
            raise ValueError("still counted")
    assert t.counts == {"a": 3, "b": 1}
    assert t.totals["a"] >= 0.0 and t.totals["b"] >= 0.0
    report = t.report().splitlines()
    assert len(report) == 2
    assert {line.split()[0] for line in report} == {"a", "b"}
    assert "(3x," in t.report()


def test_sync_takes_anything():
    sync()
    sync(torch.zeros(2), None, 3.0, np.zeros(2))


def test_device_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "traces" / "run")
    with device_trace(log_dir):
        x = torch.randn(2, 3000)
        p_sweep.sweep_peaks(x, OfflineGeometry(1024))
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(log_dir, files[0])) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("fft" in n for n in names), sorted(names)[:20]


def test_device_trace_closes_on_error(tmp_path):
    with pytest.raises(KeyError):
        with device_trace(str(tmp_path)):
            raise KeyError("boom")
    assert len(os.listdir(str(tmp_path))) == 1
