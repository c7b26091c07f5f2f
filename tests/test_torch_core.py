"""Port core (phaserotate_tpu_torch.core) against the JAX package: FIR
taps, partition spectra, angle tables and sizing tables are bit-equal, and
the JAX package's constants carry across unchanged."""

import numpy as np
import pytest
import torch

from phaserotate_tpu.core import angles as j_angles
from phaserotate_tpu.core import fir as j_fir
from phaserotate_tpu.core import sizes as j_sizes
from phaserotate_tpu_torch.core import angles as p_angles
from phaserotate_tpu_torch.core import fir as p_fir
from phaserotate_tpu_torch.core import sizes as p_sizes
from phaserotate_tpu_torch.core.convert import (
    constants_from_jax,
    port_constants,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("taps", [512, 1024, 3072, 4096, 8192, 32768])
def test_fir_taps_bit_equal(taps):
    want = np.asarray(j_fir.design_hilbert_fir(taps))
    got = p_fir.design_hilbert_fir(taps).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("taps,parsiz", [(3072, 256), (8192, 256),
                                         (1024, 1024), (3072, 512),
                                         (8192, 8192)])
def test_partition_spectra_bit_equal(taps, parsiz):
    ri = np.asarray(j_fir.partition_fir_spectra(taps, parsiz))
    got = p_fir.partition_fir_spectra(taps, parsiz)
    assert got.dtype == torch.complex64
    assert got.shape == (taps // parsiz, parsiz + 1)
    np.testing.assert_array_equal(got.real.numpy(), ri[..., 0])
    np.testing.assert_array_equal(got.imag.numpy(), ri[..., 1])


@pytest.mark.parametrize("blksiz", [1024, 8192])
def test_offline_fir_spectrum_bit_equal(blksiz):
    ri = np.asarray(j_fir.offline_fir_spectrum(
        j_sizes.OfflineGeometry(blksiz)))
    got = p_fir.offline_fir_spectrum(p_sizes.OfflineGeometry(blksiz))
    np.testing.assert_array_equal(got.real.numpy(), ri[..., 0])
    np.testing.assert_array_equal(got.imag.numpy(), ri[..., 1])


def test_angle_luts_bit_equal():
    js, jc = j_angles.sincos_lut()
    ps, pc = p_angles.sincos_lut()
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(p_angles.all_angle_cos_sin().numpy(),
                                  np.asarray(j_angles.all_angle_cos_sin()))
    assert p_angles.MAXSAMPLE == j_angles.MAXSAMPLE
    assert p_angles.SUBSAMPLE == j_angles.SUBSAMPLE


def test_degrees_to_turns_bit_equal():
    deg = np.concatenate([np.linspace(-400, 400, 4001),
                          np.arange(-180, 180.5, 0.5)]).astype(np.float32)
    np.testing.assert_array_equal(
        p_angles.degrees_to_turns(deg).numpy(),
        np.asarray(j_angles.degrees_to_turns(deg)))


def test_sin_cos_turns_close():
    turns = np.linspace(-0.5, 0.5, 1001).astype(np.float32)
    js, jc = j_angles.sin_cos_turns(turns)
    ps, pc = p_angles.sin_cos_turns(torch.from_numpy(turns))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-6)


@pytest.mark.parametrize("deg", [10.25, -10.25, 0.25, -0.25, 179.75, 33.0,
                                 -0.74, 90.5])
def test_angle_units_c_round(deg):
    assert (p_angles.angle_units_from_degrees(deg)
            == j_angles.angle_units_from_degrees(deg))


@pytest.mark.parametrize("rate", [8000, 22050, 44100, 48000, 63999, 64000,
                                  96000, 127999, 128000, 192000, 384000])
def test_sizing_tables_equal(rate):
    js, ps = (j_sizes.stream_geometry_for_rate(rate),
              p_sizes.stream_geometry_for_rate(rate))
    for attr in ("fftlen", "firlen", "parsiz", "firlat", "n_segm",
                 "latency", "interp_th", "interp_nm"):
        assert getattr(ps, attr) == getattr(js, attr), attr
    for req in (0, 1000, 1024, 3000, 16384, 40000):
        jg, pg = (j_sizes.offline_geometry(rate, req),
                  p_sizes.offline_geometry(rate, req))
        for attr in ("blksiz", "parsiz", "fftlen", "firlen", "latency"):
            assert getattr(pg, attr) == getattr(jg, attr), (attr, req)


def _jax_constants(taps, parsiz):
    s, c = j_angles.sincos_lut()
    return {
        "fir": np.asarray(j_fir.design_hilbert_fir(taps)),
        "fir_spectra": np.asarray(j_fir.partition_fir_spectra(taps, parsiz)),
        "sincos_lut": np.stack([np.asarray(s), np.asarray(c)]),
        "cos_sin": np.asarray(j_angles.all_angle_cos_sin()),
    }


@pytest.mark.parametrize("taps,parsiz", [(3072, 256), (8192, 8192)])
def test_constants_from_jax_round_trip(taps, parsiz):
    got = constants_from_jax(_jax_constants(taps, parsiz))
    want = port_constants(taps, parsiz)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    # and back: the port's tensors reproduce the JAX arrays exactly
    ri = torch.stack([got["fir_spectra"].real, got["fir_spectra"].imag], -1)
    np.testing.assert_array_equal(
        ri.numpy(), np.asarray(j_fir.partition_fir_spectra(taps, parsiz)))


def test_constants_from_jax_rejects_unknown():
    with pytest.raises(KeyError):
        constants_from_jax({"weights": np.zeros(3, np.float32)})
    with pytest.raises(ValueError):
        constants_from_jax({"fir_spectra": np.zeros((2, 3), np.float32)})
