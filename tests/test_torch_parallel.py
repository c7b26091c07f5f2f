"""The port's ``parallel`` package against the JAX package's on the same
mesh shapes, and against the port's own unsharded functions.

The port's mesh is one process over a grid of ``torch.device``s, here
``["cpu"] * 8``; the JAX side runs on the conftest's 8 virtual CPU
devices.  Tolerances: peak tables 2e-5 and audio 1e-5 against JAX (two FFT
libraries, float32 roundoff of the convolution); files and angle sharding
are bit-equal to the port's unsharded run (the same arithmetic per row),
sample sharding within 2e-5 (the convolution is framed at other offsets).
"""

import jax
import numpy as np
import pytest
import torch

from phaserotate_tpu import parallel as j_par
from phaserotate_tpu.core.sizes import OfflineGeometry as JGeom
from phaserotate_tpu_torch.core.angles import MAXSAMPLE
from phaserotate_tpu_torch.core.sizes import OfflineGeometry
from phaserotate_tpu_torch.ops.rotate import rotate_fir
from phaserotate_tpu_torch.parallel import (
    Mesh,
    angle_sharded_sweep_peaks,
    batch_find_min_peak_angles,
    batch_rotate,
    batch_sweep_peaks,
    file_mesh,
    grid_mesh,
    shard_files,
    sharded_rotate,
    sharded_sweep_peaks,
)
from phaserotate_tpu_torch.search import find_min_peak_angle, sweep_peaks_aux

torch.set_num_threads(1)

GEOM = OfflineGeometry(blksiz=1024)
JGEOM = JGeom(blksiz=1024)
CPUS = ["cpu"] * 8


@pytest.fixture(scope="module")
def mesh():
    return file_mesh(8, devices=CPUS)


@pytest.fixture(scope="module")
def j_mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return j_par.file_mesh(8)


def _signals(files, n, rate=48000.0):
    t = np.arange(n) / rate
    return np.stack([
        (0.6 * np.sin(2 * np.pi * (300 + 37 * i) * t + i)
         + 0.4 * np.sin(2 * np.pi * (700 + 11 * i) * t)).astype(np.float32)
        for i in range(files)
    ])


def _noise(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=0)


# ---- the mesh --------------------------------------------------------------


def test_mesh_shapes_and_shards(mesh):
    assert mesh.axis_names == ("files",) and mesh.shape == {"files": 8}
    assert all(d == torch.device("cpu") for d in mesh.devices)
    m2 = grid_mesh(2, 4, devices=CPUS)
    assert m2.axis_names == ("files", "samples")
    assert m2.shape == {"files": 2, "samples": 4}
    assert m2.grid("files", "samples").shape == (2, 4)
    assert m2.grid("samples", "files").shape == (4, 2)
    assert m2.grid(None, "samples").shape == (1, 4)
    assert file_mesh(devices=["cpu"] * 3).shape == {"files": 3}
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    shards = shard_files(x, mesh)
    assert len(shards) == 8 and all(s.shape == (2, 3) for s in shards)
    assert np.array_equal(torch.cat(shards).numpy(), x)
    assert len(shard_files(x, m2)) == 2
    with pytest.raises(ValueError, match="divide"):
        shard_files(x[:9], mesh)
    with pytest.raises(ValueError, match="axis"):
        mesh.grid(None, "samples")
    with pytest.raises(ValueError, match="axis names"):
        Mesh(mesh.devices, ("files", "samples"))


def test_mesh_raises_on_insufficient_devices():
    """Silently shrinking the mesh would mis-shard the fleet: the raises
    of the JAX package's file_mesh and grid_mesh."""
    with pytest.raises(ValueError, match="device"):
        file_mesh(99, devices=CPUS)
    with pytest.raises(ValueError, match="device"):
        grid_mesh(16, 16, devices=CPUS)
    with pytest.raises(ValueError, match="device"):
        j_par.file_mesh(99)
    with pytest.raises(ValueError, match="device"):
        j_par.grid_mesh(16, 16)


@pytest.mark.parametrize("make", [file_mesh, lambda: file_mesh(2),
                                  lambda: grid_mesh(1, 1)])
def test_mesh_without_devices_needs_a_card(make):
    """Never a quiet CPU mesh."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default mesh exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


# ---- files sharding --------------------------------------------------------


@pytest.mark.parametrize("rate,n,stereo", [(48000.0, 4096, False),
                                           (96000.0, 9600, True)])
def test_batch_rotate(mesh, j_mesh, rate, n, stereo):
    x = _signals(8, n, rate)
    degs = np.linspace(-120, 120, 8).astype(np.float32)
    if stereo:  # (files, 2, n) stems at independent per-channel angles
        x = np.stack([x, x[::-1]], axis=1)
        degs = np.random.default_rng(4).uniform(
            -180, 180, (8, 2)).astype(np.float32)
    y = batch_rotate(x, degs, mesh, rate=rate)
    assert y.shape == x.shape and y.device.type == "cpu"
    assert torch.equal(y, rotate_fir(x, degs, rate=rate, device="cpu"))
    _close(y, j_par.batch_rotate(x, degs, j_mesh, rate=rate), 1e-5)


def test_batch_sweep_peaks(mesh, j_mesh):
    x = _signals(8, 3000)[:, None, :]  # (files, 1 chn, n)
    tables, rot0 = batch_sweep_peaks(x, GEOM, mesh)
    want_t, want_r = sweep_peaks_aux(x, GEOM, device="cpu")
    assert tables.shape == (8, 1, MAXSAMPLE) and rot0.shape == (8, 1)
    assert torch.equal(tables, want_t) and torch.equal(rot0, want_r)
    j_t, j_r = j_par.batch_sweep_peaks(x, JGEOM, j_mesh)
    _close(tables, j_t, 2e-5)
    _close(rot0, j_r, 2e-5)


@pytest.mark.parametrize("max_files", [None, 8, 3])
def test_batch_find_min_peak_angles(mesh, j_mesh, max_files):
    """11 files do not divide over the mesh: the last slice is padded; the
    chunked run equals the one-dispatch run, the per-file search and the
    JAX package's angles."""
    x = _signals(11, 3000)[:, None, :]
    got = batch_find_min_peak_angles(x, GEOM, mesh,
                                     max_files_per_call=max_files)
    assert len(got) == 11
    want = j_par.batch_find_min_peak_angles(
        x, JGEOM, j_mesh, max_files_per_call=max_files)
    for i in range(11):
        single = find_min_peak_angle(x[i], rate=48000, blksiz=GEOM.blksiz,
                                     device="cpu")
        assert got[i].angles_units == single.angles_units
        assert got[i].angles_units == want[i].angles_units
        assert got[i].found == want[i].found


def test_batch_find_min_peak_angles_link_and_stride(mesh):
    x = np.stack([_signals(8, 3000), _signals(8, 3000)[::-1]], axis=1)
    got = batch_find_min_peak_angles(x, GEOM, mesh, stride=12,
                                     link_channels=True)
    for i in range(8):
        single = find_min_peak_angle(x[i], rate=48000, stride=12,
                                     link_channels=True,
                                     blksiz=GEOM.blksiz, device="cpu")
        assert got[i].angles_units == single.angles_units


# ---- samples sharding ------------------------------------------------------


@pytest.mark.parametrize("n", [6 * GEOM.parsiz, 40000, 700])
def test_sharded_sweep_peaks(mesh, j_mesh, n):
    """Halo copy + maximum over 8 sample shards == the single-device sweep:
    6 blocks (with flush 7, padded to 8 shards), a length that is not
    block aligned, and one shorter than a block (7 shards of zeros)."""
    x = _signals(1, n)[0]
    peaks, rot0 = sharded_sweep_peaks(x, GEOM, mesh, axis="files")
    assert peaks.shape == (MAXSAMPLE,) and rot0.ndim == 0
    want, want_r = sweep_peaks_aux(x[None], GEOM, device="cpu")
    _close(peaks, want[0], 2e-5)
    _close(rot0, want_r[0], 2e-5)
    assert float(peaks[0]) == float(np.abs(x).max())  # slot 0: raw peak
    j_p, j_r = j_par.sharded_sweep_peaks(x, JGEOM, j_mesh, axis="files")
    _close(peaks, j_p, 2e-5)
    _close(rot0, j_r, 2e-5)


def test_sharded_sweep_peaks_2d_mesh():
    """files x samples: sequence parallelism composed with data
    parallelism matches the per-file unsharded sweeps."""
    mesh2 = grid_mesh(2, 4, devices=CPUS)
    n = 4 * 4 * GEOM.parsiz - 333
    x = _signals(2, n)
    peaks, rot0 = sharded_sweep_peaks(x, GEOM, mesh2, axis="samples",
                                      file_axis="files")
    want, want_r = sweep_peaks_aux(x, GEOM, device="cpu")
    _close(peaks, want, 2e-5)
    _close(rot0, want_r, 2e-5)
    j_p, j_r = j_par.sharded_sweep_peaks(
        x, JGEOM, j_par.grid_mesh(2, 4), axis="samples", file_axis="files")
    _close(peaks, j_p, 2e-5)
    _close(rot0, j_r, 2e-5)
    # the files replicated over the other axis: 4 sample shards of both
    p1, r1 = sharded_sweep_peaks(x, GEOM, mesh2, axis="samples")
    assert torch.equal(p1, peaks) and torch.equal(r1, rot0)


def test_sharded_sweep_takes_rot0_before_slot_0_is_overwritten(mesh):
    """A signal whose raw peak lies before the aligned region (the first
    firlen samples pair with nothing at angle 0): rot0 is the maximum
    over the shards of the aligned peak, not the raw peak of slot 0."""
    x = np.zeros(5 * GEOM.parsiz, np.float32)
    x[100] = 0.9
    x[-3] = 0.25
    peaks, rot0 = sharded_sweep_peaks(x, GEOM, mesh, axis="files")
    want, want_r = sweep_peaks_aux(x[None], GEOM, device="cpu")
    assert float(peaks[0]) == np.float32(0.9) and float(rot0) < 0.5
    _close(peaks, want[0], 2e-5)
    _close(rot0, want_r[0], 2e-5)


def test_sharded_rotate(mesh, j_mesh):
    """Two-sided halos == rotate_fir on the whole signal, zero-padded
    edges included; n is not mesh-divisible."""
    x = _noise(8 * 6000 - 777, 1)
    got = sharded_rotate(x, 35.0, mesh, firlen=3072, axis="files")
    assert got.shape == x.shape and got.device.type == "cpu"
    _close(got, rotate_fir(x, 35.0, firlen=3072, device="cpu"), 1e-5)
    _close(got, j_par.sharded_rotate(x, 35.0, j_mesh, firlen=3072,
                                     axis="files"), 1e-5)


def test_sharded_rotate_2d_mesh():
    """files x samples composition: per-file angles, samples halo."""
    mesh2 = grid_mesh(2, 4, devices=CPUS)
    x = _noise((2, 4 * 7000 + 123), 2)
    degs = np.array([35.0, -120.0], np.float32)
    got = sharded_rotate(x, degs, mesh2, firlen=3072, axis="samples",
                         file_axis="files")
    _close(got, rotate_fir(x, degs, firlen=3072, device="cpu"), 1e-5)
    _close(got, j_par.sharded_rotate(
        x, degs, j_par.grid_mesh(2, 4), firlen=3072, axis="samples",
        file_axis="files"), 1e-5)


def test_sharded_rotate_shard_too_small(mesh, j_mesh):
    with pytest.raises(ValueError, match="halo"):
        sharded_rotate(np.zeros(4000, np.float32), 0.0, mesh, firlen=3072,
                       axis="files")
    with pytest.raises(ValueError, match="halo"):
        j_par.sharded_rotate(np.zeros(4000, np.float32), 0.0, j_mesh,
                             firlen=3072, axis="files")


# ---- angle sharding --------------------------------------------------------


@pytest.mark.parametrize("n_dev", [8, 3, 2])
def test_angle_sharded_sweep_peaks(n_dev):
    """Slices of 45, 120 and 180 angles concatenate into exactly the
    unsharded table."""
    mesh_n = file_mesh(n_dev, devices=CPUS)
    x = _noise((2, 5000), 3)
    got, rot0 = angle_sharded_sweep_peaks(x, GEOM, mesh_n, axis="files")
    want, want_r = sweep_peaks_aux(x, GEOM, device="cpu")
    assert torch.equal(got, want) and torch.equal(rot0, want_r)
    g1, r1 = angle_sharded_sweep_peaks(x[0], GEOM, mesh_n, axis="files")
    assert torch.equal(g1, want[0]) and torch.equal(r1, want_r[0])
    j_t, j_r = j_par.angle_sharded_sweep_peaks(
        x, JGEOM, j_par.file_mesh(n_dev), axis="files")
    _close(got, j_t, 2e-5)
    _close(rot0, j_r, 2e-5)


def test_angle_sharded_sweep_needs_a_divisor_of_the_table():
    x = _noise((1, 3000), 5)
    with pytest.raises(ValueError, match="divisible"):
        angle_sharded_sweep_peaks(x, GEOM, file_mesh(7, devices=CPUS),
                                  axis="files")
    with pytest.raises(ValueError, match="divisible"):
        j_par.angle_sharded_sweep_peaks(x, JGEOM, j_par.file_mesh(7),
                                        axis="files")
