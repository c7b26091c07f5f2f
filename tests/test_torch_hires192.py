"""24-bit / 192 kHz masters on the port's analysis path, on the CPU.

At 176.4 and 192 kHz the CLI's blksiz is its largest, 32768: one FIR
partition of 32768 taps at an FFT length of 65,536, which
``search.sweep.hilbert_offline`` hands to ``kernels/hilbert32k.py``
(``hilbert_32k``; its plain twin here, the ``partitioned_convolve``
route) under the span ``hilbert.one_partition``.  The tables and angles
of ``sweep_peaks_aux`` on seeded stereo masters on the 2^23 grid agree
with the benchmark's float64 reference (``benchmark/reference/
offline.py``) within the judge's limits; the twin is the linear
convolution with the FIR; ``apply_angles`` mixes with it; and the
benchmark's two readers of the span read hand-made records (the span
itself: ``tests/test_torch_profiling.py``).
"""

import importlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from phaserotate_tpu_torch.core.fir import (design_hilbert_fir,
                                            offline_fir_spectrum)
from phaserotate_tpu_torch.core.sizes import OfflineGeometry, offline_geometry
from phaserotate_tpu_torch.kernels import _build
from phaserotate_tpu_torch.kernels.hilbert32k import (BLKSIZ, hilbert_32k,
                                                      hilbert_32k_plain,
                                                      out_len)
from phaserotate_tpu_torch.ops.convolve import partitioned_convolve
from phaserotate_tpu_torch.search import (apply_angles,
                                          select_min_peak_angles_batch,
                                          sweep_peaks_aux)
from phaserotate_tpu_torch.search.sweep import hilbert_offline

torch.set_num_threads(1)

RATE = 192000
FULL = 1 << 23
GEOM = OfflineGeometry(BLKSIZ)
REPO = Path(__file__).resolve().parents[1]


def _reference():
    """``benchmark/reference/offline.py``, imported as a package of its
    own name."""
    name = "bench_reference"
    if name not in sys.modules:
        root = REPO / "benchmark" / "reference"
        spec = importlib.util.spec_from_file_location(
            name, root / "__init__.py", submodule_search_locations=[str(root)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.offline")


def _master(seed, n, channels=2):
    """(channels, n) float32 on the 24-bit grid: partials, a slow swell and
    a little noise, peaking at -1 to -0.1 dBFS."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / RATE
    x = np.stack([
        0.6 * np.sin(2 * np.pi * rng.uniform(60, 900) * t + rng.uniform(0, 6))
        + 0.3 * np.sin(2 * np.pi * rng.uniform(900, 9000) * t)
        + 0.05 * rng.standard_normal(n) for _ in range(channels)])
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t) ** 2
    peak = 10.0 ** (rng.uniform(-1.0, -0.1) / 20.0)
    q = np.rint(x * (peak * FULL / np.abs(x).max()))
    return torch.from_numpy((q / FULL).astype(np.float32))


def test_geometry_of_192k_and_176k():
    assert offline_geometry(192000).blksiz == BLKSIZ
    assert offline_geometry(176400).blksiz == BLKSIZ


# lengths: shorter than a block; a block and a bit; 2.6 s, none a
# multiple of 32768
@pytest.mark.parametrize("n", [19201, 40000, 500003])
def test_sweep_agrees_with_the_reference(n):
    """Tables (and rot0) within the judge's 1e-4 of the float64 reference
    as a share of each channel's largest entry, the input peaks exact, and
    the reference's chosen angles at stride 12 degrees, channels not
    linked (the configuration ``cli_192k24``)."""
    offline = _reference()
    x = _master(n, n)
    table, rot0 = (t.numpy() for t in sweep_peaks_aux(x, GEOM, device="cpu"))
    ref_table, ref_rot0 = offline.peak_table(x.to(torch.float64), BLKSIZ)
    scale = ref_table.max(axis=-1)
    assert (np.abs(table - ref_table).max(axis=-1) / scale).max() < 1e-4
    assert (np.abs(rot0 - ref_rot0) / scale).max() < 1e-4
    assert np.array_equal(table[:, 0], ref_table[:, 0])
    got = select_min_peak_angles_batch(table[None], stride=24,
                                       link_channels=False,
                                       rot0=rot0[None])[0]
    want = offline.select_angles(ref_table[None], ref_rot0[None], 24,
                                 False)[0]
    assert list(got.angles_units) == list(want["units"])
    assert list(got.found) == list(want["found"])


@pytest.mark.parametrize("shape", [(1,), (3, 1), (2, 32768), (2, 70001),
                                   (2, 2, 40000)])
def test_twin_is_the_partitioned_convolution(shape):
    """On the CPU the wrapper is its twin, and the twin is today's
    ``partitioned_convolve`` route cut to (B+1) blocks, bit for bit;
    ``hilbert_offline`` returns it at blksiz 32768."""
    x = _master(sum(shape), shape[-1], int(np.prod(shape[:-1]))).reshape(
        shape)
    want = partitioned_convolve(
        x, offline_fir_spectrum(GEOM)[None], BLKSIZ)[..., :out_len(
            x.shape[-1])]
    got = hilbert_32k(x)
    assert got.shape == (*x.shape[:-1], out_len(x.shape[-1]))
    assert torch.equal(got, want)
    assert torch.equal(hilbert_32k_plain(x), want)
    assert torch.equal(hilbert_offline(x, GEOM), want)


def test_twin_is_the_linear_convolution():
    """Against the 32768-tap FIR convolved in float64 by numpy, within
    float32 roundoff; the flush block holds the convolution's tail and
    nothing after it."""
    x = _master(7, 50000, 2)
    fir = design_hilbert_fir(BLKSIZ).numpy().astype(np.float64)
    h = hilbert_32k(x).numpy()
    assert h.shape == (2, 3 * BLKSIZ)
    for c in range(2):
        full = np.convolve(x[c].numpy().astype(np.float64), fir)
        want = np.zeros(h.shape[-1])
        k = min(len(full), len(want))
        want[:k] = full[:k]
        assert np.abs(h[c] - want).max() < 1e-5


def test_empty_rows_give_the_flush_block():
    h = hilbert_32k(torch.zeros(2, 0))
    assert h.shape == (2, BLKSIZ) and not h.any()


def test_refuses_other_devices():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        hilbert_32k(torch.zeros(2, 10, device="meta"))


def test_apply_angles_at_32768():
    """``y[m] = cos*x[m] + sin*h[m + 16384]`` with the twin's h, the same
    length as the input, and no kernel launched on the CPU."""
    from phaserotate_tpu_torch.core.angles import MAXSAMPLE, sincos_lut

    x = _master(9, 90001, 2)
    _build.reset_launches()
    y = apply_angles(x, [70, -130], GEOM, device="cpu")
    assert _build.launches["hilbert_32k"] == 0
    assert y.shape == x.shape
    h = hilbert_32k_plain(x)
    sin_t, cos_t = sincos_lut(x.device)
    a = torch.tensor([70, MAXSAMPLE - 130])
    want = (cos_t[a][:, None] * x
            + sin_t[a][:, None] * h[:, 16384:16384 + x.shape[-1]])
    assert torch.equal(y, want)
    assert torch.equal(apply_angles(x, [0, 0], GEOM, device="cpu"), x)


def _product_item(z, h, wp, m, u, off):
    """csrc/ola_fft.cuh ``product_item`` in float64 numpy: item ``u`` of
    the position-order walk, on ``z`` holding positions [off, ...)."""
    half = m // 2
    pk = pmk = 0
    if u == half:
        pk = pmk = 1
    elif u != 0:
        hb = 1 << (u.bit_length() - 1)
        flip = 2 * hb - 1
        pk = u + hb
        if pk & 1:
            pk ^= flip
        pmk = pk ^ flip
    a, b = z[pk - off], np.conj(z[pmk - off])
    e, o = 0.5 * (a + b), -0.5j * (a - b)
    w = wp[u]
    if u == 0:
        yk, ymk = (e + o).real * h[0].real, (e - o).real * h[m].real
    else:
        yk, ymk = (e + w * o) * h[pk], np.conj(e - w * o) * h[pmk]
    p, t = yk + np.conj(ymk), np.conj(w) * (yk - np.conj(ymk))
    z[pk - off] = (p + 1j * t) / (2 * m)
    if pmk != pk:
        z[pmk - off] = (np.conj(p) + 1j * np.conj(t)) / (2 * m)


def test_cluster_split_is_the_one_partition_frame():
    """csrc/hilbert32k.cu's split of one frame over its two blocks, in
    numpy with the wrapper's own tables: block 0 keeps z[p], block 1
    z[p] W_M^p; each half's transform, in bit-reversed positions; block 0
    takes items [0, M/4) and M/2 of the product walk, block 1 [M/4, M/2);
    each half's inverse; the head s_0 + conj(W_M^p) s_1 and the tail
    s_0 - conj(W_M^p) s_1.  Equal to irfft(rfft(pad(x, N)) * H) within
    float32 rounding of the tables."""
    from phaserotate_tpu_torch.kernels import hilbert32k as hk
    from phaserotate_tpu_torch.kernels.fused_conv import _bitrev

    m, half = BLKSIZ, BLKSIZ // 2
    _, w_split, spec, wp = hk._tables(torch.device("cpu"))
    w_split = w_split.double().numpy() @ np.array([1, 1j])
    h = spec.double().numpy() @ np.array([1, 1j])
    wp = wp.double().numpy() @ np.array([1, 1j])
    x = np.random.default_rng(3).standard_normal(m)
    z = x[0::2] + 1j * x[1::2]
    br = _bitrev(np.arange(half), 14)
    halves = [np.fft.fft(a)[br] for a in (z, z * w_split)]
    for rank, zl in enumerate(halves):
        items = [*range(rank * m // 4, (rank + 1) * m // 4)]
        for u in items + ([m // 2] if rank == 0 else []):
            _product_item(zl, h, wp, m, u, rank * half)
    s0, s1 = (np.fft.ifft(zl[np.argsort(br)]) * half for zl in halves)
    y = np.concatenate([s0 + np.conj(w_split) * s1,
                        s0 - np.conj(w_split) * s1])
    got = np.stack([y.real, y.imag], axis=-1).reshape(-1)
    spectrum = offline_fir_spectrum(GEOM).numpy().astype(np.complex128)
    want = np.fft.irfft(np.fft.rfft(x, 2 * m) * spectrum, 2 * m)
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


def _readers(monkeypatch):
    """The benchmark's two readers of the span, loaded as the harness
    loads them."""
    monkeypatch.syspath_prepend(str(REPO / "benchmark"))
    from harness.spec import metric_reader

    return {name: metric_reader(name) for name in (
        "hilbert_32k_roofline.search", "hilbert_32k_ms_per_batch")}


def test_benchmark_readers_read_the_span(monkeypatch):
    """On hand-made records: the mean device ms of the spans, and their
    summed ``conv_bound_ms(rows, n, n_out, 32768)`` over the
    ``hilbert32k`` kernels' device time in the window (the runs and the
    fix-up, clipped to the window), or over the spans' where the trace
    holds none; records outside the window are dropped; no span, no
    reading."""
    readers = _readers(monkeypatch)
    from harness import program
    from harness.roofline import conv_bound_ms
    from harness.trace import Trace

    ms = 1_000_000
    w0 = 10_000 * ms
    n = 4096 * BLKSIZ
    attrs = dict(rows=14, n=n, n_out=n + BLKSIZ)
    recs = [("hilbert.one_partition", "MainThread", w0 + 100 * ms,
             w0 + 101 * ms, dict(attrs, device_ms=30.0)),
            ("hilbert.one_partition", "MainThread", w0 + 200 * ms,
             w0 + 201 * ms, dict(attrs, device_ms=34.0)),
            ("hilbert.one_partition", "MainThread", w0 - 5 * ms,
             w0 + 1 * ms, dict(attrs, device_ms=99.0)),
            ("search.select", "MainThread", w0 + 300 * ms, w0 + 301 * ms,
             {})]
    monkeypatch.setattr(program, "_drain", lambda: list(recs))
    bound = conv_bound_ms(14, n, n + BLKSIZ, BLKSIZ)
    assert 5.0 < bound < 7.0
    kernels = [("hilbert32k_runs", w0 - 10 * ms, w0 + 20 * ms),
               ("hilbert32k_fixup", w0 + 20 * ms, w0 + 21 * ms),
               ("(anonymous namespace)::hilbert32k_runs", w0 + 200 * ms,
                w0 + 233 * ms),
               ("void sweep_kernel<9>(...)", w0 + 300 * ms, w0 + 350 * ms)]
    traced = Trace(device=kernels, window=(w0, w0 + 1000 * ms))
    assert readers["hilbert_32k_ms_per_batch"](traced) == pytest.approx(32.0)
    assert readers["hilbert_32k_roofline.search"](traced) == pytest.approx(
        100 * 2 * bound / 54.0)
    events_only = Trace(window=(w0, w0 + 1000 * ms))
    assert readers["hilbert_32k_roofline.search"](
        events_only) == pytest.approx(100 * 2 * bound / 64.0)
    monkeypatch.setattr(program, "_drain", lambda: [])
    for read in readers.values():
        assert read(Trace(window=(w0, w0 + 1000 * ms))) is None
