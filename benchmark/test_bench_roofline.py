"""The bound arithmetic on known shapes, against the bounds of PERF.md's
kernel table (the 4-minute stereo file at blksiz 8192: 11,520,000
samples, 1,407 blocks)."""

import numpy as np
import pytest

import bench_tiny  # noqa: F401
from harness import roofline
from reference.dsp import cos_sin_table


def test_canonical_table_operations():
    assert roofline.sweep_flops_per_sample(cos_sin_table()) == 1082


def test_sweep_bound_at_the_4_minute_shape():
    n = 1407 * 8192  # aligned pairs of 1,407 blocks plus the flush
    fps = roofline.sweep_flops_per_sample(cos_sin_table())
    ms = roofline.sweep_bound_ms(2, n, 360, fps)
    assert round(ms, 4) == 0.3723


def test_hilbert_small_bound_at_the_4_minute_shape():
    n = 4 * 60 * 48000
    ms = roofline.conv_bound_ms(2, n, 1408 * 8192, 8192)
    assert round(ms, 4) == 0.0581
    flops = roofline.fir_conv_flops(2, n, 8192, 0)
    assert flops == pytest.approx(2 * 1407 * (2 * 5 * 8192 * 13 + 64 * 4096
                                              + 6 * 8192 + 8192))


def test_stream_mix_bound_of_the_stems():
    # 64 mono 60 s stems through the plugin FIR (3072 taps, 3 mix ops)
    ms = roofline.conv_bound_ms(64, 60 * 48000, 60 * 48000, 3072, 3)
    assert round(ms, 4) == 0.4462


def test_bound_picks_the_larger_side():
    assert roofline.bound_ms(3.35e9, 0) == pytest.approx(1.0)
    assert roofline.bound_ms(0, 67e9) == pytest.approx(1.0)
    assert roofline.bound_ms(3.35e9, 134e9) == pytest.approx(2.0)


def test_mirror_pairs_need_exact_bits():
    cs = cos_sin_table()
    cs2 = cs.copy()
    cs2[0, 1:] = np.nextafter(cs2[0, 1:], np.float32(2))
    assert roofline.sweep_flops_per_sample(cs2) > 1082
