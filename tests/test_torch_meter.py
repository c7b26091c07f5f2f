"""The port's meter ballistics against the JAX package's, block by block,
in tests/test_meter.py's scenarios (1e-6)."""

import jax
import numpy as np
import pytest
import torch

from phaserotate_tpu import meter as jm
from phaserotate_tpu_torch import meter as pm
from phaserotate_tpu_torch.core.convert import (
    meter_state_from_jax,
    meter_state_to_jax,
)

torch.set_num_threads(1)

RATE = 48000.0
LAT = 1792
N = 256
_FIELDS = ("in_cur", "in_mom", "in_peak", "out_cur", "out_mom", "out_peak",
           "diff_cur", "diff_min", "diff_max")


def _run_both(blocks_in, blocks_out, changed=None, channels=()):
    """Meter the same blocks with both packages; returns the per-block
    levels of each as (n_blocks, 9, ...) arrays and the final states."""
    jcfg = jm.MeterConfig(rate=RATE, latency=LAT)
    pcfg = pm.MeterConfig(rate=RATE, latency=LAT)
    assert jcfg.hold_samples == pcfg.hold_samples
    jfall = jm.meter_falloff(RATE, N)
    pfall = pm.meter_falloff(RATE, N)
    np.testing.assert_allclose(pfall.item(), float(jfall), rtol=1e-7)
    js = jm.init_meter_state(jcfg, channels)
    ps = pm.init_meter_state(pcfg, channels)
    jl, pl = [], []
    for i, (bi, bo) in enumerate(zip(blocks_in, blocks_out)):
        ac = False if changed is None else changed[i]
        if channels:
            js, lv = jax.vmap(lambda s, a, b, c: jm.meter_block(
                s, a, b, jfall, jcfg.hold_samples, c))(
                js, bi, bo, np.broadcast_to(ac, channels))
        else:
            js, lv = jm.meter_block(js, bi, bo, jfall, jcfg.hold_samples, ac)
        jl.append([np.asarray(getattr(lv, f)) for f in _FIELDS])
        ps, lv = pm.meter_block(ps, torch.from_numpy(bi),
                                torch.from_numpy(bo), pfall,
                                pcfg.hold_samples, ac)
        pl.append([getattr(lv, f).numpy() for f in _FIELDS])
    return np.asarray(jl), np.asarray(pl), js, ps


def _check(jl, pl, js, ps):
    np.testing.assert_allclose(pl, jl, atol=1e-6, rtol=1e-6)
    jd = {f: np.asarray(getattr(js, f)) for f in (
        "momentary", "peak", "holdcnt", "diff", "reset_delay", "dly")}
    pd = meter_state_to_jax(ps)
    for f, v in jd.items():
        np.testing.assert_allclose(pd[f], v, atol=1e-6, rtol=1e-6,
                                   err_msg=f)
        assert pd[f].dtype == v.dtype, f


def _z():
    return np.zeros(N, np.float32)


def test_rise_and_hold():
    blocks = [_z() for _ in range(40)]
    blocks[10] = np.full(N, 0.8, np.float32)
    jl, pl, js, ps = _run_both(blocks, blocks)
    _check(jl, pl, js, ps)
    assert pl[10][4] == pytest.approx(0.8)
    assert pl[39][4] == pytest.approx(0.8)  # still holding


def test_fall_15db_per_second():
    warm = LAT // N + 1
    hold_blocks = int(pm.MeterConfig(RATE, LAT).hold_samples / N) + 2
    blocks = [_z()] * (warm + 1 + hold_blocks + 200)
    blocks = list(blocks)
    blocks[warm] = np.full(N, 1.0, np.float32)
    jl, pl, js, ps = _run_both(blocks, blocks)
    _check(jl, pl, js, ps)
    got_db = 20 * np.log10(pl[-1][4])
    assert got_db == pytest.approx(-15.0 * 200 * N / RATE, abs=0.75)


def test_peak_hold_and_reset():
    blocks = [_z() for _ in range(120)]
    blocks[2] = np.full(N, 0.9, np.float32)
    jl, pl, js, ps = _run_both(blocks, blocks)
    _check(jl, pl, js, ps)
    assert pl[-1][5] == pytest.approx(0.9)
    pr = pm.reset_peaks(ps)
    jr = jm.reset_peaks(js)
    assert pr.peak[1].item() == 0.0 and pr.diff[0].item() == 1.0
    np.testing.assert_array_equal(pr.momentary.numpy(),
                                  np.asarray(jr.momentary))


def test_input_alignment():
    spike = 3
    blocks_in = [_z() for _ in range(40)]
    blocks_in[spike] = np.full(N, 0.7, np.float32)
    jl, pl, js, ps = _run_both(blocks_in, [_z()] * 40)
    _check(jl, pl, js, ps)
    first = next(i for i, lv in enumerate(pl) if lv[0] > 0)
    assert first == spike + LAT // N


def test_diff_ratio_and_delayed_reset():
    half = np.full(N, 0.5, np.float32)
    quarter = np.full(N, 0.25, np.float32)
    tenth = np.full(N, 0.1, np.float32)
    blocks_in = [half] * 60 + [half] * 260 + [half] * 30
    blocks_out = [quarter] * 60 + [tenth] * 260 + [quarter] * 30
    changed = [False] * 320 + [True] + [False] * 29
    jl, pl, js, ps = _run_both(blocks_in, blocks_out, changed)
    _check(jl, pl, js, ps)
    assert pl[59][6] == pytest.approx(0.5, rel=1e-5)
    assert pl[319][7] == pytest.approx(0.2, rel=2e-2)
    assert pl[-1][7] == pytest.approx(0.5, rel=1e-5)


def test_nonfinite_guard():
    blocks = [_z() for _ in range(LAT // N + 3)]
    blocks[-2] = np.full(N, np.nan, np.float32)
    blocks[-1] = np.full(N, np.inf, np.float32)
    jl, pl, js, ps = _run_both(blocks, blocks)
    _check(jl, pl, js, ps)
    assert pl[-2][3] == 0.0 and np.isfinite(pl[-1]).all()


def test_channels_in_one_call(rng):
    """Leading channel dims in one call equal the JAX package's vmap."""
    blocks_in = [(0.5 * rng.standard_normal((2, N))).astype(np.float32)
                 for _ in range(20)]
    blocks_out = [(0.3 * rng.standard_normal((2, N))).astype(np.float32)
                  for _ in range(20)]
    changed = [np.asarray([i == 9, i == 12]) for i in range(20)]
    jl, pl, js, ps = _run_both(blocks_in, blocks_out, changed, (2,))
    _check(jl, pl, js, ps)


def test_meter_state_from_jax_round_trip(rng):
    js = jm.init_meter_state(jm.MeterConfig(RATE, LAT), (2,))
    bi = (0.5 * rng.standard_normal((2, N))).astype(np.float32)
    js, _ = jax.vmap(lambda s, a: jm.meter_block(
        s, a, a, jm.meter_falloff(RATE, N), 24000, True))(js, bi)
    arrays = {f: np.asarray(getattr(js, f)) for f in (
        "momentary", "peak", "holdcnt", "diff", "reset_delay", "dly")}
    ps = meter_state_from_jax(arrays)
    assert ps.holdcnt.dtype == torch.int32 and ps.dly.shape == (2, LAT)
    back = meter_state_to_jax(ps)
    for f, v in arrays.items():
        np.testing.assert_array_equal(back[f], v)


@pytest.mark.parametrize("channels", [(), (2,)], ids=["mono", "stereo"])
def test_host_twins_bit_equal_to_the_torch_meters(channels):
    """host_meter_state / host_meter_block / host_reset_peaks (numpy, the
    plugin's host meters) give the torch functions' bits: every level and
    every state field, over block sizes 0-2048, loud and quiet input, an
    inf sample, angle changes and peak resets."""
    import dataclasses

    cfg = pm.MeterConfig(rate=RATE, latency=LAT)
    ts = pm.init_meter_state(cfg, channels, "cpu")
    ns = pm.host_meter_state(cfg, channels)
    rng = np.random.default_rng(77)
    for i in range(120):
        n = (1024, 333, 96, 0, 2048)[i % 5]
        gain = (0.5, 1e-4)[i // 30 % 2]
        x = (gain * rng.standard_normal((*channels, n))).astype(np.float32)
        y = (0.3 * rng.standard_normal((*channels, n))).astype(np.float32)
        if i % 17 == 3 and n:
            x[..., 0] = np.inf
        changed = rng.random(channels) < 0.1
        fall = pm.meter_falloff(RATE, n)
        ts, tl = pm.meter_block(ts, torch.from_numpy(x), torch.from_numpy(y),
                                fall, cfg.hold_samples,
                                torch.from_numpy(np.asarray(changed)))
        ns, nl = pm.host_meter_block(ns, x, y, fall.item(), cfg.hold_samples,
                                     changed)
        if i % 41 == 40:
            ts, ns = pm.reset_peaks(ts), pm.host_reset_peaks(ns)
        for f in _FIELDS:
            a, b = getattr(tl, f).numpy(), np.asarray(getattr(nl, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, f)
        for f in dataclasses.fields(pm.MeterState):
            a, b = getattr(ts, f.name).numpy(), getattr(ns, f.name)
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, f.name)
