"""The plain reference against the port's plain CPU path at a small size,
and the control: the reference in bfloat16 in the program's place must
fail the limits that a sound run passes."""

import numpy as np
import pytest
import torch

import bench_tiny  # noqa: F401
from harness import judge
from harness.signals import music_device, music_host
from reference import dsp, offline, stream


def _songs(seed, count=3, seconds=(2.3, 3.1, 4.7), rate=48000):
    out = []
    for i in range(count):
        x, _ = music_device(seed, i, 2, int(seconds[i] * rate), rate,
                            (-1.0, -0.1), torch.device("cpu"))
        out.append(x)
    return out


def test_fir_and_tables_match_the_port():
    from phaserotate_tpu_torch.core.angles import all_angle_cos_sin
    from phaserotate_tpu_torch.core.fir import design_hilbert_fir

    for taps in (3072, 8192):
        assert np.array_equal(dsp.hilbert_fir(taps),
                              design_hilbert_fir(taps).numpy())
    assert np.array_equal(dsp.cos_sin_table(), all_angle_cos_sin().numpy())
    for rate in (44100, 48000, 96000, 192000):
        assert dsp.cli_blksiz(rate) == __import__(
            "phaserotate_tpu_torch.core.sizes", fromlist=["x"]
        ).default_blksiz(rate)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7])
def test_peak_tables_and_angles_match_the_port(seed):
    from phaserotate_tpu_torch.core.sizes import offline_geometry
    from phaserotate_tpu_torch.search import (
        select_min_peak_angles_batch, sweep_peaks_aux)

    geom = offline_geometry(48000)
    rows, ref = [], {}
    for i, x in enumerate(_songs(seed)):
        t, r0 = sweep_peaks_aux(x, geom, device="cpu")
        res = select_min_peak_angles_batch(t[None].numpy(),
                                           rot0=r0[None].numpy())[0]
        rows.append(dict(key=i, table=t.numpy(), rot0=r0.numpy(),
                         units=res.angles_units, found=res.found))
        rt, rr0 = offline.peak_table(x.double(), geom.blksiz)
        sel = offline.select_angles(rt[None], rr0[None], 24, False)[0]
        ref[i] = dict(table=rt, rot0=rr0, **{"units": sel["units"],
                                              "found": sel["found"]})
    numbers = judge.analysis_numbers(rows, ref)
    assert numbers["table_gap"] < judge.LIMITS["table_gap"] / 10
    assert numbers["angle_regret"] == 0.0


@pytest.mark.parametrize("stride,link", [(24, False), (24, True), (1, False),
                                         (8, True), (90, False)])
def test_selection_matches_the_port(stride, link):
    from phaserotate_tpu_torch.search import select_min_peak_angles_batch

    rng = np.random.default_rng(stride * 7 + link)
    for _ in range(20):
        tables = rng.uniform(0.5, 1.0, (4, 2, dsp.MAXSAMPLE))
        tables = np.round(tables, 2).astype(np.float32)  # ties
        tables[0, 1] = 0.7  # a flat channel: no minimum found
        rot0 = rng.uniform(0.5, 1.0, (4, 2)).astype(np.float32)
        got = select_min_peak_angles_batch(tables, stride=stride,
                                           link_channels=link, rot0=rot0)
        want = offline.select_angles(tables, rot0, stride, link)
        for g, w in zip(got, want):
            assert g.angles_units == w["units"]
            assert g.found == w["found"]


def test_served_stream_and_meters_match_the_port():
    from phaserotate_tpu_torch.plugin.lifecycle import PhaseRotatePlugin
    from phaserotate_tpu_torch.plugin.protocol import LevelsMsg, UiOn
    from phaserotate_tpu_torch.plugin.uris import PLUGIN_URI_STEREO, PortIndex

    rate, block, depth = 48000, 1024, 2
    x = music_host(5, 0, 2, 60 * block, rate)
    targets = np.full((60, 2), 37.5, np.float32)
    targets[30:] = -120.0  # an angle change mid-stream ramps
    plug = PhaseRotatePlugin(PLUGIN_URI_STEREO, rate,
                             {"pipeline": depth, "device": "cpu"})
    ctl, notify = [UiOn()], []
    plug.connect_port(PortIndex.ATOM_CONTROL, ctl)
    plug.connect_port(PortIndex.ATOM_NOTIFY, notify)
    ang = [np.zeros(1, np.float32) for _ in range(2)]
    bufs = [np.zeros(block, np.float32) for _ in range(2)]
    for c in range(2):
        base = PortIndex.ANGLE0 + 3 * c  # (angle, input, output)
        plug.connect_port(base, ang[c])
        plug.connect_port(base + 1, bufs[c])
        plug.connect_port(base + 2, bufs[c])
    out = np.zeros_like(x)
    lv = []
    for j in range(60):
        for c in range(2):
            ang[c][0] = targets[j, c]
            bufs[c][:] = x[c, j * block : (j + 1) * block]
        plug.run(block)
        for c in range(2):
            out[c, j * block : (j + 1) * block] = bufs[c]
        got = [m for m in notify if isinstance(m, LevelsMsg)]
        notify.clear()
        lv.append([[getattr(m, f) for f in stream.LEVEL_FIELDS]
                   for m in sorted(got, key=lambda m: m.channel)])
    y = stream.served(x, targets, block, rate, depth)
    ref_lv = stream.levels(x, y, targets, block, rate, plug.latency)
    numbers = judge.serving_numbers([dict(out=out, ref=y, levels=lv,
                                          ref_levels=ref_lv)])
    assert numbers["audio_gap"] < judge.LIMITS["audio_gap"] / 10
    assert numbers["level_gap"] < judge.LIMITS["level_gap"] / 10


@pytest.mark.parametrize("seed", [3, 4, 2 ** 31 + 99])
def test_analysis_control_in_bfloat16_fails(seed):
    rows, ref = [], {}
    for i, x in enumerate(_songs(seed)):
        t, r0 = offline.peak_table(x.double(), 8192)
        tb, rb0 = offline.peak_table(x, 8192, precision="bfloat16")
        ref[i] = dict(table=t, rot0=r0,
                      **offline.select_angles(t[None], r0[None], 24,
                                              False)[0])
        sel = offline.select_angles(tb[None], rb0[None], 24, False)[0]
        rows.append(dict(key=i, table=tb, rot0=rb0, units=sel["units"],
                         found=sel["found"]))
    numbers = judge.analysis_numbers(rows, ref)
    assert not judge.passed(judge.checks(numbers))


@pytest.mark.parametrize("seed", [3, 4, 2 ** 31 + 99])
def test_serving_control_in_bfloat16_fails(seed):
    rate, block = 48000, 1024
    x = music_host(seed, 0, 2, 40 * block, rate)
    targets = np.full((40, 2), 61.0, np.float32)
    y = stream.served(x, targets, block, rate, 3)
    yb = stream.served(x, targets, block, rate, 3, precision="bfloat16")
    lv = stream.levels(x, y, targets, block, rate, 2560)
    lvb = stream.levels(x, yb, targets, block, rate, 2560)
    numbers = judge.serving_numbers([dict(out=yb, ref=y, levels=lvb,
                                          ref_levels=lv)])
    assert not judge.passed(judge.checks(numbers))


@pytest.mark.parametrize("bits", [16, 24])
def test_input_peak_gap_reads_the_port_exactly(bits):
    """The port's CPU sweep over songs on the 16- or the 24-bit grid, run
    by the resident driver: its angle-0 entries equal the reference's."""
    from bench_tiny import run_tiny

    out, res, checked = run_tiny("search.cli_48k.resident",
                                 config={"bits": bits})
    assert res["correct"], checked
    assert checked["input_peak_gap"] == {"value": 0.0, "limit": 0.0}


@pytest.mark.parametrize("seed", [6, 2 ** 31 + 77])
def test_shallow_read_of_24_bit_masters_fails_only_input_peak_gap(seed):
    """The reference on the 16-bit-rounded copy of 24-bit masters, in the
    program's place (``calibrate.py``'s ``shallow_read``), is inside the
    limits of the table and the angles and outside ``input_peak_gap``'s."""
    import calibrate
    from bench_tiny import tiny

    cell = tiny("analyze.cli_48k.catalogue",
                config={"bits": 24, "rate": 96000})
    got = calibrate.analysis_readings(cell, seed, torch.device("cpu"))
    shallow = got["shallow_read"]
    assert 2.0 ** -24 < shallow["input_peak_gap"] < judge.LIMITS["table_gap"]
    assert shallow["table_gap"] < judge.LIMITS["table_gap"]
    assert shallow["angle_regret"] < judge.LIMITS["angle_regret"]
    assert not judge.passed(judge.checks(shallow))
    assert "shallow_read" not in calibrate.analysis_readings(
        tiny("analyze.cli_48k.catalogue"), seed, torch.device("cpu"))
