"""The port's plugin lifecycle (phaserotate_tpu_torch/plugin) against the
JAX package's, on the CPU.

The same seeded host blocks, angle automation and UI messages go through
a ``PhaseRotatePlugin`` of each package, wired the same way: outputs and
meter levels agree within 1e-5, the latency is the same and the notify
queues carry the same message types in the same order.  The rest pins the
lifecycle properties ``tests/test_plugin.py`` pins for the JAX plugin, and
the port's own device rules: the engine carry on the plugin's device, the
meters on the host CPU, an int device option indexing the CUDA devices.
"""

import dataclasses

import numpy as np
import pytest
import torch

import phaserotate_tpu.plugin as jp
import phaserotate_tpu_torch.plugin as pp
from phaserotate_tpu_torch.core.sizes import stream_geometry_for_rate

torch.set_num_threads(1)

RATE = 48000
PARSIZ = stream_geometry_for_rate(RATE).parsiz
LEVEL_FIELDS = [f.name for f in dataclasses.fields(pp.LevelsMsg)]


class Wired:
    """One plugin of package ``pkg`` with every port connected, the audio
    ports in place (as a host with in-place buffers wires them)."""

    def __init__(self, pkg, stereo=False, options=None, n=2048):
        uri = pkg.PLUGIN_URI_STEREO if stereo else pkg.PLUGIN_URI
        self.p = pkg.PhaseRotatePlugin(uri, RATE, options=options)
        self.control, self.notify = [], []
        self.latency = np.zeros(1, np.float32)
        self.angles = [np.zeros(1, np.float32) for _ in range(self.p.n_chn)]
        self.io = [np.zeros(n, np.float32) for _ in range(self.p.n_chn)]
        self.p.connect_port(pkg.PortIndex.ATOM_CONTROL, self.control)
        self.p.connect_port(pkg.PortIndex.ATOM_NOTIFY, self.notify)
        self.p.connect_port(pkg.PortIndex.LATENCY, self.latency)
        for c in range(self.p.n_chn):
            self.p.connect_port(3 + 3 * c, self.angles[c])
            self.p.connect_port(4 + 3 * c, self.io[c])
            self.p.connect_port(5 + 3 * c, self.io[c])
        self.p.activate()

    def run(self, block, degrees):
        n = block.shape[1]
        for c in range(self.p.n_chn):
            self.angles[c][0] = degrees[c]
            self.io[c][:n] = block[c]
        self.p.run(n)
        return np.stack([b[:n].copy() for b in self.io])


def port_options(pipeline=0):
    opts = {"device": "cpu"}
    if pipeline:
        opts["pipeline"] = pipeline
    return opts


def jax_options(pipeline=0):
    return {"pipeline": pipeline} if pipeline else None


def _messages(pkg, step):
    """The UI script: ui_on first, state and reset_peaks midway."""
    if step == 0:
        return [pkg.UiOn()]
    if step == 5:
        return [pkg.StateMsg(uiscale=1.5, link=True)]
    if step == 8:
        return [pkg.ResetPeaks()]
    if step == 11:
        return [pkg.UiOff(), pkg.UiOn()]
    return []


def _drive(w, pkg, blocks, degs):
    outs, notes = [], []
    for i, (blk, d) in enumerate(zip(blocks, degs)):
        w.control.extend(_messages(pkg, i))
        outs.append(w.run(blk, d))
        notes.append(list(w.notify))
        w.notify.clear()
    return np.concatenate(outs, axis=1), notes


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
@pytest.mark.parametrize("pipeline", [0, 2], ids=["sync", "pipelined"])
def test_plugin_matches_jax(stereo, pipeline):
    """Host blocks of several sizes, the angle moving (a wrap-around
    swing included) and the UI messages: outputs and levels within 1e-5,
    the same latency and the same messages in the same order."""
    rng = np.random.default_rng(101 + stereo + 2 * pipeline)
    n_chn = 2 if stereo else 1
    sizes = [512, 333, 1024, 256, 700, 2048, 96, 1024, 512, 1500, 512,
             512, 1024, 300]
    blocks = [(0.4 * rng.standard_normal((n_chn, n))).astype(np.float32)
              for n in sizes]
    degs = [np.array([a, -a / 2][:n_chn], np.float32) for a in
            (0, 0, 35, 35, 160, -160, -160, 90, 90, 12.5, 12.5, 12.5, 0, 0)]
    jw = Wired(jp, stereo, jax_options(pipeline))
    pw = Wired(pp, stereo, port_options(pipeline))
    assert pw.p.latency == jw.p.latency
    jy, jn = _drive(jw, jp, blocks, degs)
    py, pn = _drive(pw, pp, blocks, degs)
    assert float(pw.latency[0]) == float(jw.latency[0])
    np.testing.assert_allclose(py, jy, atol=1e-5)
    assert np.abs(py).max() > 0.1
    for i, (jm, pm) in enumerate(zip(jn, pn)):
        assert [type(m).__name__ for m in pm] == \
            [type(m).__name__ for m in jm], i
        for a, b in zip(jm, pm):
            if isinstance(a, jp.LevelsMsg):
                assert b.channel == a.channel
                np.testing.assert_allclose(
                    [getattr(b, f) for f in LEVEL_FIELDS[1:]],
                    [getattr(a, f) for f in LEVEL_FIELDS[1:]],
                    atol=1e-5, err_msg=f"block {i}")
            else:
                assert dataclasses.asdict(b) == dataclasses.asdict(a)
    assert (pw.p.ui_scale, pw.p.link) == (jw.p.ui_scale, jw.p.link)


def test_copied_modules_agree_with_jax():
    """The copies of uris, protocol, descriptors and ttl speak the JAX
    package's contract: the same URIs, port indices, protocol encoding
    and TTL text (the native shim and both daemons share one contract)."""
    assert pp.descriptors() == jp.descriptors()
    assert (pp.PLUGIN_URI, pp.PLUGIN_URI_STEREO) == \
        (jp.PLUGIN_URI, jp.PLUGIN_URI_STEREO)
    assert {m.name: int(m) for m in pp.PortIndex} == \
        {m.name: int(m) for m in jp.PortIndex}
    assert [m.value for m in pp.Prot] == [m.value for m in jp.Prot]
    assert pp.plugin_ttl() == jp.plugin_ttl()
    assert pp.manifest_ttl() == jp.manifest_ttl()
    for msg_p, msg_j in (
            (pp.UiOn(), jp.UiOn()), (pp.ResetPeaks(), jp.ResetPeaks()),
            (pp.StateMsg(uiscale=1.25, link=True),
             jp.StateMsg(uiscale=1.25, link=True)),
            (pp.LevelsMsg(1, *[0.1] * 9), jp.LevelsMsg(1, *[0.1] * 9))):
        assert pp.encode(msg_p) == jp.encode(msg_j)
        assert pp.decode(pp.encode(msg_p)) == msg_p
    assert len(pp.PLUGIN_MONO.ports) == len(jp.PLUGIN_MONO.ports) == 6
    assert [dataclasses.asdict(d) for d in pp.PLUGIN_STEREO.ports] == \
        [dataclasses.asdict(d) for d in jp.PLUGIN_STEREO.ports]


def test_descriptor_uris_and_ui_scale_clamp():
    with pytest.raises(ValueError):
        pp.PhaseRotatePlugin("urn:nope", RATE, options={"device": "cpu"})
    p = pp.PhaseRotatePlugin(pp.PLUGIN_URI, RATE,
                             options={"ui_scale": 5.0, "device": "cpu"})
    assert p.ui_scale == 2.0
    p = pp.PhaseRotatePlugin(pp.PLUGIN_URI, RATE,
                             options={"ui_scale": 0.5, "device": "cpu"})
    assert p.ui_scale == 1.0


def test_latency_measurement_callback_path():
    """run() before the atom ports connect only forwards and reports the
    latency (src/phaserotate.c:790-793)."""
    p = pp.PhaseRotatePlugin(pp.PLUGIN_URI, RATE, options={"device": "cpu"})
    io = np.arange(256, dtype=np.float32)
    lat = np.zeros(1, np.float32)
    p.connect_port(pp.PortIndex.LATENCY, lat)
    p.connect_port(pp.PortIndex.INPUT0, io)
    p.connect_port(pp.PortIndex.OUTPUT0, io)
    p.run(256)
    assert lat[0] == p.latency == 1792
    np.testing.assert_array_equal(io, np.arange(256, dtype=np.float32))


def test_device_option():
    """An int indexes the CUDA devices (out of range: ValueError, as the
    JAX plugin's index into jax.devices()); "cpu" asks for the CPU;
    without the option the plugin is on the card, and without one that
    raises rather than falling back to the CPU."""
    with pytest.raises(ValueError, match="device"):
        pp.PhaseRotatePlugin(pp.PLUGIN_URI, RATE, options={"device": 99})
    p = pp.PhaseRotatePlugin(pp.PLUGIN_URI_STEREO, RATE,
                             options={"device": "cpu"})
    assert p.device.type == "cpu" and p._state.tail.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pp.PhaseRotatePlugin(pp.PLUGIN_URI, RATE)
        with pytest.raises(ValueError, match="0 available"):
            pp.PhaseRotatePlugin(pp.PLUGIN_URI, RATE, options={"device": 0})


def test_sync_mode_compares_alike_rounded_angles():
    """The synchronous plugin compares the host's target turns with the
    engine's angle carry, and the port rounds both alike (correctly, as
    the C reference's float32 division does), so once the ramp ends the
    gain-diff reset stops.  (The JAX package's carry comes from XLA's
    division, which for some angles, -170 degrees among them, lands one
    ulp from numpy's: there its synchronous meters reset every block.
    The parity tests above use angles where the two agree.)"""
    from phaserotate_tpu_torch.core.angles import degrees_to_turns_np

    w = Wired(pp, options=port_options())
    blk = np.full((1, 1024), 0.25, np.float32)
    for _ in range(8):
        w.run(blk, [-170.0])
    want = degrees_to_turns_np(np.float32(-170.0))
    assert w.p._state.angle.numpy()[0] == want
    assert int(w.p._mtr.reset_delay[0]) <= 0


def test_meters_on_host_engine_on_plugin_device():
    w = Wired(pp, stereo=True, options=port_options())
    assert isinstance(w.p._mtr.dly, np.ndarray)  # on the host
    assert tuple(w.p._mtr.dly.shape) == (2, w.p.latency)
    assert w.p._state.spec_hist.device == w.p.device


def test_angle_shadow_tracks_the_engine_carry():
    """The pipelined mode reads no device angle: its host shadow stays
    bit-equal to the engine's own angle carry through ramps and wraps."""
    rng = np.random.default_rng(5)
    w = Wired(pp, stereo=True, options=port_options(pipeline=2))
    for d in (35.0, 35.0, 179.5, -179.5, -179.5, 0.0, 0.0):
        blk = (0.3 * rng.standard_normal((2, 700))).astype(np.float32)
        w.run(blk, [d, -d])
        np.testing.assert_array_equal(w.p._angle_shadow,
                                      w.p._state.angle.numpy())


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_pipelined_plugin_is_the_delayed_sync_stream(stereo):
    """options={'pipeline': D} adds D*parsiz to the latency and delays the
    stream by exactly that (tests/test_plugin.py's delay parity)."""
    D = 2
    rng = np.random.default_rng(9)
    blocks = [rng.standard_normal((1 + stereo, 512)).astype(np.float32)
              for _ in range(12)]
    degs = np.array([25.0, -70.0][: 1 + stereo], np.float32)

    def run(pipeline):
        w = Wired(pp, stereo, port_options(pipeline))
        return w.p.latency, np.concatenate([w.run(b, degs) for b in blocks],
                                           axis=1)

    lat0, y0 = run(0)
    lat1, y1 = run(D)
    d = D * PARSIZ
    assert lat1 == lat0 + d
    np.testing.assert_array_equal(y1[:, :d], 0.0)
    np.testing.assert_array_equal(y1[:, d:], y0[:, : y0.shape[1] - d])


def test_pipelined_plugin_meters_no_spurious_reset():
    """With a steady angle the host-side angle shadow converges, so the
    delayed meter reset fires once per angle change, not every block."""
    w = Wired(pp, options=port_options(pipeline=2))
    w.control.append(pp.UiOn())
    rng = np.random.default_rng(8)

    def peaks_over(blocks):
        vals = []
        for _ in range(blocks):
            w.notify.clear()
            w.run(0.5 * rng.standard_normal((1, 2048)).astype(np.float32),
                  [25.0])
            lv = [m for m in w.notify if isinstance(m, pp.LevelsMsg)]
            vals.append(lv[0].in_peak)
        return vals

    peaks_over(30)  # ramp, converge, flush any delayed reset
    steady = peaks_over(10)
    assert all(b >= a - 1e-7 for a, b in zip(steady, steady[1:]))


def test_activate_resets_pipe_and_state():
    """activate() mid-stream clears the engine and the dispatch pipeline:
    the output after it equals a fresh instance's."""
    rng = np.random.default_rng(12)
    blocks = [rng.standard_normal((1, 512)).astype(np.float32)
              for _ in range(8)]
    w = Wired(pp, options=port_options(pipeline=3))
    for b in blocks[:4]:
        w.run(b, [40.0])
    w.p.activate()
    after = [w.run(b, [40.0]) for b in blocks[4:]]
    fresh = Wired(pp, options=port_options(pipeline=3))
    want = [fresh.run(b, [40.0]) for b in blocks[4:]]
    np.testing.assert_array_equal(np.concatenate(after, axis=1),
                                  np.concatenate(want, axis=1))


def test_ui_protocol_levels_state_and_reset():
    w = Wired(pp, stereo=True, options=port_options())
    w.control.append(pp.UiOn())
    w.run(np.full((2, 512), 0.5, np.float32), [0.0, 0.0])
    kinds = [type(m) for m in w.notify]
    assert kinds == [pp.LevelsMsg, pp.LevelsMsg, pp.StateMsg]
    w.notify.clear()
    w.run(np.full((2, 512), 0.9, np.float32), [0.0, 0.0])
    assert pp.StateMsg not in [type(m) for m in w.notify]  # echo once
    w.control.extend([pp.ResetPeaks(), pp.StateMsg(uiscale=1.5, link=True)])
    w.notify.clear()
    w.run(np.zeros((2, 512), np.float32), [0.0, 0.0])
    assert (w.p.ui_scale, w.p.link) == (1.5, True)
    lv = [m for m in w.notify if isinstance(m, pp.LevelsMsg)][0]
    assert lv.out_peak < 0.9  # peak hold cleared
    w.control.append(pp.UiOff())
    w.notify.clear()
    w.run(np.zeros((2, 512), np.float32), [0.0, 0.0])
    assert w.notify == []
