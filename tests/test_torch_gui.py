"""The port's host surfaces against the JAX package's, on the CPU: the
standalone host and its ``main`` (phaserotate_tpu_torch/hostapp.py), the
browser GUI over a live host (``gui.web``), the terminal UI (``tui``) and
the ALSA playback binding (``io.playback``).

The GUI, TUI and playback modules are copies of the JAX package's
(``tests/test_torch_io.py`` holds their text to the source); here they
drive the port's plugin, and what they show is held to what they show
over the JAX plugin: the same meters within 1e-5, the same dials, the same
rendered widgets.
"""

import io
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from phaserotate_tpu import hostapp as j_hostapp
from phaserotate_tpu.gui.web import HostSurface as JSurface
from phaserotate_tpu.gui.web import WebUI as JWebUI
from phaserotate_tpu.io.playback import AlsaOutput as JAlsa
from phaserotate_tpu_torch import hostapp
from phaserotate_tpu_torch.gui import render_channel
from phaserotate_tpu_torch.gui.web import HostSurface, WebUI
from phaserotate_tpu_torch.hostapp import StandaloneHost
from phaserotate_tpu_torch.io import read_wav, write_wav
from phaserotate_tpu_torch.io.playback import AlsaOutput
from phaserotate_tpu_torch.ops import rotate_fir
from phaserotate_tpu_torch.tui import TuiSession, run_tui

torch.set_num_threads(1)

RATE = 48000
TIMEOUT = 30.0


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return r.read()


def _post(url, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


@pytest.fixture()
def webhosts():
    """A port host and a JAX host, each behind its own browser GUI."""
    hosts = (StandaloneHost(RATE, 2, block=512, device="cpu"),
             j_hostapp.StandaloneHost(RATE, 2, block=512))
    uis = (WebUI(lambda s=HostSurface(hosts[0]): {"0": s}, port=0).start(),
           JWebUI(lambda s=JSurface(hosts[1]): {"0": s}, port=0).start())
    yield hosts, uis
    for ui in uis:
        ui.stop()


def test_web_state_matches_jax_host(webhosts):
    """The same blocks and dial writes through each host: the same page,
    dials and rendered dial faces, meters within 1e-5."""
    hosts, uis = webhosts
    rng = np.random.default_rng(51)
    blocks = [(0.5 * rng.standard_normal((2, 512))).astype(np.float32)
              for _ in range(12)]
    states = []
    for host, ui in zip(hosts, uis):
        assert "Phase Rotate (TPU)" in _get(ui.url).decode()
        _post(ui.url + "control", {"action": "dial", "session": "0",
                                   "channel": 0, "value": 35.2})
        _post(ui.url + "control", {"action": "scroll", "session": "0",
                                   "channel": 1, "steps": -3})
        for i, b in enumerate(blocks):
            if i == 6:
                _post(ui.url + "control", {"action": "link",
                                           "session": "0", "active": True})
            host.process(b)
        states.append(json.loads(_get(ui.url + "state"))["sessions"]["0"])
    ps, js = states
    assert ps["angles"] == js["angles"] == [35.0, 35.0]
    assert float(hosts[0].angles[1][0]) == 35.0  # mirrored while linked
    for key in ("channels", "rate", "link", "ui_scale", "dial_svg"):
        assert ps[key] == js[key], key
    for pm, jm in zip(ps["meters"], js["meters"]):
        np.testing.assert_allclose([pm[k] for k in jm], list(jm.values()),
                                   atol=1e-5)
    assert ps["meters"][0]["in_peak"] > 0.1
    assert all("<svg" in svg for svg in ps["meter_svg"])


def test_web_meter_click_and_bad_requests(webhosts):
    (host, _), (ui, _) = webhosts
    x = (0.5 * np.random.default_rng(52).standard_normal((2, 512))
         ).astype(np.float32)
    for _ in range(8):
        host.process(x)
    assert json.loads(_get(ui.url + "state"))["sessions"]["0"]["meters"][0][
        "in_peak"] > 0.1
    _post(ui.url + "control", {"action": "reset", "session": "0"})
    for _ in range(8):  # past the latency-aligned input delay line
        host.process(np.zeros((2, 512), np.float32))
    _post(ui.url + "control", {"action": "reset", "session": "0"})
    host.process(np.zeros((2, 512), np.float32))
    assert json.loads(_get(ui.url + "state"))["sessions"]["0"]["meters"][0][
        "in_peak"] < 0.1
    for body in ({"action": "dial", "session": "9", "channel": 0,
                  "value": 1},
                 {"action": "nope", "session": "0"},
                 {"action": "dial", "session": "0", "channel": 5,
                  "value": 1.0}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(ui.url + "control", body)
        assert e.value.code == 400
    for v in (float("nan"), 1e308):
        _post(ui.url + "control", {"action": "scale", "session": "0",
                                   "value": v})
    assert 1.0 <= host.plugin.ui_scale <= 2.0


def test_tui_keys_drive_dials_and_ports():
    host = StandaloneHost(RATE, 2, block=256, device="cpu")
    s = TuiSession(host, color=False)
    s.feed(b"\x1b[C")  # right: +0.5
    s.feed(b"\x1b[A")  # up: +5
    assert s.ui.dials[0].value == 5.5 and host.angles[0][0] == 5.5
    s.feed(b"\t" + b"l")  # channel 1, then link: dial 1 snaps to dial 0
    assert s.active == 1 and s.ui.link.active
    assert host.angles[1][0] == 5.5
    s.feed(b"\t0")  # back to channel 0, detent
    assert s.ui.dials[0].value == 0.0 and host.angles[1][0] == 0.0
    out = s.render()
    assert "ch0" in out and "ch1" in out and "q: quit" in out
    s.feed(b"q")
    assert not s.running


def test_tui_mid_stream_turn_is_applied():
    """Turning the dial while the audio runs rotates the rest of the
    stream (through the click-free ramp), on the port's plugin."""
    host = StandaloneHost(RATE, 1, block=256, device="cpu")
    s = TuiSession(host, color=False)
    t = np.arange(RATE // 4) / RATE
    x = np.sin(2 * np.pi * 480.0 * t).astype(np.float32)
    n = len(x)
    outs = []
    for i in range(0, n, 256):
        if i == (n // 2) // 256 * 256:
            s.feed(b"\x1b[A" * 18)  # +90 degrees
        outs.append(host.process(x[None, i : i + 256]))
    y = np.concatenate(outs, axis=1)[0]
    lat = int(host.latency[0])
    want90 = rotate_fir(x, 90.0, rate=RATE, device="cpu").numpy()
    np.testing.assert_allclose(y[lat + 2048 : n // 2],
                               x[2048 : n // 2 - lat], atol=1e-4)
    np.testing.assert_allclose(y[n - 2048 : n - lat],
                               want90[n - 2048 - lat : n - 2 * lat],
                               atol=1e-4)
    assert np.abs(np.diff(y)).max() < 0.2


def test_run_tui_captures_the_played_frames():
    host = StandaloneHost(RATE, 1, block=256, device="cpu")
    x = (0.1 * np.ones((1, 1000))).astype(np.float32)
    r, w = os.pipe()
    try:
        outs, played = run_tui(host, x, RATE, 256, loop=False, stdin_fd=r,
                               stdout=io.StringIO())
    finally:
        os.close(r)
        os.close(w)
    assert played == 1000 and len(outs) >= 4 + 1


@pytest.mark.parametrize("flags", [
    ["-a", "25", "--block", "333"],
    ["-a", "-60", "--block", "512", "--pipeline", "2", "--meters"],
], ids=["plain", "pipelined-meters"])
def test_hostapp_main_matches_jax(tmp_path, capsys, flags):
    """hostapp.main on a stereo file writes what the JAX hostapp writes
    (within 1e-5), latency compensated, with the same closing line."""
    x = (0.4 * np.random.default_rng(53).standard_normal((2, 9000))
         ).astype(np.float32)
    src = str(tmp_path / "in.wav")
    write_wav(src, x, RATE)
    outs, lines = [], []
    for name, main, kw in (("port", hostapp.main, {"device": "cpu"}),
                           ("jax", j_hostapp.main, {})):
        dst = str(tmp_path / f"out_{name}.wav")
        assert main([src, dst, *flags], **kw) == 0
        lines.append(capsys.readouterr().out.strip().splitlines()[-1])
        y, rate, _ = read_wav(dst)
        assert rate == RATE and y.shape == x.shape
        outs.append(y)
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5)
    assert lines[0] == lines[1].replace(str(tmp_path / "out_jax.wav"),
                                        str(tmp_path / "out_port.wav"))


def test_hostapp_device_and_refusal(tmp_path, capsys):
    x = (0.3 * np.random.default_rng(54).standard_normal(3000)
         ).astype(np.float32)
    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    write_wav(src, x, RATE)
    assert hostapp.main([src, dst], device="cpu") == 0
    np.testing.assert_allclose(read_wav(dst)[0][0], x, atol=1e-6)
    capsys.readouterr()
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a card")
    assert hostapp.main([src, dst]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("Error: no CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        StandaloneHost(RATE, 1)


class _FakeAsound:
    """The libasound entry points AlsaOutput calls, recording the frames."""

    def __init__(self):
        self.frames, self.params, self.closed = [], None, False

    def snd_pcm_open(self, handle_ref, device, stream, mode):
        import ctypes

        ctypes.cast(handle_ref, ctypes.POINTER(ctypes.c_void_p))[0] = \
            ctypes.c_void_p(0xBEEF)
        return 0

    def snd_pcm_set_params(self, pcm, *params):
        self.params = params
        return 0

    def snd_pcm_writei(self, pcm, buf, nframes):
        import ctypes

        take = min(int(nframes), 100)
        self.frames.append(np.ctypeslib.as_array(
            ctypes.cast(buf, ctypes.POINTER(ctypes.c_float)),
            (take * self.params[2],)).copy())
        return take

    def snd_pcm_recover(self, pcm, err, silent):
        return 0

    def snd_pcm_drain(self, pcm):
        return 0

    def snd_pcm_close(self, pcm):
        self.closed = True
        return 0


def test_playback_writes_what_the_jax_binding_writes():
    block = np.stack([np.arange(300, dtype=np.float32),
                      -np.arange(300, dtype=np.float32)])
    got = []
    for cls in (AlsaOutput, JAlsa):
        lib = _FakeAsound()
        out = cls(RATE, 2, lib=lib)
        out.write(block)
        out.close()
        assert lib.closed
        got.append((lib.params, np.concatenate(lib.frames)))
    assert got[0][0] == got[1][0]
    np.testing.assert_array_equal(got[0][1], got[1][1])
    np.testing.assert_array_equal(got[0][1][0::2], block[0])


def test_render_channel_over_the_port_meters():
    """The terminal meter row of a port host reads as the JAX host's."""
    rows = []
    for host in (StandaloneHost(RATE, 1, block=512, device="cpu"),
                 j_hostapp.StandaloneHost(RATE, 1, block=512)):
        host.ui.open()
        for _ in range(6):  # past the plugin latency
            host.process(np.full((1, 512), 0.5, np.float32))
        host.ui.poll()
        rows.append(render_channel(host.ui.meters[0], "ch0"))
    assert rows[0] == rows[1] and "-inf" not in rows[0]
