"""The port's CLI against phaserotate_tpu.cli on WAV, AIFF, FLAC and W64
files, and the port's independence from JAX at run time."""

import functools
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from phaserotate_tpu import cli as j_cli
from phaserotate_tpu.io import read_wav as j_read_wav
from phaserotate_tpu_torch import cli as p_cli
from phaserotate_tpu_torch import io as p_io
from phaserotate_tpu_torch.io import read_wav, write_wav
from phaserotate_tpu_torch.io.audio import _sniff

from test_search import make_signal

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# the port runs on the CUDA device unless asked for the CPU
p_main = functools.partial(p_cli.main, device="cpu")


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _angles(text):
    return [float(a) for a in re.findall(r"Phase:\s*(-?[\d.]+) deg", text)]


def _assert_same_text(got, want):
    """Line for line and word for word equal, except that a printed
    number may differ by one unit in its last printed place: the two
    tables agree to float32 roundoff, and a value that close to a rounding
    boundary of the dB or linear print may land on either side of it.
    Angles are multiples of 0.5 degrees, so any angle change still
    fails."""
    g_lines, w_lines = got.splitlines(), want.splitlines()
    assert len(g_lines) == len(w_lines)
    for g_line, w_line in zip(g_lines, w_lines):
        g_words, w_words = g_line.split(), w_line.split()
        assert len(g_words) == len(w_words), (g_line, w_line)
        for g, w in zip(g_words, w_words):
            if g == w:
                continue
            m = re.fullmatch(r"-?\d+\.(\d+),?", w)
            assert m and re.fullmatch(r"-?\d+\.\d+,?", g), (g_line, w_line)
            ulp = 10.0 ** -len(m.group(1))
            assert abs(float(g.rstrip(",")) - float(w.rstrip(","))) <= \
                ulp * 1.01, (g_line, w_line)


@pytest.fixture
def stereo_wav(tmp_path, rng):
    p = str(tmp_path / "in.wav")
    x = make_signal(rng, 2, 8000)
    write_wav(p, x, 48000, bits=16, float_format=False)
    return p


@pytest.mark.parametrize("flags", [[], ["-v"], ["-vv"], ["-vv", "-l"],
                                   ["-vv", "-s", "1"], ["-s", "90", "-f",
                                                        "2048"]])
def test_analysis_output_equals_jax_cli(stereo_wav, capsys, flags):
    argv = flags + [stereo_wav]
    j_rc, j_out, j_err = _run(j_cli.main, argv, capsys)
    p_rc, p_out, p_err = _run(p_main, argv, capsys)
    assert p_rc == j_rc == 0
    _assert_same_text(p_out, j_out)
    _assert_same_text(p_err, j_err)
    assert _angles(p_out + p_err) == _angles(j_out + j_err)
    assert _angles(p_out + p_err)  # a result was printed


def test_analyze_then_apply_round_trip(stereo_wav, tmp_path, capsys):
    _, out, _ = _run(p_main, [stereo_wav], capsys)
    angles = _angles(out)
    assert len(angles) == 2 and any(angles)
    spec = ",".join(f"{a:g}" for a in angles)
    j_dst, p_dst = str(tmp_path / "j.wav"), str(tmp_path / "p.wav")
    assert j_cli.main(["-a", spec, stereo_wav, j_dst]) == 0
    assert p_main(["-a", spec, stereo_wav, p_dst]) == 0
    want, j_rate, _ = j_read_wav(j_dst)
    got, p_rate, _ = read_wav(p_dst)
    assert p_rate == j_rate == 48000
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the chosen rotation lowers the digital peak
    src, _, _ = read_wav(stereo_wav)
    assert np.abs(got).max() < np.abs(src).max()


def test_validation_errors_equal_jax_cli(stereo_wav, tmp_path, capsys):
    for argv in (["-s", "7", stereo_wav], ["-f", "100", stereo_wav],
                 ["-a", "10", stereo_wav], ["-a", "200", stereo_wav, "o.wav"],
                 [str(tmp_path / "missing.wav")]):
        codes = []
        for main in (j_cli.main, p_main):
            try:
                codes.append(main(argv))
            except SystemExit as e:
                codes.append(e.code)
            codes.append(capsys.readouterr().err.split(":")[0])
        assert codes[:2] == codes[2:], argv


def _write_as(kind, path, x):
    """``x`` as a 16-bit file of the given container."""
    if kind == "flac":
        p_io.write_flac(path, x, 48000, bits=16)
    else:
        getattr(p_io, f"write_{kind}")(path, x, 48000, bits=16,
                                       float_format=False)


@pytest.fixture(params=["aiff", "flac", "w64"])
def stereo_file(request, tmp_path, rng):
    """The stereo signal in another container than WAV, under a name
    without an extension: the readers go by content."""
    p = str(tmp_path / f"in_{request.param}")
    _write_as(request.param, p, make_signal(rng, 2, 8000))
    return request.param, p


@pytest.mark.parametrize("flags", [[], ["-vv"], ["-vvv"]])
def test_analysis_of_other_containers_equals_jax_cli(stereo_file, capsys,
                                                     flags):
    _, path = stereo_file
    argv = flags + [path]
    j_rc, j_out, j_err = _run(j_cli.main, argv, capsys)
    p_rc, p_out, p_err = _run(p_main, argv, capsys)
    assert p_rc == j_rc == 0
    _assert_same_text(p_out, j_out)
    _assert_same_text(p_err, j_err)
    assert _angles(p_out + p_err) == _angles(j_out + j_err)
    assert _angles(p_out + p_err)


def test_other_containers_choose_the_angles_of_the_wav(stereo_file,
                                                       tmp_path, rng,
                                                       capsys):
    """The same 16-bit samples give the same result in any container."""
    _, path = stereo_file
    x, _, _ = p_io.read_audio(path)
    wav = str(tmp_path / "same.wav")
    write_wav(wav, x, 48000, bits=16, float_format=False)
    _, w_out, _ = _run(p_main, [wav], capsys)
    _, f_out, _ = _run(p_main, [path], capsys)
    assert f_out == w_out


def test_apply_without_extension_inherits_the_container(stereo_file,
                                                        tmp_path, capsys):
    kind, path = stereo_file
    j_dst, p_dst = str(tmp_path / "j_out"), str(tmp_path / "p_out")
    assert j_cli.main(["-a", "10,-33.5", path, j_dst]) == 0
    assert p_main(["-a", "10,-33.5", path, p_dst]) == 0
    assert _sniff(p_dst) == _sniff(j_dst) == kind
    want, j_rate, j_meta = p_io.read_audio(j_dst)
    got, p_rate, p_meta = p_io.read_audio(p_dst)
    assert p_rate == j_rate == 48000 and got.shape == want.shape
    assert p_meta.container == j_meta.container
    # FLAC stores 16 bits: one quantization step of slack there
    np.testing.assert_allclose(got, want,
                               atol=1 / 32768 if kind == "flac" else 1e-5)
    # a named extension wins over the input's container
    named = str(tmp_path / "out.wav")
    assert p_main(["-a", "10,-33.5", path, named]) == 0
    assert _sniff(named) == "wav"
    y = read_wav(named)[0]  # float32: what FLAC then clips and rounds
    np.testing.assert_allclose(np.clip(y, -1, 32767 / 32768) if kind == "flac"
                               else y, want,
                               atol=1 / 32768 if kind == "flac" else 1e-5)


@pytest.mark.parametrize("content", [b"", b"RIFF\x04\x00\x00\x00WAVE",
                                     b"FORM\x00\x00", b".snd\x00\x00",
                                     b"not audio at all, just text"])
def test_unreadable_file_prints_the_error_line(tmp_path, capsys, content):
    bad = tmp_path / "bad.bin"
    bad.write_bytes(content)
    j_rc, j_out, j_err = _run(j_cli.main, [str(bad)], capsys)
    p_rc, p_out, p_err = _run(p_main, [str(bad)], capsys)
    assert p_rc == j_rc == 1
    assert p_out == j_out == ""
    assert p_err == j_err
    assert p_err.startswith(f"Cannot open '{bad}' for reading: ")
    assert len(p_err.splitlines()) == 1


def test_unwritable_output_prints_the_error_line(stereo_wav, tmp_path,
                                                 capsys):
    dst = str(tmp_path / "no_such_dir" / "out.wav")
    rc, out, err = _run(p_main, ["-a", "10", stereo_wav, dst], capsys)
    assert rc == 1
    assert err.startswith(f"Cannot open '{dst}' for writing: ")


def test_profile_hook_writes_a_trace(stereo_wav, tmp_path, capsys,
                                     monkeypatch):
    """PHASEROTATE_TPU_PROFILE=<dir>, the JAX CLI's variable, traces the
    run and changes nothing it prints."""
    _, want, _ = _run(p_main, [stereo_wav], capsys)
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("PHASEROTATE_TPU_PROFILE", str(trace_dir))
    rc, out, _ = _run(p_main, [stereo_wav], capsys)
    assert rc == 0 and out == want
    files = list(trace_dir.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    assert files[0].stat().st_size > 0
    # a usage error still leaves through the hook
    with pytest.raises(SystemExit):
        p_main(["-s", "7", stereo_wav])
    capsys.readouterr()
    monkeypatch.delenv("PHASEROTATE_TPU_PROFILE")
    assert p_main([stereo_wav]) == 0
    assert len(list(trace_dir.iterdir())) == 2


def test_port_runs_without_jax():
    """A fresh interpreter that uses the port never loads JAX or the JAX
    package."""
    code = (
        "import sys, numpy as np\n"
        "import phaserotate_tpu_torch as pr\n"
        "x = np.sin(np.arange(6000) * 0.05).astype(np.float32)\n"
        "x = np.stack([x, np.roll(x, 17) * 0.5])\n"
        "res = pr.find_min_peak_angle(x, rate=48000, device='cpu')\n"
        "y = pr.rotate(x, 35.0, method='fir', device='cpu')\n"
        "assert y.shape == x.shape and len(res.angles_units) == 2\n"
        "from phaserotate_tpu_torch import meter, models, stream\n"
        "from phaserotate_tpu_torch.kernels import fused_conv\n"
        "rot = pr.PhaseRotator(rate=48000, channels=2, device='cpu')\n"
        "assert rot.process(x, 35.0).shape == x.shape\n"
        "h = fused_conv.fused_hilbert(pr.rotate(x, 0.0, device='cpu'), 3072)\n"
        "assert h.shape[-1] >= x.shape[-1]\n"
        "s = stream.rotate_streamed(x[0], 35.0, device='cpu')\n"
        "an = pr.AngleAnalyzer(rate=48000, device='cpu')\n"
        "assert an.analyze(x).angles_units == res.angles_units\n"
        "assert float(rot.levels(1).out_peak) > 0\n"
        "import importlib, pkgutil\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    pr.__path__, pr.__name__ + '.')]\n"
        "assert len(mods) > 40, mods\n"
        "for m in ('fleet', 'parallel', 'parallel.batch', 'parallel.mesh',\n"
        "          'search.packed', 'plugin.lifecycle', 'plugin.uris',\n"
        "          'plugin.protocol', 'plugin.descriptors', 'plugin.ttl',\n"
        "          'gui.client', 'gui.deflect', 'gui.render', 'gui.widgets',\n"
        "          'gui.web', 'hostapp', 'tui', 'io.playback',\n"
        "          'stream.broker', 'bridge'):\n"
        "    assert pr.__name__ + '.' + m in mods, m\n"
        "for m in mods:\n"
        "    if not m.endswith('.__main__'):  # that one runs the CLI\n"
        "        importlib.import_module(m)\n"
        "g = pr.offline_geometry(48000, 1024)\n"
        "from phaserotate_tpu_torch.search import refine_angle\n"
        "t, p = refine_angle(x[0], res.angles_units[0], g, steps=4,\n"
        "                    device='cpu')\n"
        "assert p > 0\n"
        "import os, tempfile\n"
        "d = tempfile.mkdtemp()\n"
        "pr.write_audio(os.path.join(d, 'a.flac'), x, 48000)\n"
        "assert pr.read_audio(os.path.join(d, 'a.flac'))[0].shape == x.shape\n"
        "from phaserotate_tpu_torch import fleet, parallel\n"
        "wav = os.path.join(d, 'a.wav')\n"
        "pr.write_audio(wav, x, 48000)\n"
        "got = fleet.analyze_paths([wav], transport='packed', device='cpu')\n"
        "assert got[wav][0].angles_units == res.angles_units\n"
        "mesh = parallel.file_mesh(3, devices=['cpu'] * 3)\n"
        "t, r = parallel.angle_sharded_sweep_peaks(x, g, mesh)\n"
        "assert t.shape == (2, 360) and r.shape == (2,)\n"
        "import threading\n"
        "from phaserotate_tpu_torch import bridge\n"
        "from phaserotate_tpu_torch.hostapp import StandaloneHost\n"
        "host = StandaloneHost(48000, 2, block=1024, device='cpu')\n"
        "host.set_angles(35.0)\n"
        "assert host.process(x[:, :1024]).shape == (2, 1024)\n"
        "sock = os.path.join(d, 'e.sock')\n"
        "rfd, wfd = os.pipe()\n"
        "srv = threading.Thread(target=bridge.serve, args=(sock,),\n"
        "                       daemon=True, kwargs=dict(\n"
        "                           ready_fd=wfd, device='cpu', once=True,\n"
        "                           batch_sessions=2, pipeline=1))\n"
        "srv.start()\n"
        "assert os.read(rfd, 1) == b'R'\n"
        "cl = bridge.BridgeClient(sock, 48000, 2)\n"
        "assert cl.process(x[:, :1024], 35.0).shape == (2, 1024)\n"
        "assert cl.analyze(x)[0]['angle_deg'] == res.angles_deg[0]\n"
        "cl.close()\n"
        "srv.join(120)  # the session closed: no torch work left at exit\n"
        "assert not srv.is_alive()\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'jax' or m.startswith(('jax.', 'phaserotate_tpu.'))\n"
        "       or m == 'phaserotate_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
