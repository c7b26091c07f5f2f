"""Where the port runs when the caller names no device.

An explicit ``device`` is used as given (a tensor input is moved there),
a tensor input without one keeps its device, and otherwise the work goes
to the CUDA device.  Without a card that is an
error, never a quiet run on the CPU.  Whether a card exists is decided in
each test, so every worker collects the same tests; the card's side of
this is tests/test_torch_cuda.py ``test_entry_points_default_to_the_card``.
"""

import numpy as np
import pytest
import torch

import phaserotate_tpu_torch as pr
from phaserotate_tpu_torch import cli
from phaserotate_tpu_torch.core import resolve_device
from phaserotate_tpu_torch.core.device import as_f32
from phaserotate_tpu_torch.core.sizes import OfflineGeometry
from phaserotate_tpu_torch.io import write_wav
from phaserotate_tpu_torch.ops.rotate import hilbert_fir
from phaserotate_tpu_torch.search import (apply_angles, peak_at_angle,
                                          refine_angle, sweep_peaks)
from phaserotate_tpu_torch.search.sweep import sweep_peaks_aux_pcm16
from phaserotate_tpu_torch.stream import rotate_streamed

_X = (0.5 * np.sin(np.arange(2 * 3000) * 0.05)).astype(np.float32)
_X = _X.reshape(2, 3000)

# every entry point that takes ``device=None``, called on numpy input
ENTRY_POINTS = {
    "find_min_peak_angle": lambda: pr.find_min_peak_angle(_X, blksiz=1024),
    "sweep_peaks": lambda: sweep_peaks(_X, OfflineGeometry(1024)),
    "apply_angles": lambda: apply_angles(_X, [10, 20], OfflineGeometry(1024)),
    "rotate_spectral": lambda: pr.rotate(_X, 35.0),
    "rotate_fir": lambda: pr.rotate(_X, 35.0, method="fir"),
    "hilbert_fir": lambda: hilbert_fir(_X, 3072),
    "rotate_streamed": lambda: rotate_streamed(_X[0], 35.0),
    "PhaseRotator": lambda: pr.PhaseRotator(rate=48000, channels=2),
    "StreamingRotator": lambda: pr.StreamingRotator(rate=48000),
    "OfflineRotator": lambda: pr.OfflineRotator(method="fir")(_X, 35.0),
    "AngleAnalyzer": lambda: pr.AngleAnalyzer(blksiz=1024).analyze(_X),
    "refine_angle": lambda: refine_angle(_X[0], 10, OfflineGeometry(1024)),
    "peak_at_angle": lambda: peak_at_angle(_X[0], 10.5,
                                           OfflineGeometry(1024)),
    "sweep_peaks_aux_pcm16": lambda: sweep_peaks_aux_pcm16(
        (_X * 32767).astype(np.int16), OfflineGeometry(1024)),
}


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")


def test_tensor_input_keeps_its_device():
    x = torch.zeros(4)
    assert resolve_device(None, x) == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu"), [1.0]) == torch.device("cpu")


def test_explicit_device_wins_over_the_tensor():
    """An explicit device moves a tensor input; it never stays behind."""
    x = torch.zeros(4)
    assert resolve_device("cuda", x) == torch.device("cuda")
    assert resolve_device("meta", x) == torch.device("meta")
    y = as_f32(x, "meta")
    assert y.device.type == "meta" and y.dtype == torch.float32


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_card_raises(name):
    _no_card()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()


def test_resolver_without_card_raises():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()


def test_cli_without_card_exits_nonzero(tmp_path, capsys):
    _no_card()
    src = str(tmp_path / "in.wav")
    write_wav(src, _X, 48000, bits=16, float_format=False)
    assert cli.main([src]) == 1
    out = capsys.readouterr()
    assert out.out == ""
    lines = out.err.splitlines()
    assert len(lines) == 1 and "no CUDA device" in lines[0]
    assert 'device="cpu"' in lines[0]
    # asked for the CPU, the same call runs
    assert cli.main([src], device="cpu") == 0


def test_cpu_tensor_input_runs_without_a_device_argument():
    """A CPU tensor is a request for the CPU: no device argument needed."""
    x = torch.from_numpy(_X)
    res = pr.find_min_peak_angle(x, blksiz=1024)
    want = pr.find_min_peak_angle(_X, blksiz=1024, device="cpu")
    assert res.angles_units == want.angles_units
    y = pr.rotate(x, 35.0, method="fir")
    assert y.device.type == "cpu" and y.shape == x.shape
    analyzer = pr.AngleAnalyzer(blksiz=1024)
    assert analyzer.analyze(x).angles_units == want.angles_units
