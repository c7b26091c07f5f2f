"""phaserotate_tpu_torch — the PyTorch/CUDA port of phaserotate_tpu.

Arbitrary-angle phase rotation of audio and the minimum-peak angle
analyzer of x42/phaserotate.lv2, on PyTorch tensors.  On a CUDA device the
hot loops run in hand-written Hopper kernels (``csrc/``, built with
``nvcc`` at first use); on the CPU the same functions run their plain
PyTorch versions.  The JAX package ``phaserotate_tpu`` is the reference
this port is tested against; nothing here imports it or JAX.

Public surface:

* :func:`rotate` — rotate(audio, degrees, method="spectral"|"fir").
* :func:`rotate_fir` — the plugin's windowed-FIR rotation.
* :func:`find_min_peak_angle` — the CLI's coarse-to-fine min-peak search.
* :func:`apply_angles` — the CLI's offline apply path.
* :class:`PhaseRotator`, :class:`StreamingRotator` — the plugin-role
  streaming engine (any host block size, meters, checkpoint/resume).
* :class:`OfflineRotator`, :class:`AngleAnalyzer` — the offline models.
* :func:`read_audio`, :func:`write_audio` — file I/O in every container
  and codec of the JAX package (numpy on the host).
"""

from .core import (
    MAXSAMPLE,
    SUBSAMPLE,
    OfflineGeometry,
    StreamGeometry,
    offline_geometry,
    stream_geometry_for_rate,
)
from .ops import rotate, rotate_fir, rotate_spectral
from .search import apply_angles, find_min_peak_angle

__version__ = "0.1.0"

__all__ = [
    "MAXSAMPLE",
    "SUBSAMPLE",
    "OfflineGeometry",
    "StreamGeometry",
    "apply_angles",
    "find_min_peak_angle",
    "offline_geometry",
    "rotate",
    "rotate_fir",
    "rotate_spectral",
    "stream_geometry_for_rate",
    "__version__",
]

_LAZY = {
    "PhaseRotator": "models",
    "OfflineRotator": "models",
    "AngleAnalyzer": "models",
    "StreamingRotator": "stream",
    "read_audio": "io",
    "write_audio": "io",
}
__all__ += sorted(_LAZY)


def __getattr__(name):
    """Lazy top-level access to the model classes and audio I/O."""
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
