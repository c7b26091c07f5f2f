"""Device mesh helpers (torch).

Counterpart of ``phaserotate_tpu/parallel/mesh.py``.  The reference's only
parallelism is one pthread per audio channel (cli/phase-rotate.cc:437-444).
Here the axes of a :class:`Mesh`, a named grid of ``torch.device``s driven
by ONE process (as the JAX package is single-controller), take its place:

* ``files`` — data parallelism over a fleet of files/stems (replaces the
  thread fan-out; no exchange between devices).
* ``samples`` — sequence parallelism *within* one long file: shards of the
  sample axis with a halo copied from the neighbouring device for the
  convolution overlap and a ``torch.maximum`` of the shards' peak tables
  on the gathering device (parallel/batch.py).

Without ``devices`` a mesh spans the visible CUDA devices, and there is
never a quiet CPU mesh.  ``devices`` names the devices outright and is used
as given: ``["cpu"] * 8`` for a CPU run, or one card several times over, so
that the halo and reduce logic runs with the real kernels on a single card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "file_mesh", "grid_mesh", "shard_files"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of ``torch.device``s with one name per axis."""

    devices: np.ndarray  # object array of torch.device
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"{self.devices.ndim}-D device grid with axis names "
                f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        """Devices along each axis, by axis name."""
        return dict(zip(self.axis_names, self.devices.shape))

    def grid(self, row_axis: Optional[str], col_axis: str) -> np.ndarray:
        """The devices as a (rows, cols) array along two named axes (one
        row if ``row_axis`` is None); along any other axis the first
        device stands for the rest, which would hold replicas."""
        keep = [a for a in (row_axis, col_axis) if a is not None]
        for a in keep:
            if a not in self.axis_names:
                raise ValueError(f"mesh has no axis {a!r}: {self.axis_names}")
        devs = self.devices[tuple(
            slice(None) if a in keep else 0 for a in self.axis_names)]
        if row_axis is None:
            return devs.reshape(1, -1)
        names = [a for a in self.axis_names if a in keep]
        return devs if names == keep else devs.T


def _devices(devices: Optional[Sequence]) -> list:
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a mesh spans the CUDA devices by default; "
            "pass devices=[...] (e.g. [\"cpu\"] * n) to name them")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def _object_array(devs: Sequence[torch.device]) -> np.ndarray:
    out = np.empty(len(devs), object)
    out[:] = list(devs)
    return out


def file_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over ``files`` (pure data parallelism).

    Raises if fewer than ``n_devices`` devices are visible — silently
    shrinking the mesh would shard the fleet differently than the caller
    laid it out.
    """
    devs = _devices(devices)
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(
            f"requested a {n}-device mesh but only {len(devs)} "
            f"device(s) are visible"
        )
    return Mesh(_object_array(devs[:n]), axis_names=("files",))


def grid_mesh(files: int, samples: int,
              devices: Optional[Sequence] = None) -> Mesh:
    """2-D mesh: data parallel over files x sequence parallel over
    samples."""
    devs = _devices(devices)
    if files * samples > len(devs):
        raise ValueError(
            f"requested a {files}x{samples} mesh but only {len(devs)} "
            f"device(s) are visible"
        )
    grid = _object_array(devs[: files * samples]).reshape(files, samples)
    return Mesh(grid, axis_names=("files", "samples"))


def shard_files(x, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """Place a (files, ...) batch with the files axis sharded: the equal
    per-device shards, in mesh order, each on its device."""
    devs = mesh.grid(None, "files")[0]
    x = torch.as_tensor(x)
    if x.shape[0] % len(devs):
        raise ValueError(
            f"{x.shape[0]} files do not divide over {len(devs)} devices")
    per = x.shape[0] // len(devs)
    return tuple(x[i * per : (i + 1) * per].to(d)
                 for i, d in enumerate(devs))
