"""Sharded batch processing: fleet rotation and distributed angle search
(torch).

Counterpart of ``phaserotate_tpu/parallel/batch.py``: each function
computes per shard exactly what the JAX ``shard_fn`` computes, with the
collectives written out for one process that drives every device of the
mesh (parallel/mesh.py).

* **files axis** (data parallel): a batch of stems sharded over the mesh,
  every device sweeping/rotating its own files — the replacement for the
  reference's thread-per-channel fan-out.  Nothing is exchanged.

* **samples axis** (sequence parallel): one long file sharded across
  devices.  The partitioned convolution needs a ``parsiz``-sample left
  halo from the neighbouring shard — one device-to-device copy — and the
  per-angle peak tables are combined with ``torch.maximum`` on the
  gathering device, replacing the reference's thread-join + std::max
  reduction (cli/phase-rotate.cc:295-298).  This is how hour-long masters
  are analyzed at O(shard) memory per device.

* **angles** (tensor parallel): the signal on every device, each sweeping
  its slice of the candidate grid.

Work for every device is launched before any result is read, so that on
several cards the shards overlap.  Tables and ``rot0`` come back as one
tensor on the mesh's first device; audio-size results (``batch_rotate``,
``sharded_rotate``) are assembled on the CPU from the shards' copies, so
that no device ever holds more than its shard.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.angles import (MAXSAMPLE, all_angle_cos_sin, degrees_to_turns,
                           sin_cos_turns)
from ..core.fir import offline_fir_spectrum, partition_fir_spectra
from ..core.sizes import OfflineGeometry
from ..kernels.rotate_peak import rotate_peak_sweep_kernel
from ..ops.convolve import partitioned_convolve
from ..ops.rotate import rotate_fir
from ..search.minimize import select_min_peak_angles_batch
from ..search.sweep import _sweep_impl, aligned_pair
from .mesh import Mesh, shard_files

__all__ = [
    "batch_rotate",
    "batch_sweep_peaks",
    "batch_find_min_peak_angles",
    "sharded_sweep_peaks",
    "sharded_rotate",
    "angle_sharded_sweep_peaks",
]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def batch_rotate(audio, degrees, mesh: Mesh, rate: float = 48000.0):
    """Rotate a (files, ..., n) batch at per-file angles, files-sharded.

    Pure data parallelism: every file's convolution stays on its own
    device.  Returns a CPU tensor assembled from the shards.
    """
    xs = shard_files(_f32(audio), mesh)
    ds = shard_files(_f32(degrees), mesh)
    ys = [rotate_fir(x, d, rate=rate) for x, d in zip(xs, ds)]
    return torch.cat([y.cpu() for y in ys])


def batch_sweep_peaks(audio, geom: OfflineGeometry, mesh: Mesh,
                      chunk: int = 4096):
    """Peak tables for a (files, ..., n) batch, files-sharded.

    Returns (tables, rot0) exactly like search.sweep_peaks_aux, computed
    device-local per file shard and gathered on the mesh's first device.
    """
    parts = [_sweep_impl(x, geom, chunk)
             for x in shard_files(_f32(audio), mesh)]
    first = parts[0][0].device
    return (torch.cat([t.to(first) for t, _ in parts]),
            torch.cat([r.to(first) for _, r in parts]))


def batch_find_min_peak_angles(
    audio,
    geom: OfflineGeometry,
    mesh: Mesh,
    stride: int = 24,
    link_channels: bool = False,
    max_files_per_call: Optional[int] = None,
) -> list:
    """Full fleet search: sharded sweep on the devices, CLI-parity
    selection on the host per file.

    Args:
      audio: (files, channels, n) float32.
      max_files_per_call: memory-safe chunking — process at most this many
        files per dispatch (rounded down to a mesh-divisible count); a
        fleet larger than device memory streams through in slices.

    Returns a list of :class:`SearchResult`, one per file.
    """
    audio = np.asarray(audio, np.float32)
    n_files = audio.shape[0]
    n_dev = mesh.shape["files"]
    if max_files_per_call is None:
        chunk_files = n_files
    else:
        chunk_files = max(n_dev, (max_files_per_call // n_dev) * n_dev)
    out = []
    for start in range(0, n_files, chunk_files):
        part = audio[start : start + chunk_files]
        # pad the last slice up to a mesh-divisible file count
        pad = (-len(part)) % n_dev
        if pad:
            part = np.concatenate(
                [part, np.zeros((pad, *part.shape[1:]), np.float32)])
        tables, rot0 = batch_sweep_peaks(part, geom, mesh)
        keep = len(part) - pad
        out.extend(select_min_peak_angles_batch(
            tables.cpu().numpy()[:keep], stride=stride,
            link_channels=link_channels, rot0=rot0.cpu().numpy()[:keep]))
    return out


def _sample_shards(x_pad: torch.Tensor, grid) -> list:
    """(files, total) -> [row][col] shards on the (files, samples) device
    grid: rows split the files, columns the samples."""
    n_rows, n_cols = grid.shape
    if x_pad.shape[0] % n_rows:
        raise ValueError(
            f"{x_pad.shape[0]} files do not divide over {n_rows} devices")
    per, S = x_pad.shape[0] // n_rows, x_pad.shape[1] // n_cols
    return [[x_pad[r * per : (r + 1) * per, c * S : (c + 1) * S].to(
        grid[r, c]) for c in range(n_cols)] for r in range(n_rows)]


def sharded_sweep_peaks(
    x,
    geom: OfflineGeometry,
    mesh: Mesh,
    axis: str = "samples",
    chunk: int = 4096,
    file_axis: Optional[str] = None,
):
    """Angle sweep of long signal(s) sharded along the sample axis.

    With ``file_axis`` set and 2-D input ``(files, n)``, composes sequence
    parallelism with data parallelism over a 2-D mesh: each mesh row owns
    a file shard, each column a sample shard; the halo copy and the
    maximum run along ``axis`` only.

    Implements the whole-file evaluation map of search/sweep.py with the
    stream positions split across devices:

    * each device holds ``S`` output positions and copies a
      ``parsiz``-sample left halo from its neighbour (device 0 takes
      zeros — exactly the pre-file zero history);
    * device 0 masks its first ``parsiz`` positions out of the aligned
      sweep (the reference's start block pairs them with zeros) and
      contributes the start-region term instead;
    * the per-device partial tables reduce with ``torch.maximum`` on the
      row's first device.

    The input is padded so the flush block is included and every device
    owns whole ``parsiz`` blocks; the extra zero blocks add nothing.
    Returns ``(peaks, rot0)`` on the mesh's first device.
    """
    parsiz = geom.parsiz
    firlen = geom.firlen
    grid = mesh.grid(file_axis, axis)
    n_dev = grid.shape[1]
    x = _f32(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    n = x.shape[-1]
    n_blocks = -(-n // parsiz)
    total = (n_blocks + 1) * parsiz
    # pad total up so each device owns a whole number of parsiz blocks
    per_dev_blocks = -(-(total // parsiz) // n_dev)
    total = per_dev_blocks * parsiz * n_dev
    shards = _sample_shards(torch.nn.functional.pad(x, (0, total - n)), grid)

    rows = []
    for row in shards:
        parts, x_peaks = [], []
        for c, x_local in enumerate(row):  # (F_local, S)
            dev = x_local.device
            S = x_local.shape[-1]
            # left halo: last parsiz samples of the left neighbour
            halo = (row[c - 1][..., -parsiz:].to(dev) if c
                    else x_local.new_zeros(x_local.shape[0], parsiz))
            xa = torch.cat([halo, x_local], dim=-1)  # (F_local, parsiz + S)

            # h[m] for local m: linear conv of xa sliced to the owned range
            spectra = offline_fir_spectrum(geom, dev)[None]
            h_local = partitioned_convolve(
                xa, spectra, parsiz)[..., parsiz : parsiz + S]
            b0_local = xa[..., parsiz - firlen : parsiz - firlen + S]
            cs = all_angle_cos_sin(dev)
            if c == 0:
                # the first parsiz positions belong to the start block ->
                # out of the aligned sweep (they pair with pre-file zeros)
                mask = (torch.arange(S, device=dev) >= parsiz).to(
                    torch.float32)
                peaks = rotate_peak_sweep_kernel(
                    b0_local * mask, h_local * mask, cs, tile_len=chunk)
                # start-region contribution: |sin| * max|h[firlen:parsiz]|
                h_start = h_local[..., firlen:parsiz].abs().amax(dim=-1)
                peaks = torch.maximum(peaks,
                                      cs[1].abs() * h_start[..., None])
            else:
                peaks = rotate_peak_sweep_kernel(b0_local, h_local, cs,
                                                 tile_len=chunk)
            parts.append(peaks)
            x_peaks.append(x_local.abs().amax(dim=-1))
        first = parts[0].device
        peaks, x_peak = parts[0], x_peaks[0]
        for p, xp in zip(parts[1:], x_peaks[1:]):
            peaks = torch.maximum(peaks, p.to(first))
            x_peak = torch.maximum(x_peak, xp.to(first))
        # rot0 is the maximum over the shards, taken before slot 0 goes
        # to the raw input peak
        rot0 = peaks[..., 0].clone()
        peaks[..., 0] = x_peak
        rows.append((peaks, rot0))
    first = rows[0][0].device
    peaks = torch.cat([p.to(first) for p, _ in rows])
    rot0 = torch.cat([r.to(first) for _, r in rows])
    if squeeze:
        return peaks[0], rot0[0]
    return peaks, rot0


def sharded_rotate(
    x,
    degrees,
    mesh: Mesh,
    firlen: int = 3072,
    axis: str = "samples",
    file_axis: Optional[str] = None,
):
    """Sequence-parallel whole-file FIR rotation: one long signal's sample
    axis sharded across the mesh, each device convolving its shard with a
    two-sided ``firlen/2`` halo copied from its neighbours, then mixing
    locally.  No device ever holds more than its shard and halos: the
    result is assembled on the CPU from the shards' copies, so a
    multi-hour master rotates at O(shard) memory per device.

    Matches :func:`phaserotate_tpu_torch.ops.rotate_fir` (edge devices'
    zero halos reproduce its zero-padded boundary).

    Args:
      x: (n,) or (files, n) float32.
      degrees: scalar or (files,) rotation angle(s).
      firlen: FIR taps (the stream geometry of the target rate).
      file_axis: mesh axis name for the files dim (2-D mesh composition).

    Returns the rotated signal(s) as a CPU tensor, same shape,
    time-aligned.
    """
    lat = firlen // 2
    grid = mesh.grid(file_axis, axis)
    n_dev = grid.shape[1]
    x = _f32(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    n = x.shape[-1]
    n_files = x.shape[0]
    S = -(-n // n_dev)
    if S < lat:
        raise ValueError(
            f"shard size {S} < halo {lat}; use fewer devices or a "
            "longer signal")
    shards = _sample_shards(
        torch.nn.functional.pad(x, (0, S * n_dev - n)), grid)
    turns = degrees_to_turns(_f32(degrees)).broadcast_to((n_files,))
    per = n_files // grid.shape[0]

    outs = {}
    for r, row in enumerate(shards):
        for c, x_local in enumerate(row):  # (F_local, S)
            dev = x_local.device
            zeros = x_local.new_zeros(x_local.shape[0], lat)
            left = row[c - 1][..., -lat:].to(dev) if c else zeros
            right = row[c + 1][..., :lat].to(dev) if c + 1 < n_dev else zeros
            xa = torch.cat([left, x_local, right], dim=-1)
            spectra = partition_fir_spectra(firlen, firlen, dev)
            h = partitioned_convolve(
                xa, spectra, firlen)[..., 2 * lat : 2 * lat + S]
            sa, ca = sin_cos_turns(turns[r * per : (r + 1) * per].to(dev))
            outs[r, c] = ca[:, None] * x_local + sa[:, None] * h
    y = torch.empty((n_files, S * n_dev), dtype=torch.float32)
    for (r, c), out in outs.items():  # the only reads of the devices
        y[r * per : (r + 1) * per, c * S : (c + 1) * S].copy_(out)
    y = y[:, :n]
    return y[0] if squeeze else y


def angle_sharded_sweep_peaks(
    x,
    geom: OfflineGeometry,
    mesh: Mesh,
    axis: str = "files",
    chunk: int = 4096,
):
    """Peak table with the ANGLE grid sharded across the mesh — the
    domain's tensor parallelism, completing the axes inventory next to
    data parallelism over files and sequence parallelism over samples.

    The signal goes to every device; each sweeps its MAXSAMPLE/n_dev
    slice of the 0.5-degree candidate grid (the sweep kernel's work
    scales with the slice), and the slices concatenate into the full
    table on the mesh's first device.  Right for short single files where
    neither the file nor the sample axis offers enough parallelism.

    Returns ``(peaks (..., MAXSAMPLE), rot0)`` exactly like
    :func:`phaserotate_tpu_torch.search.sweep.sweep_peaks_aux`.
    """
    devs = mesh.grid(None, axis)[0]
    n_dev = len(devs)
    if MAXSAMPLE % n_dev:
        raise ValueError(
            f"{MAXSAMPLE} angles not divisible by {n_dev} devices")
    a_loc = MAXSAMPLE // n_dev
    x = _f32(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]

    parts = []
    for i, dev in enumerate(devs):
        cs = all_angle_cos_sin(dev)[:, i * a_loc : (i + 1) * a_loc]
        b0, b1, h_start, x_peak = aligned_pair(x.to(dev), geom)
        part = rotate_peak_sweep_kernel(b0, b1, cs.contiguous(),
                                        tile_len=chunk)
        parts.append((torch.maximum(part, cs[1].abs() * h_start[..., None]),
                      x_peak))
    first = devs[0]
    table = torch.cat([p.to(first) for p, _ in parts], dim=-1)
    rot0 = table[..., 0].clone()
    table[..., 0] = parts[0][1]
    if squeeze:
        return table[0], rot0[0]
    return table, rot0
