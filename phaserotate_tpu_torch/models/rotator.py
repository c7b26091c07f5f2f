"""High-level rotator models (torch).

Counterpart of ``phaserotate_tpu/models/rotator.py``: the two model
families the reference ships, the real-time streaming processor (plugin
role) and the offline whole-buffer processor.

:class:`PhaseRotator` is the streaming stack — engine + metering +
checkpoint/resume — behind one object.  Host blocks are numpy; the engine
and meter state live on the rotator's ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.angles import degrees_to_turns
from ..core.sizes import StreamGeometry, stream_geometry_for_rate
from ..meter import (
    MeterConfig,
    MeterLevels,
    init_meter_state,
    meter_block,
    meter_falloff,
    reset_peaks,
)
from ..ops.rotate import rotate
from ..stream.checkpoint import load_stream_state, save_stream_state
from ..stream.host import StreamingRotator

__all__ = ["PhaseRotator", "OfflineRotator"]


class PhaseRotator(StreamingRotator):
    """Streaming phase rotator with metering and checkpoint/resume.

    Extends :class:`~phaserotate_tpu_torch.stream.host.StreamingRotator`
    (any host block size) with:

    * the reference's metering per channel — momentary with 0.5 s hold,
      15 dB/s falloff, peak hold, gain-diff min/max
      (src/phaserotate.c:303, 451-509, 832-838) — read via :meth:`levels`;
    * mid-stream checkpointing: :meth:`save` the entire engine carry and
      the host staging, :meth:`load` it in another process (or the JAX
      package) and the output continues bit-identically.

    Example::

        rot = PhaseRotator(rate=48000, channels=2, device="cuda")
        out = rot.process(block, degrees=[35.0, 35.0])
        print(float(rot.levels(0).out_peak))
        rot.save("stream.npz")
    """

    def __init__(
        self,
        rate: float = 48000.0,
        channels: int = 1,
        geom: Optional[StreamGeometry] = None,
        meters: bool = True,
        device=None,
    ):
        super().__init__(rate=rate, channels=channels, geom=geom,
                         device=device)
        self.meters_enabled = meters
        self._mtr_cfg = MeterConfig(rate=self.geom.rate,
                                    latency=self.geom.latency)
        self._reset_meters()

    def _reset_meters(self) -> None:
        c, dev = self.channels, self.device
        self._mtr = init_meter_state(self._mtr_cfg, (c,), dev)
        zeros = torch.zeros(c, device=dev)
        ones = torch.ones(c, device=dev)
        self._levels = MeterLevels(*([zeros] * 6), ones, ones, ones)
        self._falloff = None
        self._fpp = 0

    def reset(self) -> None:
        super().reset()
        if hasattr(self, "_mtr_cfg"):
            self._reset_meters()

    def process(self, block: np.ndarray, degrees) -> np.ndarray:
        squeeze = np.ndim(block) == 1
        x = np.atleast_2d(np.asarray(block, np.float32))
        if self.meters_enabled:
            # the gain-diff holds reset on an angle change, compared
            # against the *current* (possibly still ramping) engine
            # angle like the plugin does (src/phaserotate.c:497-509)
            degs = np.array(np.broadcast_to(
                np.asarray(degrees, np.float32), (self.channels,)))
            target = degrees_to_turns(torch.from_numpy(degs))
            changed = target.to(self.device) != self._state.angle
        out = super().process(x, degrees)
        if self.meters_enabled:
            n = x.shape[1]
            if self._fpp != n:
                self._falloff = meter_falloff(self.geom.rate, n, self.device)
                self._fpp = n
            self._mtr, self._levels = meter_block(
                self._mtr, torch.from_numpy(x).to(self.device),
                torch.from_numpy(np.atleast_2d(out)).to(self.device),
                self._falloff, self._mtr_cfg.hold_samples, changed)
        return out[0] if squeeze and out.ndim > 1 else out

    def levels(self, channel: int = 0) -> MeterLevels:
        """Latest meter levels for ``channel`` (9 fields, the reference's
        'levels' atom payload, src/phaserotate.c:741-771), 0-d tensors."""
        return MeterLevels(*(getattr(self._levels, f.name)[channel]
                             for f in dataclasses.fields(MeterLevels)))

    def reset_peaks(self) -> None:
        """Clear the peak holds (the GUI's click-on-meter)."""
        self._mtr = reset_peaks(self._mtr)

    # -- checkpoint / resume ------------------------------------------------

    def save(self, path: str) -> None:
        """Checkpoint the stream mid-flight: engine carry (all channels)
        plus the host shell's staged partial frame, so resume is
        bit-identical from the very next sample."""
        save_stream_state(path, self._state, self.geom, host={
            "offset": np.int64(self._offset),
            "cur_in": self._cur_in,
            "cur_out": self._cur_out,
        })

    def load(self, path: str) -> None:
        """Resume from a checkpoint saved by :meth:`save` (of this package
        or of the JAX package); output continues bit-identically."""
        state, geom, host = load_stream_state(path, self.device)
        if geom is not None and geom != self.geom:
            raise ValueError(
                f"checkpoint geometry {geom} != rotator geometry "
                f"{self.geom}")
        if tuple(state.angle.shape) != (self.channels,):
            raise ValueError(
                f"checkpoint has {tuple(state.angle.shape)} channels, "
                f"rotator has {self.channels}")
        self._state = state
        if host:
            self._offset = int(host["offset"])
            self._cur_in = np.array(host["cur_in"], np.float32)
            self._cur_out = np.array(host["cur_out"], np.float32)


class OfflineRotator:
    """Whole-buffer rotator with a fixed configuration.

    Example::

        rot = OfflineRotator(rate=48000, method="fir")
        y = rot(x, degrees=35.0)   # a tensor on x's device

    With ``method="fir"`` the FIR is ``geom.firlen`` taps: on CUDA the
    stream_conv kernel for the plugin FIRs, the fused_conv kernel for the
    other FIRs up to 16384 taps (ops/rotate.py).  The input goes to
    ``device`` (``"cpu"`` for the CPU); without it a tensor stays on its
    own device and other input goes to the CUDA device.
    """

    def __init__(self, rate: float = 48000.0, method: str = "spectral",
                 geom: Optional[StreamGeometry] = None, device=None):
        if method not in ("spectral", "fir"):
            raise ValueError(f"unknown method {method!r}")
        self.rate = rate
        self.method = method
        self.geom = geom or stream_geometry_for_rate(rate)
        self.device = device

    def __call__(self, audio, degrees) -> torch.Tensor:
        return rotate(audio, degrees, method=self.method, rate=self.rate,
                      firlen=self.geom.firlen if self.method == "fir"
                      else None, device=self.device)
