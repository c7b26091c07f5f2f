"""UI-side protocol client.

A copy of ``phaserotate_tpu/gui/client.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy; its relative imports reach the port's
own ``plugin.lifecycle``.  Only these lines differ;
``tests/test_torch_io.py`` holds the rest to its source.

The headless equivalent of the GUI's port_event dispatch and write hooks
(gui/phaserotate.c:833-890, 1099-1134, 1236-1309): consumes the plugin's
notify queue into per-channel meter arrays, forwards dial moves to the
angle control ports, sends the ui_on/ui_off handshake, reset_peaks on
meter clicks, and persists uiscale/link through state messages.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..plugin.lifecycle import PhaseRotatePlugin
from ..plugin.protocol import (
    LevelsMsg,
    ResetPeaks,
    StateMsg,
    UiOff,
    UiOn,
)
from .widgets import DialModel, LinkGroup

__all__ = ["MeterValues", "UIClient"]


@dataclasses.dataclass
class MeterValues:
    """One channel's displayed meter state (9 level fields)."""

    in_cur: float = 0.0
    in_mom: float = 0.0
    in_peak: float = 0.0
    out_cur: float = 0.0
    out_mom: float = 0.0
    out_peak: float = 0.0
    diff_cur: float = 1.0
    diff_min: float = 1.0
    diff_max: float = 1.0


class UIClient:
    """Drives a :class:`PhaseRotatePlugin`'s UI-facing surface."""

    def __init__(self, plugin: PhaseRotatePlugin):
        self.plugin = plugin
        self.n_chn = plugin.n_chn
        self.meters = [MeterValues() for _ in range(self.n_chn)]
        self.ui_scale = 1.0
        self.dials = [
            DialModel(on_change=self._angle_writer(c))
            for c in range(self.n_chn)
        ]
        self.link = LinkGroup(self.dials)
        self._open = False
        self.sync_dials()

    def sync_dials(self) -> None:
        """Pull the current angle control-port values into the dials
        (the control-port half of the reference's port_event dispatch,
        gui/phaserotate.c:1236-1248) without echoing them back."""
        for c in range(self.n_chn):
            port = self.plugin._angle[c]
            if port is not None:
                self.dials[c].set_value(float(port[0]), notify=False)

    def _control_queue(self):
        q = self.plugin._control
        if q is None:
            raise RuntimeError(
                "plugin control port not connected (connect_port the "
                "ATOM_CONTROL port before driving the UI)")
        return q

    # -- writes to the plugin ---------------------------------------------

    def _angle_writer(self, chn: int):
        def write(value: float):
            port = self.plugin._angle[chn]
            if port is not None:
                port[0] = value

        return write

    def open(self) -> None:
        """ui_on handshake (gui/phaserotate.c:1099-1111); also pulls the
        current port angles into the dials (a reopened UI must show the
        host-persisted angle, not zero)."""
        self._control_queue().append(UiOn())
        self.sync_dials()
        self._open = True

    def close(self) -> None:
        """ui_off + persist state (gui/phaserotate.c:1113-1127)."""
        q = self._control_queue()
        q.append(StateMsg(uiscale=self.ui_scale, link=self.link.active))
        q.append(UiOff())
        self._open = False

    def set_link(self, active: bool) -> None:
        self.link.set_active(active)
        self._control_queue().append(
            StateMsg(uiscale=self.ui_scale, link=active))

    def set_scale(self, scale: float) -> None:
        """Scale change persistence (gui/phaserotate.c:1080-1097)."""
        scale = float(scale)
        if not np.isfinite(scale):
            return  # np.clip passes NaN through; don't poison ui_scale
        self.ui_scale = float(np.clip(scale, 1.0, 2.0))
        self._control_queue().append(
            StateMsg(uiscale=self.ui_scale, link=self.link.active))

    def click_meter(self) -> None:
        """Click on a meter resets peak holds
        (gui/phaserotate.c:876-890)."""
        self._control_queue().append(ResetPeaks())

    # -- reads from the plugin --------------------------------------------

    def poll(self) -> None:
        """Drain the notify queue (port_event,
        gui/phaserotate.c:1236-1309)."""
        notify = self.plugin._notify
        if notify is None:
            return
        for msg in notify:
            if isinstance(msg, LevelsMsg):
                m = self.meters[msg.channel]
                for f in ("in_cur", "in_mom", "in_peak", "out_cur",
                          "out_mom", "out_peak", "diff_cur", "diff_min",
                          "diff_max"):
                    setattr(m, f, getattr(msg, f))
            elif isinstance(msg, StateMsg):
                self.ui_scale = msg.uiscale
                if msg.link != self.link.active:
                    self.link.set_active(msg.link)
        notify.clear()
