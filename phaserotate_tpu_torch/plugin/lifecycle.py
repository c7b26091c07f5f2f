"""Plugin lifecycle: the host-facing runtime shell (torch).

Counterpart of ``phaserotate_tpu/plugin/lifecycle.py``: the LV2 plugin ABI
surface (src/phaserotate.c:860-893 — instantiate / connect_port / activate
/ run / cleanup) as a Python class driving the port's streaming engine, so
an audio host (the standalone hostapp, tests, or the bridge daemon) gets
the reference's contract:

* URI-based mono/stereo dispatch (src/phaserotate.c:233-240);
* option-driven UI scale, clamped 1..2 (:261-276);
* port connect demux into (angle, in, out) triplets (:430-448);
* all engine state built at instantiate; run() stages samples and
  dispatches the per-frame steps;
* latency reporting, in-place buffer handling (:780-788);
* control/notify message queues carrying the protocol of protocol.py;
* per-channel metering with UI level notifications (:741-771).

The engine carry lives on the plugin's device: the card unless the
``device`` option asks for another (an int indexes the CUDA devices,
``"cpu"`` is the CPU).  The meters stay on the host CPU, as the JAX plugin
keeps them: run() reads 9 level fields per channel every block, which on
the card would be a synchronization each.  They run in the meter module's
numpy twins (``host_meter_block``), bit-equal to its torch functions: a
daemon serves many plugins from many threads, and each torch op would hand
the GIL over and back.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.angles import degrees_to_turns_np
from ..core.device import indexed_device
from ..core.sizes import stream_geometry_for_rate
from ..meter import (
    MeterConfig,
    host_meter_block,
    host_meter_state,
    host_reset_peaks,
    meter_falloff,
)
from ..stream.engine import host_angle_step, init_state
from ..stream.host import OutputPipeline, advance_stream
from .protocol import LevelsMsg, Message, ResetPeaks, StateMsg, UiOff, UiOn
from .uris import (
    MAX_CHANNELS,
    PLUGIN_URI,
    PLUGIN_URI_STEREO,
    PortIndex,
    port_channel,
    port_role,
)

__all__ = ["PhaseRotatePlugin", "descriptors"]

_LEVEL_FIELDS = ("in_cur", "in_mom", "in_peak", "out_cur", "out_mom",
                 "out_peak", "diff_cur", "diff_min", "diff_max")


def descriptors() -> tuple:
    """The two plugin URIs, in descriptor order
    (src/phaserotate.c:879-893)."""
    return (PLUGIN_URI, PLUGIN_URI_STEREO)


class PhaseRotatePlugin:
    """One plugin instance (the reference's ``FFTiProc``)."""

    def __init__(self, uri: str, rate: float,
                 options: Optional[Dict[str, float]] = None):
        if uri == PLUGIN_URI:
            self.n_chn = 1
        elif uri == PLUGIN_URI_STEREO:
            self.n_chn = 2
        else:
            raise ValueError(f"unknown plugin URI {uri!r}")
        options = options or {}

        self.rate = float(rate)
        self.geom = stream_geometry_for_rate(rate)

        # dispatch pipelining (stream/host.py module docstring): trade
        # `pipeline` frames of extra latency for per-block readbacks that
        # always have pipeline-depth slack
        self.pipeline_depth = max(0, int(options.get("pipeline", 0)))
        # cross-session batched dispatch (stream/broker.py): a shared
        # StreamBroker advances many plugin instances in one device step
        # — the daemon's serving mode.  The broker's pipelining replaces
        # the per-instance pipeline (latency accounting identical).
        self._broker = options.get("broker")
        self._slot: Optional[int] = None
        if self._broker is not None:
            if (self._broker.geom != self.geom
                    or self._broker.channels != self.n_chn):
                raise ValueError(
                    "broker geometry/channels do not match this instance")
            self.pipeline_depth = self._broker.depth
        # placement: the engine carry on the named device makes every
        # step of this instance run there — the daemon spreads sessions
        # over the cards this way (multi-card serving without sharding)
        if self._broker is not None and "device" not in options:
            self.device = self._broker.device
        else:
            self.device = indexed_device(options.get("device"))
        self.latency = (self.geom.latency
                        + self.pipeline_depth * self.geom.parsiz)

        # ui:scaleFactor option, clamped 1..2 (src/phaserotate.c:
        # 261-276).  Intent deviation: the reference then resets
        # ui_scale to 1.0 a few lines later (:299-300), so the option
        # is dead in its DSP instance; the clamped value is applied —
        # pinned both ways by tests/test_ref_plugin_binary.py.
        self.ui_scale = 1.0
        if "ui_scale" in options:
            self.ui_scale = float(np.clip(options["ui_scale"], 1.0, 2.0))
        self.link = False
        self.ui_active = False
        self._send_state = False

        self._mtr_cfg = MeterConfig(rate=self.rate, latency=self.latency)
        self._falloff = None
        self._fpp = 0

        # ports
        self._control: Optional[List[Message]] = None
        self._notify: Optional[List[Message]] = None
        self._latency_port: Optional[np.ndarray] = None
        self._angle = [None] * MAX_CHANNELS
        self._in = [None] * MAX_CHANNELS
        self._out = [None] * MAX_CHANNELS

        self._init_dsp()

    # -- lifecycle ---------------------------------------------------------

    def _init_dsp(self) -> None:
        parsiz = self.geom.parsiz
        if self._broker is not None:
            # engine state lives in the broker's slot axis; (re)opening
            # resets it at the next shared dispatch
            if self._slot is None:
                self._slot = self._broker.open()
            else:
                self._broker.reset(self._slot)
            self._state = None
        else:
            # channels ride a leading batch dim: one step per frame for
            # mono and stereo (the reference spawns a thread per channel,
            # cli/phase-rotate.cc:437-444)
            self._state = init_state(self.geom, (self.n_chn,), self.device)
        # every channel's meters in one host state (leading dim)
        self._mtr = host_meter_state(self._mtr_cfg, (self.n_chn,))
        self._offset = 0
        self._cur_in = np.zeros((self.n_chn, parsiz), np.float32)
        self._cur_out = np.zeros((self.n_chn, parsiz), np.float32)
        self._pipe = (OutputPipeline(self.pipeline_depth, self.n_chn,
                                     parsiz)
                      if self.pipeline_depth > 0 else None)
        # host-side shadow of the device angle carry (negated turns) —
        # the pipelined path must not read device state synchronously
        self._angle_shadow = np.zeros(self.n_chn, np.float32)

    def connect_port(self, port: int, data) -> None:
        """src/phaserotate.c:409-448."""
        if port == PortIndex.ATOM_CONTROL:
            self._control = data
            return
        if port == PortIndex.ATOM_NOTIFY:
            self._notify = data
            return
        if port == PortIndex.LATENCY:
            self._latency_port = data
            return
        chn = port_channel(port)
        if chn < 0 or chn >= MAX_CHANNELS:
            return
        role = port_role(port)
        if role == "angle":
            self._angle[chn] = data
        elif role == "input":
            self._in[chn] = data
        else:
            self._out[chn] = data

    def activate(self) -> None:
        """Reset all streaming/meter state (src/phaserotate.c:511-520)."""
        self._init_dsp()

    def cleanup(self) -> None:
        """Release the broker slot (if any); other state is freed by the
        garbage collector — ABI parity with src/phaserotate.c:179-223."""
        if self._broker is not None and self._slot is not None:
            self._broker.close(self._slot)
            self._slot = None

    # -- run ---------------------------------------------------------------

    def _handle_control(self) -> None:
        """src/phaserotate.c:800-830."""
        assert self._control is not None
        for msg in self._control:
            if isinstance(msg, UiOff):
                self.ui_active = False
            elif isinstance(msg, UiOn):
                self.ui_active = True
                self._send_state = True
            elif isinstance(msg, ResetPeaks):
                self._mtr = host_reset_peaks(self._mtr)
            elif isinstance(msg, StateMsg):
                self.ui_scale = msg.uiscale
                self.link = msg.link
        self._control.clear()

    def run(self, n_samples: int) -> None:
        """Process one host block (src/phaserotate.c:774-852)."""
        # forward no-inplace buffers
        for c in range(self.n_chn):
            if self._in[c] is not self._out[c]:
                self._out[c][:n_samples] = self._in[c][:n_samples]

        if self._latency_port is not None:
            self._latency_port[0] = self.latency

        if self._control is None or self._notify is None:
            # latency measurement callback (src/phaserotate.c:790-793)
            return

        self._handle_control()

        if self._fpp != n_samples:
            self._falloff = meter_falloff(self.rate, n_samples).item()
            self._fpp = n_samples

        self._process_block(n_samples)

        if self.ui_active and self._send_state:
            self._send_state = False
            self._notify.append(
                StateMsg(uiscale=self.ui_scale, link=self.link))

    def _process_block(self, n: int) -> None:
        """src/phaserotate.c:538-772 with the DSP on the device.

        All channels advance through one batched ``stream_step`` per
        completed ``parsiz`` frame (the reference runs a serial
        per-channel loop; here the channel dim batches the FFTs).
        """
        geom = self.geom
        n_chn = self.n_chn

        target_deg = np.array(
            [float(self._angle[c][0]) if self._angle[c] is not None else 0.0
             for c in range(n_chn)], np.float32)
        # raw input (pre-process), copied: the port buffer is rewritten
        in_copies = np.stack([np.array(self._out[c][:n], np.float32)
                              for c in range(n_chn)])

        target_turns = degrees_to_turns_np(target_deg)
        if self._broker is not None or self._pipe is not None:
            angle_now = self._angle_shadow  # no synchronous device read
        else:
            angle_now = self._state.angle.cpu().numpy()  # one readback
        angle_changed = target_turns != angle_now

        # block staging identical to the reference's offset bookkeeping,
        # shared with StreamingRotator (stream/host.advance_stream)
        offset_before = self._offset
        x_in = np.stack([self._out[c][:n] for c in range(n_chn)])
        if self._broker is not None:
            from ..stream.broker import advance_stream_brokered

            self._offset, y_out = advance_stream_brokered(
                self._broker, self._slot, self._cur_in, self._cur_out,
                self._offset, x_in, target_deg)
        else:
            self._state, self._offset, y_out = advance_stream(
                self._state, self._cur_in, self._cur_out, self._offset,
                x_in, target_deg, geom, pipe=self._pipe)
        if self._broker is not None or self._pipe is not None:
            a = self._angle_shadow
            for _ in range((offset_before + n) // geom.parsiz):
                a = host_angle_step(a, target_turns, geom)
            self._angle_shadow = a
        for c in range(n_chn):
            self._out[c][:n] = y_out[c]

        # metering (src/phaserotate.c:573-611, 728-771), every channel in
        # one call; the output is copied too (np.array, never a view of
        # the port buffer the host rewrites next run())
        self._mtr, lv = host_meter_block(
            self._mtr, in_copies,
            np.stack([np.array(self._out[c][:n], np.float32)
                      for c in range(n_chn)]),
            self._falloff, self._mtr_cfg.hold_samples, angle_changed)
        if self.ui_active:
            rows = np.stack([getattr(lv, f) for f in _LEVEL_FIELDS],
                            axis=-1).tolist()
            for c in range(n_chn):
                self._notify.append(LevelsMsg(c, *rows[c]))
