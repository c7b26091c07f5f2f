"""Interactive terminal UI host: turn the dial while audio runs.

A copy of ``phaserotate_tpu/tui.py``, which holds no JAX: that package's
``__init__`` imports JAX, and this port runs where JAX is absent, so it
keeps its own copy; its relative import reaches the port's own
``hostapp``.  Only these lines differ; ``tests/test_torch_io.py`` holds
the rest to its source.

The framework's counterpart of the reference's OpenGL GUI interaction
loop (gui/phaserotate.c:833-890 dial callbacks, :876-890 click-to-reset,
:1099-1134 ui handshake, :895-1026 layout): a keyboard-driven surface
over the same headless widget models (gui/widgets.DialModel, LinkGroup)
and meter renderer, streaming audio through the plugin in real time and
applying angle changes mid-stream through the click-free interpolation
ramp (src/phaserotate.c:673-709).

Keys:
  left/right    active dial -/+ 0.5 deg (one step)
  up/down       active dial +/- 5 deg  (scroll, step x10 like the GUI
                dial's scroll multiplier)
  tab           switch active channel (stereo)
  l             toggle channel link
  r             reset peak holds (the GUI's click-on-meter)
  0             detent: snap active dial to 0
  q / Esc Esc   quit

Run: ``python -m phaserotate_tpu_torch.hostapp in.wav --ui`` (on
the card).
"""

from __future__ import annotations

import os
import select
import sys
import time
from typing import List, Optional

import numpy as np

from .gui.render import render_channel, render_ruler
from .hostapp import StandaloneHost

__all__ = ["TuiSession", "run_tui"]


class TuiSession:
    """Terminal interaction state machine over a StandaloneHost.

    Separated from the terminal loop so tests can drive keys directly;
    the pty test (tests/test_tui.py) exercises the real loop.
    """

    def __init__(self, host: StandaloneHost, color: Optional[bool] = None):
        self.host = host
        self.ui = host.ui
        self.active = 0  # active dial/channel
        self.running = True
        self._esc = ""  # escape-sequence decoder state
        if color is None:
            color = (os.environ.get("NO_COLOR") is None
                     and sys.stdout.isatty())
        self.color = color
        self.ui.open()

    # -- keys ---------------------------------------------------------------

    def feed(self, data: bytes) -> None:
        """Decode raw terminal bytes (incl. arrow escape sequences)."""
        for ch in data.decode("latin-1"):
            if self._esc:
                self._esc += ch
                if len(self._esc) == 2 and ch != "[":
                    # lone Esc followed by non-CSI: treat Esc-Esc as quit
                    self.handle_key("esc" if ch == "\x1b" else ch)
                    self._esc = ""
                elif len(self._esc) == 3:
                    code = {"C": "right", "D": "left",
                            "A": "up", "B": "down"}.get(ch)
                    if code:
                        self.handle_key(code)
                    self._esc = ""
            elif ch == "\x1b":
                self._esc = ch
            elif ch == "\t":
                self.handle_key("tab")
            else:
                self.handle_key(ch)

    def handle_key(self, key: str) -> None:
        dial = self.ui.dials[self.active]
        if key in ("q", "esc"):
            self.running = False
        elif key == "right":
            dial.set_value(dial.value + dial.step)
        elif key == "left":
            dial.set_value(dial.value - dial.step)
        elif key == "up":
            dial.scroll(+1)
        elif key == "down":
            dial.scroll(-1)
        elif key == "tab":
            self.active = (self.active + 1) % self.ui.n_chn
        elif key == "l":
            self.ui.set_link(not self.ui.link.active)
        elif key == "r":
            self.ui.click_meter()
        elif key == "0":
            dial.reset()

    # -- drawing ------------------------------------------------------------

    def render(self) -> str:
        rows: List[str] = [
            "phaserotate_tpu — interactive host   "
            "(arrows: angle, tab: channel, l: link, r: reset, q: quit)",
            "",
        ]
        for c in range(self.ui.n_chn):
            cur = ">" if c == self.active else " "
            link = "  [linked]" if self.ui.link.active else ""
            rows.append(
                f"{cur} ch{c}  angle {self.ui.dials[c].value:+7.1f} deg"
                f"{link}")
            rows.append(render_channel(self.ui.meters[c], f"ch{c}",
                                       color=self.color))
        # render_channel's row prefix is 9 chars ("  ch0 in  ") before
        # the bar '[' — the ruler must line up under the bar cells
        rows.append(render_ruler(48, indent=9))
        return "\n".join(rows)


def run_tui(
    host: StandaloneHost,
    audio: np.ndarray,
    rate: int,
    block: int,
    loop: bool = True,
    stdin_fd: Optional[int] = None,
    stdout=None,
    max_seconds: Optional[float] = None,
):
    """Stream ``audio`` (channels, n) through the host at ~1x realtime,
    reading keys and redrawing meters until quit (or the file ends when
    ``loop`` is False).

    Returns ``(outs, played)``: the processed blocks and the number of
    input frames actually played.  In ``loop`` mode nothing is retained
    (``outs`` stays empty — an interactive session must not grow memory
    per block) and ``played`` is 0.
    """
    import termios
    import tty

    stdin_fd = sys.stdin.fileno() if stdin_fd is None else stdin_fd
    stdout = sys.stdout if stdout is None else stdout
    session = TuiSession(host)
    n = audio.shape[1]
    channels = audio.shape[0]
    capture = not loop
    outs: List[np.ndarray] = []
    played = 0

    raw = False
    try:
        old = termios.tcgetattr(stdin_fd)
        tty.setcbreak(stdin_fd)
        raw = True
    except (termios.error, OSError):
        old = None  # not a terminal (plain pipe): keys still arrive

    pos = 0
    blocks = 0
    t0 = time.perf_counter()
    try:
        while session.running:
            chunk = np.zeros((channels, block), np.float32)
            m = min(block, n - pos)
            chunk[:, :m] = audio[:, pos : pos + m]
            pos += m
            if capture:
                played = pos
            if pos >= n:
                if loop:
                    pos = 0
                else:
                    session.running = False
            y = session.host.process(chunk)
            if capture:
                outs.append(y)
            session.ui.poll()

            r, _, _ = select.select([stdin_fd], [], [], 0)
            if r:
                data = os.read(stdin_fd, 64)
                if not data:
                    session.running = False
                session.feed(data)

            blocks += 1
            if blocks % 8 == 1:
                stdout.write("\x1b[H\x1b[2J" + session.render() + "\n")
                stdout.flush()

            due = blocks * block / rate
            elapsed = time.perf_counter() - t0
            if max_seconds is not None and elapsed > max_seconds:
                session.running = False
            if due > elapsed:
                time.sleep(min(due - elapsed, 0.05))
    finally:
        session.ui.close()
        # drain the ui_off handshake; captured so a recording's stream
        # stays contiguous
        y = host.process(np.zeros((channels, block), np.float32))
        if capture:
            outs.append(y)
        if raw and old is not None:
            termios.tcsetattr(stdin_fd, termios.TCSADRAIN, old)
        stdout.write("\n")
        stdout.flush()
    return outs, played
