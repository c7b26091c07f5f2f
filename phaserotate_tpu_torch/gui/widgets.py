"""UI widget models: angle dial and link behavior.

A copy of ``phaserotate_tpu/gui/widgets.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy.  Only these lines differ;
``tests/test_torch_io.py`` holds the rest to its source.

Headless models of the reference's robtk widgets (gui/phaserotate.c:
920-954): a rotary dial spanning -180..180 in 0.5-degree steps with a
detent at 0 and 360-degree wrap mode, and the Link checkbox that slaves
channel 1's dial to channel 0's absolute value and disables it
(gui/phaserotate.c:846-874).  Renderer-independent so the terminal UI and
tests drive the same logic the GUI would.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

__all__ = ["DialModel", "LinkGroup"]


@dataclasses.dataclass
class DialModel:
    """Angle dial: min -180, max 180, step 0.5, default/detent 0,
    scroll multiplier 10, wraparound (threesixty) mode."""

    value: float = 0.0
    minimum: float = -180.0
    maximum: float = 180.0
    step: float = 0.5
    default: float = 0.0
    detent: bool = True
    scroll_mult: float = 10.0
    sensitive: bool = True
    on_change: Optional[Callable[[float], None]] = None

    def _quantize(self, v: float) -> float:
        return round(v / self.step) * self.step

    def set_value(self, v: float, *, notify: bool = True) -> None:
        """Set with 360-degree wraparound and detent snap."""
        if not self.sensitive:
            return
        # Control-port values arrive from the host/wire and can be
        # garbage: NaN/inf would raise inside round(), and a huge finite
        # value would spin an iterative wrap, so reject non-finite and
        # wrap in O(1) with fmod.
        if not math.isfinite(v):
            return
        # threesixty wrap FIRST: fmod is exact, so huge-but-finite
        # values (1e308) reduce safely, whereas quantizing first
        # overflows round().  The wrap shifts by exact multiples of the
        # span (itself a multiple of the step), so wrap and quantize
        # commute for on-grid values; off-grid values near the seam need
        # the edge rule re-applied AFTER quantizing (below), or 180.2
        # wraps to -179.8 and quantizes to -180.0 where quantize-then-
        # wrap would display 180.0.
        span = self.maximum - self.minimum
        came_from_above = v > self.maximum
        if v > self.maximum or v < self.minimum:
            v = math.fmod(v - self.minimum, span)
            if v < 0:
                v += span
            v += self.minimum
            # wrapping down from above lands on `maximum`, never on the
            # equivalent `minimum` (matches the iterative definition)
            if v == self.minimum and came_from_above:
                v = self.maximum
        # detent: raw values within one step of the default stick to it
        # (robtk_dial_set_detent_default, gui/phaserotate.c:944)
        if self.detent and abs(v - self.default) < self.step:
            v = self.default
        v = self._quantize(v)
        if v == self.minimum and came_from_above:
            v = self.maximum
        if v != self.value:
            self.value = v
            if notify and self.on_change:
                self.on_change(v)

    def scroll(self, steps: int) -> None:
        """Mouse-wheel: step * scroll_mult per notch."""
        self.set_value(self.value + steps * self.step * self.scroll_mult)

    def reset(self) -> None:
        self.set_value(self.default)


class LinkGroup:
    """Link checkbox semantics (gui/phaserotate.c:846-874): while active,
    dial[1] mirrors dial[0]'s absolute value and is insensitive."""

    def __init__(self, dials: List[DialModel]):
        self.dials = dials
        self.active = False
        for i, d in enumerate(self.dials):
            prev = d.on_change
            d.on_change = self._make_handler(i, prev)

    def _make_handler(self, idx: int, prev):
        def handler(v: float):
            if self.active and idx == 0 and len(self.dials) > 1:
                d1 = self.dials[1]
                d1.sensitive = True
                d1.set_value(v)
                d1.sensitive = False
            if prev:
                prev(v)

        return handler

    def set_active(self, active: bool) -> None:
        self.active = active
        if len(self.dials) > 1:
            if active:
                # immediate sync then freeze (btn_link,
                # gui/phaserotate.c:864-874)
                self.dials[1].sensitive = True
                self.dials[1].set_value(self.dials[0].value)
                self.dials[1].sensitive = False
            else:
                self.dials[1].sensitive = True
