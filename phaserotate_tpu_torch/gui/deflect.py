"""Meter deflection maps.

A copy of ``phaserotate_tpu/gui/deflect.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy.  Only these lines differ;
``tests/test_torch_io.py`` holds the rest to its source.

The display-space transfer curves of the reference GUI
(gui/phaserotate.c:220-254): level meters span -80..+6.02 dBFS over an
86 dB scale; the gain-difference meter spans +-12 dB over 24 dB.  Pure
functions of (width, value) so any renderer (terminal bars, SVG, a real
toolkit) shares the same geometry.
"""

from __future__ import annotations

import math
from typing import List, Tuple

__all__ = [
    "deflect_dbfs",
    "deflect_meter",
    "deflect_db",
    "deflect_delta",
    "METER_TICKS_DB",
    "DELTA_TICKS_DB",
]

# tick annotation positions of the level meter / delta meter scales
METER_TICKS_DB = (-72, -60, -48, -36, -24, -18, -12, -6, -3, 0, 3, 6)
DELTA_TICKS_DB = (-12, -9, -6, -3, 0, 3, 6, 9, 12)


def deflect_dbfs(w: float, db: float) -> float:
    """dB -> pixels on the -80..+6 dBFS scale (gui/phaserotate.c:221-225)."""
    return w * (db + 80.0) / 86.0


def deflect_meter(w: float, v: float) -> float:
    """Linear level -> pixels, clamped (gui/phaserotate.c:227-237)."""
    if v < 1e-4:  # < -80 dBFS
        return 0.0
    if v > 2.0:  # > +6.02 dBFS
        return float(w)
    return deflect_dbfs(w, 20.0 * math.log10(v))


def deflect_db(w: float, db: float) -> float:
    """dB -> pixels on the +-12 dB delta scale (gui/phaserotate.c:239-242)."""
    return w * (db + 12.0) / 24.0


def deflect_delta(w: float, v: float) -> float:
    """Linear ratio -> pixels, clamped (gui/phaserotate.c:244-254)."""
    if v < 0.252:  # < -12 dB
        return 0.0
    if v > 3.98:  # > +12 dB
        return float(w)
    return deflect_db(w, 20.0 * math.log10(v))
