"""Headless UI layer: deflection maps, widget models, protocol client,
terminal/SVG rendering.

A copy of ``phaserotate_tpu/gui/__init__.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy; its relative imports reach the port's
own ``gui.client``.  Only these lines differ; ``tests/test_torch_io.py``
holds the rest to its source.
"""

from .client import MeterValues, UIClient
from .deflect import (
    DELTA_TICKS_DB,
    METER_TICKS_DB,
    deflect_db,
    deflect_dbfs,
    deflect_delta,
    deflect_meter,
)
from .render import (
    faceplate_svg,
    meter_pattern,
    meter_svg,
    render_channel,
    render_ruler,
    render_delta_bar,
    render_meter_bar,
)
from .widgets import DialModel, LinkGroup

__all__ = [
    "DELTA_TICKS_DB",
    "DialModel",
    "LinkGroup",
    "METER_TICKS_DB",
    "MeterValues",
    "UIClient",
    "deflect_db",
    "deflect_dbfs",
    "deflect_delta",
    "deflect_meter",
    "faceplate_svg",
    "meter_pattern",
    "meter_svg",
    "render_channel",
    "render_ruler",
    "render_delta_bar",
    "render_meter_bar",
]
