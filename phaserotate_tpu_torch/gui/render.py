"""Meter and faceplate rendering.

A copy of ``phaserotate_tpu/gui/render.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy.  Only these lines differ;
``tests/test_torch_io.py`` holds the rest to its source.

Render targets replacing the reference's cairo drawing
(gui/phaserotate.c:218-759 meters, :117-177 dial faceplates):

* ANSI terminal bars for the standalone host's live display — the same
  deflection geometry, peak-hold markers and bidirectional gain-delta
  bar; optionally 256-color with the level-meter gradient;
* cached per-width "patterns" (gradient cell colors + tick positions),
  the role of the reference's pre-rendered cairo gradient surfaces
  (create_meter_pattern / create_meter_ticks, gui/phaserotate.c:256-532)
  — computed once per width, reused every frame;
* SVG meter widget (gradient bar, tick marks with dB labels, momentary
  cap, peak-hold line, bidirectional delta bar) and SVG dial faceplate
  with tick dots and labels at 45-degree marks (prepare_faceplates).
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

from .client import MeterValues
from .deflect import (
    DELTA_TICKS_DB,
    METER_TICKS_DB,
    deflect_db,
    deflect_delta,
    deflect_dbfs,
    deflect_meter,
)

__all__ = [
    "render_meter_bar",
    "render_delta_bar",
    "render_channel",
    "render_ruler",
    "meter_pattern",
    "meter_svg",
    "faceplate_svg",
]

# level-meter gradient color stops in dBFS: green up to -18, yellow to
# -9, orange to -3, red above — the standard program-meter zones the
# reference's gradient pattern encodes (gui/phaserotate.c:256-330 role)
_GRADIENT_STOPS_DB: Tuple[Tuple[float, str, int], ...] = (
    (-18.0, "#2a2", 34),   # green  (xterm-256 34)
    (-9.0, "#cc2", 184),   # yellow (184)
    (-3.0, "#e82", 208),   # orange (208)
    (6.0, "#e33", 196),    # red    (196)
)


@functools.lru_cache(maxsize=16)
def meter_pattern(width: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Cached per-width meter pattern.

    Returns ``(cell_colors, tick_cells)``: an xterm-256 color index per
    bar cell (the gradient), and the cell index of every dB tick from
    METER_TICKS_DB.  Computed once per width like the reference caches
    its cairo pattern surfaces per size (gui/phaserotate.c:256-330).
    """
    colors = []
    for i in range(width):
        # cell center position -> dB on the -80..+6 scale
        db = (i + 0.5) * 86.0 / width - 80.0
        for stop_db, _, xterm in _GRADIENT_STOPS_DB:
            if db <= stop_db:
                colors.append(xterm)
                break
        else:
            colors.append(_GRADIENT_STOPS_DB[-1][2])
    ticks = tuple(
        int(deflect_dbfs(width, db)) for db in METER_TICKS_DB
        if 0 <= int(deflect_dbfs(width, db)) < width
    )
    return tuple(colors), ticks


def render_ruler(width: int = 60, indent: int = 8) -> str:
    """dB scale row aligned under the meter bars (create_meter_ticks
    role, gui/phaserotate.c:332-430): tick marks with labels."""
    _, ticks = meter_pattern(width)
    cells = [" "] * width
    for t in ticks:
        cells[t] = "'"
    row = " " * indent + "[" + "".join(cells) + "]"
    labels = [" "] * (width + 2)
    for db, t in zip(
        [d for d in METER_TICKS_DB
         if 0 <= int(deflect_dbfs(width, d)) < width], ticks
    ):
        text = str(db)
        start = max(0, min(t + 1 - len(text) // 2, width + 2 - len(text)))
        for j, ch in enumerate(text):
            labels[start + j] = ch
    return row + "\n" + " " * indent + "".join(labels)


def render_meter_bar(value: float, momentary: float, peak: float,
                     width: int = 60, color: bool = False) -> str:
    """One level meter line: live bar, momentary cap, peak-hold marker
    (the drawing logic of gui/phaserotate.c:534-615).  With ``color``
    the live bar uses the cached gradient pattern (256-color ANSI)."""
    cells = [" "] * width
    live = int(deflect_meter(width, value))
    for i in range(min(live, width)):
        cells[i] = "="
    mom = int(deflect_meter(width, momentary))
    if 0 < mom <= width:
        cells[mom - 1] = "#"
    pk = int(deflect_meter(width, peak))
    if 0 < pk <= width:
        cells[pk - 1] = "|"
    if color:
        colors, ticks = meter_pattern(width)
        for t in ticks:
            if cells[t] == " ":
                cells[t] = "."
        out = []
        for i, ch in enumerate(cells):
            if ch in ("=", "#"):
                out.append(f"\x1b[38;5;{colors[i]}m{ch}\x1b[0m")
            elif ch == "|":
                out.append(f"\x1b[1m{ch}\x1b[0m")
            else:
                out.append(ch)
        return "[" + "".join(out) + "]"
    return "[" + "".join(cells) + "]"


def render_delta_bar(cur: float, dmin: float, dmax: float,
                     width: int = 60) -> str:
    """Bidirectional gain-diff bar around the 0 dB center
    (gui/phaserotate.c:617-727)."""
    cells = [" "] * width
    center = int(deflect_db(width, 0.0))
    lo = int(deflect_delta(width, dmin))
    hi = int(deflect_delta(width, dmax))
    for i in range(min(lo, center), center):
        cells[i] = "-"
    for i in range(center, min(hi, width)):
        cells[i] = "+"
    cur_pos = int(deflect_delta(width, cur))
    if 0 <= cur_pos < width:
        cells[cur_pos] = "#"
    if 0 <= center < width:
        cells[center] = "|" if cells[center] == " " else cells[center]
    return "[" + "".join(cells) + "]"


def _db(v: float) -> str:
    if v < 1e-10:
        return "  -inf"
    return f"{20 * math.log10(v):6.1f}"


def render_channel(m: MeterValues, label: str = "", width: int = 48,
                   color: bool = False) -> str:
    """Three meter rows for one channel: in, out, gain-diff."""
    rows = [
        f"{label:>4} in  {render_meter_bar(m.in_cur, m.in_mom, m.in_peak, width, color)} {_db(m.in_peak)} dBFS",
        f"{'':>4} out {render_meter_bar(m.out_cur, m.out_mom, m.out_peak, width, color)} {_db(m.out_peak)} dBFS",
        f"{'':>4} +/- {render_delta_bar(m.diff_cur, m.diff_min, m.diff_max, width)}",
    ]
    return "\n".join(rows)


def meter_svg(m: MeterValues, width: int = 240, bar_h: int = 12) -> str:
    """One channel's meters as a standalone SVG widget: gradient level
    bars with momentary cap and peak-hold line, dB tick ruler, and the
    bidirectional gain-delta bar — the full drawing surface of
    gui/phaserotate.c:256-727 on a vector target."""
    h = bar_h * 3 + 26
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width + 40}" '
        f'height="{h}" viewBox="0 0 {width + 40} {h}">',
        '<defs><linearGradient id="lvl" x1="0" y1="0" x2="1" y2="0">',
    ]
    for stop_db, color, _ in _GRADIENT_STOPS_DB:
        off = deflect_dbfs(1.0, stop_db)
        parts.append(
            f'<stop offset="{max(0.0, min(1.0, off)):.3f}" '
            f'stop-color="{color}"/>')
    parts.append("</linearGradient></defs>")

    def bar(y: int, cur: float, mom: float, peak: float) -> None:
        parts.append(
            f'<rect x="20" y="{y}" width="{width}" height="{bar_h}" '
            'fill="#222"/>')
        live = deflect_meter(width, cur)
        parts.append(
            f'<rect x="20" y="{y}" width="{live:.1f}" height="{bar_h}" '
            'fill="url(#lvl)"/>')
        momx = deflect_meter(width, mom)
        if momx > 0:
            parts.append(
                f'<rect x="{20 + momx - 1.5:.1f}" y="{y}" width="3" '
                f'height="{bar_h}" fill="#eee"/>')
        pkx = deflect_meter(width, peak)
        if pkx > 0:
            parts.append(
                f'<rect x="{20 + pkx - 1:.1f}" y="{y}" width="2" '
                f'height="{bar_h}" fill="#f44"/>')

    bar(2, m.in_cur, m.in_mom, m.in_peak)
    bar(bar_h + 4, m.out_cur, m.out_mom, m.out_peak)

    # delta bar around the 0 dB center (gui/phaserotate.c:617-727)
    y = 2 * bar_h + 6
    parts.append(
        f'<rect x="20" y="{y}" width="{width}" height="{bar_h}" '
        'fill="#222"/>')
    center = deflect_db(width, 0.0)
    lo = deflect_delta(width, m.diff_min)
    hi = deflect_delta(width, m.diff_max)
    parts.append(
        f'<rect x="{20 + min(lo, center):.1f}" y="{y}" '
        f'width="{abs(center - lo):.1f}" height="{bar_h}" fill="#28c"/>')
    parts.append(
        f'<rect x="{20 + center:.1f}" y="{y}" '
        f'width="{max(0.0, hi - center):.1f}" height="{bar_h}" '
        'fill="#2c8"/>')
    parts.append(
        f'<rect x="{20 + center - 0.5:.1f}" y="{y}" width="1" '
        f'height="{bar_h}" fill="#fff"/>')

    # tick ruler with labels
    ry = 3 * bar_h + 8
    for db in METER_TICKS_DB:
        x = 20 + deflect_dbfs(width, db)
        if 20 <= x <= 20 + width:
            parts.append(
                f'<line x1="{x:.1f}" y1="{ry}" x2="{x:.1f}" '
                f'y2="{ry + 4}" stroke="#999" stroke-width="1"/>')
            parts.append(
                f'<text x="{x:.1f}" y="{ry + 13}" font-size="7" '
                f'fill="#bbb" text-anchor="middle">{db}</text>')
    parts.append("</svg>")
    return "".join(parts)


def faceplate_svg(size: int = 120, radius: float = 40.0,
                  angle: Optional[float] = None) -> str:
    """Dial faceplate: shaded knob, tick dots at 45-degree marks with
    labels (prepare_faceplates, gui/phaserotate.c:117-177); with
    ``angle`` (degrees) it also draws the pointer line, a value arc from
    the 0-detent, and the numeric readout — the full rendered dial, not
    just the static plate."""
    cx = cy = size / 2.0
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" '
        f'height="{size}" viewBox="0 0 {size} {size}">',
        '<defs><radialGradient id="knob" cx="0.35" cy="0.3" r="1.0">'
        '<stop offset="0" stop-color="#666"/>'
        '<stop offset="1" stop-color="#333"/></radialGradient></defs>',
        f'<circle cx="{cx}" cy="{cy}" r="{radius * 0.72:.1f}" '
        'fill="url(#knob)" stroke="#999" stroke-width="1.5"/>',
    ]
    if angle is not None:
        ang = math.radians(angle - 90.0)
        r_in = radius * 0.72
        # value arc from the 0 detent (12 o'clock) to the pointer
        a0, a1 = (-90.0, angle - 90.0) if angle >= 0 else \
            (angle - 90.0, -90.0)
        large = 1 if abs(angle) > 180 else 0
        sx = cx + (radius - 3) * math.cos(math.radians(a0))
        sy = cy + (radius - 3) * math.sin(math.radians(a0))
        ex = cx + (radius - 3) * math.cos(math.radians(a1))
        ey = cy + (radius - 3) * math.sin(math.radians(a1))
        if abs(angle) > 0.05:
            parts.append(
                f'<path d="M {sx:.1f} {sy:.1f} A {radius - 3:.1f} '
                f'{radius - 3:.1f} 0 {large} 1 {ex:.1f} {ey:.1f}" '
                'fill="none" stroke="#4c8" stroke-width="2.5"/>')
        px = cx + r_in * 0.92 * math.cos(ang)
        py = cy + r_in * 0.92 * math.sin(ang)
        parts.append(
            f'<line x1="{cx}" y1="{cy}" x2="{px:.1f}" y2="{py:.1f}" '
            'stroke="#eee" stroke-width="2.5" stroke-linecap="round"/>')
        parts.append(
            f'<text x="{cx}" y="{cy + radius * 0.35:.1f}" font-size="9" '
            f'fill="#4c8" text-anchor="middle">{angle:+.1f}&#176;</text>')
    for deg in range(-180, 181, 45):
        # dial sweep: -180 deg at 7:30, +180 at 4:30 (270-degree sweep
        # is not used — the reference dial is threesixty: full circle)
        ang = math.radians(deg - 90.0)
        tx = cx + radius * math.cos(ang)
        ty = cy + radius * math.sin(ang)
        parts.append(
            f'<circle cx="{tx:.1f}" cy="{ty:.1f}" r="2.0" fill="#ccc"/>')
        lx = cx + (radius + 12) * math.cos(ang)
        ly = cy + (radius + 12) * math.sin(ang)
        if deg in (-180, -90, 0, 90, 180):
            parts.append(
                f'<text x="{lx:.1f}" y="{ly:.1f}" font-size="8" '
                f'fill="#ddd" text-anchor="middle" '
                f'dominant-baseline="middle">{deg}</text>')
    parts.append("</svg>")
    return "".join(parts)
