"""Protocol URI table and port map.

A copy of ``phaserotate_tpu/plugin/uris.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy.  Only these lines differ;
``tests/test_torch_io.py`` holds the rest to its source.

The framework's equivalent of the shared protocol header
(src/phaserotate.h:41-111): stable string identifiers for every message
type and level field exchanged between the DSP engine and a UI, plus the
port index layout.  Where LV2 maps URIs to integer URIDs at run time, the
framework interns them once here.
"""

from __future__ import annotations

import enum

__all__ = ["PROT_URI", "PLUGIN_URI", "PLUGIN_URI_STEREO", "Prot", "PortIndex",
           "MAX_CHANNELS", "LEVEL_FIELDS"]

PLUGIN_URI = "urn:phaserotate-tpu:plugin"
PLUGIN_URI_STEREO = PLUGIN_URI + "#stereo"
PROT_URI = PLUGIN_URI + "#"

MAX_CHANNELS = 2  # src/phaserotate.h:97


class Prot(str, enum.Enum):
    """Message/type identifiers (src/phaserotate.h:41-93)."""

    ui_on = PROT_URI + "ui_on"
    ui_off = PROT_URI + "ui_off"
    reset_peaks = PROT_URI + "reset_peaks"
    state = PROT_URI + "state"
    s_uiscale = PROT_URI + "uiscale"
    s_link = PROT_URI + "link"
    levels = PROT_URI + "levels"
    l_channel = PROT_URI + "l_channel"
    l_in_cur = PROT_URI + "l_in_cur"
    l_in_mom = PROT_URI + "l_in_mom"
    l_in_peak = PROT_URI + "l_in_peak"
    l_out_cur = PROT_URI + "l_out_cur"
    l_out_mom = PROT_URI + "l_out_mom"
    l_out_peak = PROT_URI + "l_out_peak"
    l_diff_cur = PROT_URI + "l_diff_cur"
    l_diff_min = PROT_URI + "l_diff_min"
    l_diff_max = PROT_URI + "l_diff_max"


LEVEL_FIELDS = (
    "in_cur", "in_mom", "in_peak",
    "out_cur", "out_mom", "out_peak",
    "diff_cur", "diff_min", "diff_max",
)


class PortIndex(enum.IntEnum):
    """Port layout (src/phaserotate.h:99-111): 3 fixed ports then
    (angle, input, output) triplets per channel."""

    ATOM_CONTROL = 0
    ATOM_NOTIFY = 1
    LATENCY = 2
    ANGLE0 = 3
    INPUT0 = 4
    OUTPUT0 = 5
    ANGLE1 = 6
    INPUT1 = 7
    OUTPUT1 = 8


def port_channel(port: int) -> int:
    """Channel index of a per-channel port ((port-3)//3,
    src/phaserotate.c:430)."""
    return (int(port) - PortIndex.ANGLE0) // 3


def port_role(port: int) -> str:
    """'angle' | 'input' | 'output' for per-channel ports
    (src/phaserotate.c:436-446)."""
    return ("angle", "input", "output")[(int(port) - PortIndex.ANGLE0) % 3]
