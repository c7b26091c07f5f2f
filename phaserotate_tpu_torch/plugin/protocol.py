"""DSP <-> UI message protocol.

A copy of ``phaserotate_tpu/plugin/protocol.py``, which holds no JAX: that
package's ``__init__`` imports JAX, and this port runs where JAX is
absent, so it keeps its own copy.  Only these lines differ;
``tests/test_torch_io.py`` holds the rest to its source.

Typed message objects replacing the reference's LV2 atom objects
(src/phaserotate.c:741-771, 795-830; gui/phaserotate.c:1099-1134): the
same four control messages and two notification messages, with a compact
dict/JSON serialization so out-of-process UIs (or logging) can consume the
stream.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Union

from .uris import Prot

__all__ = [
    "UiOn", "UiOff", "ResetPeaks", "StateMsg", "LevelsMsg",
    "Message", "encode", "decode",
]


@dataclasses.dataclass(frozen=True)
class UiOn:
    """UI opened: start sending levels + echo state
    (src/phaserotate.c:808-810)."""


@dataclasses.dataclass(frozen=True)
class UiOff:
    """UI closed: stop sending levels (src/phaserotate.c:806-807)."""


@dataclasses.dataclass(frozen=True)
class ResetPeaks:
    """Clear peak-hold and diff accumulators on every channel
    (src/phaserotate.c:811-814)."""


@dataclasses.dataclass(frozen=True)
class StateMsg:
    """Persisted UI state: scale factor + channel link
    (src/phaserotate.c:522-536, 815-826)."""

    uiscale: float = 1.0
    link: bool = False


@dataclasses.dataclass(frozen=True)
class LevelsMsg:
    """Per-channel meter snapshot — the 9 floats of the `levels` atom
    (src/phaserotate.c:744-768)."""

    channel: int
    in_cur: float
    in_mom: float
    in_peak: float
    out_cur: float
    out_mom: float
    out_peak: float
    diff_cur: float
    diff_min: float
    diff_max: float


Message = Union[UiOn, UiOff, ResetPeaks, StateMsg, LevelsMsg]

_TYPE_MAP = {
    Prot.ui_on.value: UiOn,
    Prot.ui_off.value: UiOff,
    Prot.reset_peaks.value: ResetPeaks,
    Prot.state.value: StateMsg,
    Prot.levels.value: LevelsMsg,
}
_URI_MAP = {v: k for k, v in _TYPE_MAP.items()}


def encode(msg: Message) -> str:
    """Message -> JSON line."""
    body = dataclasses.asdict(msg)
    body["@type"] = _URI_MAP[type(msg)]
    return json.dumps(body)


def decode(line: str) -> Message:
    """JSON line -> Message."""
    body = json.loads(line)
    cls = _TYPE_MAP[body.pop("@type")]
    return cls(**body)
