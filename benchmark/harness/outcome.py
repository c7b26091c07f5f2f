"""What a traffic driver hands back to the harness."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .trace import Trace


@dataclasses.dataclass
class Outcome:
    e2e: Dict[str, float]
    setup_s: float
    attempted: int
    failed: int
    numbers: Dict[str, float]
    memory_peak: int
    trace: Optional[Trace] = None
    info: Dict[str, object] = dataclasses.field(default_factory=dict)
