"""What every run shares: its clock from process start, the cache
directories, the card's name and power limit, the check that no JAX was
loaded, and the result line."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Dict, Optional

from .spec import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "phaserotate_tpu")
# the compiler caches of the program and its libraries: fixed directories
# inside the checkout, so only a checkout's first run builds
CACHE = ROOT / "build" / "bench_cache"


def process_start_age() -> float:
    """Seconds since this process started, from /proc (10 ms ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


class SetupClock:
    """Set-up time from process start, and its named parts."""

    def __init__(self):
        self.t0 = time.monotonic() - process_start_age()
        self.last = self.t0
        self.parts: Dict[str, float] = {}

    def mark(self, part: str) -> None:
        now = time.monotonic()
        self.parts[part] = self.parts.get(part, 0.0) + (now - self.last)
        self.last = now

    def total(self, at: Optional[float] = None) -> float:
        return (time.monotonic() if at is None else at) - self.t0


def cache_env() -> Dict[str, str]:
    """The environment of this run and its children with every build
    cache inside the checkout."""
    env = dict(os.environ)
    env["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    env["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    env["USE_FLAX"] = "0"
    env["PYTHONDONTWRITEBYTECODE"] = "1"
    return env


def apply_cache_env() -> None:
    os.environ.update({k: v for k, v in cache_env().items()
                       if k in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR",
                                "USE_FLAX")})


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def require_cuda(chips: int) -> None:
    """Exit without a result where the cell's cards are not there."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the benchmark runs on "
             "CUDA cards only")
    if torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} cards, "
             f"torch.cuda.device_count() is {torch.cuda.device_count()}")


def card_power() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def fail(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """Print the compared numbers as the last lines of stderr and the
    result as the last line of stdout, the checks under the last key."""
    bad = forbidden_modules()
    if bad:
        fail(f"JAX or the JAX package was loaded in this process: {bad}")
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
