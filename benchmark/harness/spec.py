"""Find a cell's pieces by name: its workload entry in ``BENCHMARK.json``,
its configuration file, its traffic file and its metrics' readers.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in a file of its own under ``benchmark/``, named
after it, so a cell, a mix or a metric is added by adding files."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
HELD = BENCH / "held.json"


class SpecError(RuntimeError):
    """A name in BENCHMARK.json that the benchmark's files do not have."""


def load_spec(root: Path = ROOT, path: Optional[Path] = None) -> dict:
    """``BENCHMARK.json``, or a file of the same shape at ``path``, such as
    ``benchmark/held.json``: the cells whose files are here but that
    ``BENCHMARK.json`` does not list (PERF.md, Open questions)."""
    path = Path(path) if path is not None else root / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"no {path.name} at {path.parent}")
    return json.loads(path.read_text())


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SpecError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """One workload of the spec with its configuration, traffic and the
    metrics it reports."""

    def __init__(self, spec: dict, name: str, root: Path = ROOT):
        self.spec = spec
        self.root = root
        self.workload = _by_name(spec["workloads"], name, "workload")
        self.name = name
        cfg = _by_name(spec["configs"], self.workload["config"], "config")
        self.config_entry = cfg
        self.config = json.loads((root / cfg["file"]).read_text())
        self.traffic_name = self.workload["traffic"]
        tpath = root / "benchmark" / "traffic" / f"{self.traffic_name}.json"
        if not tpath.is_file():
            raise SpecError(f"no traffic file {tpath}")
        self.traffic = json.loads(tpath.read_text())
        self.chips = int(self.workload["chips"])

    def _applies(self, metric: dict) -> bool:
        cells = metric.get("workloads")
        return cells is None or self.name in cells

    def end_to_end(self) -> List[dict]:
        return [m for m in self.spec["end_to_end"] if self._applies(m)]

    def per_layer(self) -> List[dict]:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if self._applies(m) and m["moves"] in e2e]


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """The ``read(trace)`` function of ``benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no reader {path} for metric {name!r}")
    mod_name = "bench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(cell: Cell, trace) -> Dict[str, dict]:
    """Every per-layer metric of the cell that its reader finds."""
    out: Dict[str, dict] = {}
    for m in cell.per_layer():
        value: Optional[float] = metric_reader(m["name"], cell.root)(trace)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
