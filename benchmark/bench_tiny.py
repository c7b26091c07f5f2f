"""Cells of BENCHMARK.json cut to a size the CPU holds in seconds, for the
benchmark's own tests: the same drivers, configurations and judge, with
songs of 2-6 s, a handful of files and two or three sessions."""

from __future__ import annotations

import copy
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness.common import SetupClock  # noqa: E402
from harness.spec import HELD, Cell, load_spec  # noqa: E402

SEED = 2 ** 31 + 12345


def tiny(name: str, sessions: int = 2, config: dict = None) -> Cell:
    """The cell ``name`` cut down; ``config`` replaces keys of its
    configuration (such as ``bits``)."""
    spec = load_spec()
    if name not in {w["name"] for w in spec["workloads"]}:
        spec = load_spec(path=HELD)
    cell = Cell(spec, name)
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(config or {})
    cell.traffic = dict(cell.traffic)
    if "masters" in cell.config:
        cell.config["masters"]["song_seconds"] = {"mean": 3.5, "sigma": 0.4}
        cell.config["batch"] = 2
    kind = cell.traffic["kind"]
    if kind == "fleet_catalogue":
        cell.traffic.update(files=4, links=4, slice=8)
    elif kind == "resident_search":
        cell.traffic.update(songs=4, batch=2)
    elif kind == "daemon_sessions":
        cell.traffic.update(sessions=sessions, warm_blocks=4)
    return cell


def run_tiny(name: str, seconds: float = 2.0, traced: bool = False,
             seed: int = SEED, config: dict = None, **kw):
    """(Outcome, result line, checks) of one CPU run of a tiny cell."""
    import torch

    import run as bench_run

    cell = tiny(name, config=config)
    out = bench_run.run_cell(cell, seed, seconds, traced,
                             torch.device("cpu"), SetupClock(), **kw)
    res, checked = bench_run.result_line(cell, out, traced, "cpu", 1)
    return out, res, checked
