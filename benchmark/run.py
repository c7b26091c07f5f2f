"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell, its configuration, its traffic
and its metrics are found by name from ``BENCHMARK.json`` (see
``harness/spec.py``).  With ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, the device's
busy and window seconds and a breakdown.  The last line on stdout is the
result; the last lines on stderr are the numbers that decided
``correct``, each beside its limit.  Without the CUDA cards the cell asks
for, the run fails and prints no result."""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import threading
import types

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]  # the benchmark, the program

from harness.common import (SetupClock, apply_cache_env, card_power,  # noqa
                            emit, fail, require_cuda)
from harness.spec import SpecError, read_per_layer  # noqa: E402

DRIVERS = {
    "fleet_catalogue": ("harness.analysis", "catalogue"),
    "resident_search": ("harness.analysis", "resident"),
    "daemon_sessions": ("harness.serving", "sessions"),
}


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             clock, **kw):
    """Drive the cell's traffic once; returns the driver's Outcome."""
    import importlib

    kind = cell.traffic["kind"]
    if kind not in DRIVERS:
        raise SpecError(f"traffic {cell.traffic_name!r} has unknown kind "
                        f"{kind!r}")
    mod, fn = DRIVERS[kind]
    tmpdir = tempfile.mkdtemp(prefix="prt_bench_")
    try:
        return getattr(importlib.import_module(mod), fn)(
            cell, seed, seconds, traced, device, clock, tmpdir, **kw)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def result_line(cell, out, traced: bool, device_name: str, count: int):
    from harness import judge
    from harness.trace import breakdown, busy_seconds, window_seconds

    checked = judge.checks(out.numbers)
    correct = judge.passed(checked) and out.failed == 0
    dev = {"platform": "gpu", "kind": device_name, "count": count,
           "memory_peak_bytes": out.memory_peak}
    res = {"correct": correct, "attempted": out.attempted,
           "failed": out.failed}
    if traced:
        metrics = read_per_layer(cell, out.trace)
        if out.trace is not None and out.trace.device:
            dev["busy_s"] = busy_seconds(out.trace)
            dev["window_s"] = window_seconds(out.trace)
            res["breakdown"] = breakdown(out.trace)
    else:
        metrics = {}
        units = {m["name"]: m["unit"] for m in cell.end_to_end()}
        for name, unit in units.items():
            value = out.setup_s if name == "setup_s" else out.e2e[name]
            metrics[name] = {"value": float(value), "unit": unit}
    res["metrics"] = metrics
    res["device"] = dev
    return res, checked


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spec", default=None,
                    help="a file of BENCHMARK.json's shape to find the cell "
                         "in (default BENCHMARK.json; benchmark/held.json "
                         "holds the cells it does not list)")
    args = ap.parse_args(argv)
    clock = SetupClock()
    apply_cache_env()
    clock.mark("interpreter")
    from harness.spec import Cell, load_spec

    try:
        cell = Cell(load_spec(path=args.spec), args.workload)
    except (SpecError, OSError, KeyError) as e:
        fail(str(e))
    # torch is imported beside the driver's own start-up (a daemon boots
    # meanwhile); the driver waits on ``gate`` before it uses the card
    found: dict = {}

    def look():
        try:
            import torch

            found["cards"] = (torch.cuda.device_count()
                              if torch.cuda.is_available() else 0)
        except Exception as e:  # reported by gate, on the main thread
            found["error"] = e

    looking = threading.Thread(target=look)
    looking.start()

    def gate():
        looking.join()
        if "error" in found:
            raise found["error"]
        require_cuda(cell.chips)
        clock.mark("import_torch")

    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       types.SimpleNamespace(type="cuda", index=0), clock,
                       gate=gate)
    except SpecError as e:
        fail(str(e))
    import torch

    name = out.info.pop("device_name", None) or torch.cuda.get_device_name(0)
    res, checked = result_line(cell, out, bool(args.trace), name, cell.chips)
    print(f"card: {card_power()}; setup parts (s): "
          f"{ {k: round(v, 4) for k, v in clock.parts.items()} }; "
          f"{out.info}", file=sys.stderr)
    emit(res, checked)
    return 0


if __name__ == "__main__":
    sys.exit(main())
