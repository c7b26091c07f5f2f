"""BENCHMARK.json against the benchmark's files and the contract's
limits: every entry is found by name, and every name, unit and bound is
one the contract takes."""

import json
import re

import pytest

import bench_tiny  # noqa: F401  (puts the benchmark on the path)
from harness.spec import BENCH, HELD, ROOT, Cell, load_spec, metric_reader

SPEC = load_spec()
SPECS = {"listed": SPEC, "held": load_spec(path=HELD)}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KINDS = {"fleet_catalogue", "resident_search", "daemon_sessions"}


def _one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("which,name", [(k, w["name"]) for k, spec in
                                        SPECS.items()
                                        for w in spec["workloads"]])
def test_every_cell_is_found(which, name):
    cell = Cell(SPECS[which], name)
    assert cell.traffic["kind"] in KINDS
    assert cell.chips in (1, 4)
    assert _one_line(cell.workload["why"])
    e2e = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer(), "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", [m["name"] for spec in SPECS.values()
                                    for m in spec["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(metric_reader(metric))


def test_held_cells_are_not_listed():
    listed = {w["name"] for w in SPEC["workloads"]}
    assert not listed & {w["name"] for w in SPECS["held"]["workloads"]}


@pytest.mark.parametrize("which", sorted(SPECS))
def test_names_units_and_keys(which):
    SPEC = SPECS[which]
    for section, keys in (("configs", {"name", "source", "file", "reduced",
                                       "why"}),
                          ("workloads", {"name", "config", "traffic",
                                         "chips", "why"}),
                          ("end_to_end", {"name", "unit", "better", "bound",
                                          "source", "workloads"}),
                          ("per_layer", {"name", "unit", "better", "source",
                                         "layer", "moves", "workloads"})):
        names = [e["name"] for e in SPEC[section]]
        assert len(names) == len(set(names))
        for e in SPEC[section]:
            assert set(e) <= keys, (section, set(e) - keys)
            assert NAME.match(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    sources = {"device_trace", "program_span", "program_counter",
               "host_clock"}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in e2e
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["source"] in sources and _one_line(m["layer"])
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:  # its cell reports what it moves
            moved = e2e[m["moves"]].get("workloads")
            assert moved is None or w in moved
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_configs_and_paths():
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert c["source"].startswith("https://")
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_check_budget_fits():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (SPEC["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_traffic_files_are_data():
    for path in (BENCH / "traffic").iterdir():
        assert path.suffix == ".json", path
        assert json.loads(path.read_text())["kind"] in KINDS


@pytest.mark.parametrize("driver,cell", [
    ("catalogue", "analyze.cli_48k.catalogue"),
    ("resident", "search.cli_48k.resident")])
@pytest.mark.parametrize("key,value", [("bits", 20), ("bits", 32),
                                       ("container", "flac")])
def test_unwritable_format_is_refused_before_setup(driver, cell, key, value,
                                                   tmp_path):
    """A sample format the benchmark cannot write stops an analysis driver
    before it starts the program or writes a file."""
    import torch

    from bench_tiny import tiny
    from harness import analysis
    from harness.common import SetupClock
    from harness.spec import SpecError

    started = []
    with pytest.raises(SpecError,
                       match=rf"'cli_48k'.*{key} {re.escape(repr(value))}"):
        getattr(analysis, driver)(
            tiny(cell, config={key: value}), 1, 1.0, False,
            torch.device("cpu"), SetupClock(), str(tmp_path),
            gate=lambda: started.append(1))
    assert not started and not list(tmp_path.iterdir())


def test_sample_format_defaults_and_listed_configs():
    from harness.signals import sample_bits

    assert sample_bits({"name": "x"}) == 16
    assert sample_bits({"name": "x", "bits": 24, "container": "wav"}) == 24
    for spec in SPECS.values():
        for w in spec["workloads"]:
            cell = Cell(spec, w["name"])
            if cell.traffic["kind"] != "daemon_sessions":
                assert sample_bits(cell.config) == cell.config.get("bits", 16)
