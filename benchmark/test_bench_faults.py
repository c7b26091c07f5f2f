"""A run drives its cell with the timed path broken underneath, and
``correct`` comes out false: once for each fault the cell can have (a
step that returns its state unchanged, half of the batch left out, an
answer altered where it is produced).  The look for a card is skipped:
these run on the CPU at a size a test run holds.  The same runs unbroken
come out correct."""

import pytest

from bench_tiny import run_tiny
from harness import faults
from harness.trace import Patches

ANALYSIS = ["analyze.cli_48k.catalogue", "search.cli_48k.resident"]
SERVING = ["serve.lv2_48k.rt", "serve.lv2_48k.batch8"]


@pytest.mark.parametrize("cell", ANALYSIS + SERVING)
def test_sound_run_is_correct(cell):
    out, res, checked = run_tiny(cell)
    assert res["correct"], checked
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) >= {"setup_s"}
    if cell in ANALYSIS:  # the samples are read at their depth
        assert checked["input_peak_gap"]["value"] == 0.0


@pytest.mark.parametrize("fault", faults.ANALYSIS)
@pytest.mark.parametrize("cell", ANALYSIS)
def test_analysis_fault_is_caught(cell, fault):
    patches = Patches()
    faults.plant_analysis(fault, patches)
    try:
        out, res, checked = run_tiny(cell)
    finally:
        patches.restore()
    assert not res["correct"], checked


@pytest.mark.parametrize("fault", faults.SERVING)
def test_serving_fault_is_caught(fault):
    out, res, checked = run_tiny("serve.lv2_48k.batch8", plant=fault)
    assert not res["correct"], checked


def test_traced_runs_read_their_spans():
    out, res, _ = run_tiny("analyze.cli_48k.catalogue", traced=True)
    assert {"decode_ms_per_file", "pack_ms_per_batch"} <= set(res["metrics"])
    out, res, _ = run_tiny("serve.lv2_48k.batch8", traced=True)
    assert {"broker_step_ms.batch8",
            "frames_per_dispatch.batch8"} <= set(res["metrics"])
