"""On the card: one short run of each cell through the command the
driver uses, correct and with its metrics.  Skips without a card (decided
inside the test).  Run on the card with
``python -m pytest benchmark/test_bench_cuda.py -q``."""

import json
import subprocess
import sys

import pytest

import bench_tiny  # noqa: F401
from harness.spec import ROOT, load_spec

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in load_spec()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 101), "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], out.stderr[-3000:]
    assert res["device"]["platform"] == "gpu" and res["metrics"]
    assert list(res)[-1] == "checks"
