"""Nothing the benchmark runs loads JAX or the JAX package, judged by
whole top-level module names (the port's name begins with the JAX
package's), and nothing reads the JAX package's benchmark records."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

import bench_tiny  # noqa: F401
from harness.common import FORBIDDEN, forbidden_modules
from harness.spec import BENCH, ROOT

SOURCES = sorted(p for p in BENCH.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_import(path):
    assert not set(_imports(path)) & set(FORBIDDEN)
    text = path.read_text()
    records = [a + b for a, b in (("bench", ".py"), ("BASELINE", ".json"),
                                  ("BENCH", "_r0"), ("MULTICHIP", "_r0"))]
    assert not [r for r in records if r in text]


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "phaserotate_tpu_torch" not in set(_imports(path))


def test_whole_top_level_names():
    sys.modules.setdefault("phaserotate_tpu_torchx", None)
    try:
        assert "phaserotate_tpu_torchx" not in forbidden_modules()
    finally:
        sys.modules.pop("phaserotate_tpu_torchx", None)


def test_fresh_harness_loads_no_jax():
    code = ("import sys; sys.argv = ['x']; sys.path[:0] = ['%s', '%s'];"
            "import run, harness.analysis, harness.serving, harness.client;"
            "import phaserotate_tpu_torch.fleet, phaserotate_tpu_torch.bridge;"
            "from harness.common import forbidden_modules;"
            "print(forbidden_modules())") % (BENCH, ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "analyze.cli_48k.catalogue", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
