"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name; the reference imports nothing of the
program."""

import ast
import subprocess
import sys

import pytest

from perfbench import harness

REFERENCE = sorted((harness.PKG / "reference").glob("*.py"))


def test_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "euromillioner_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert "euromillioner_tpu" not in harness.forbidden_modules()
    assert "jax" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "euromillioner_tpu.models", sys)
    assert harness.forbidden_modules() == ["euromillioner_tpu"]


def test_a_run_loads_no_forbidden_module():
    """Every part a run loads, in a fresh interpreter: the harness, each
    driver, family, metric reader and the reference, then a tiny run of
    every cell."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench import harness, calibrate, sweep, faults\n"
        "from perfbench.tests.helpers import TINY, tiny_run\n"
        "for kind in ('drivers', 'families', 'metrics', 'reference'):\n"
        "    for p in (harness.PKG / kind).glob('*.py'):\n"
        "        harness.load_part(kind, p.stem)\n"
        "for cell in TINY:\n"
        "    tiny_run(cell, seconds=0.2)\n"
        "print(harness.forbidden_modules())\n") % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    tops = {n.split(".", 1)[0] for n in names}
    assert tops <= {"__future__", "numpy", "torch", "math"}, tops
