"""No run loads JAX or the JAX package; the reference loads nothing of
the program."""

import ast
import subprocess
import sys

from benchmark.harness.imports import forbidden
from benchmark.harness.manifest import ROOT


def test_names_compare_whole_by_top_level():
    mods = ["slamem_tpu_torch", "slamem_tpu_torch.engine.run", "jaxtyping",
            "numpy", "flaxen", "jax_stub"]
    assert forbidden(mods) == []
    assert forbidden(mods + ["slamem_tpu.engine"]) == ["slamem_tpu"]
    assert forbidden(["jax._src", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "benchmark" / "reference").glob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top in ("torch", "numpy", "__future__", "benchmark"), (
                f, name)
            if top == "benchmark":
                assert name.startswith("benchmark.reference"), (f, name)


def test_no_benchmark_file_imports_jax():
    for f in (ROOT / "benchmark").rglob("*.py"):
        for name in _imports(f):
            assert not forbidden([name]), (f, name)


def test_a_run_loads_no_jax(tmp_path):
    """A whole CPU run of a tiny cell in a fresh interpreter: nothing
    forbidden in sys.modules after it."""
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
import torch
from benchmark.harness.manifest import load_cell
from benchmark.harness.runner import run_cell
from benchmark.harness.imports import forbidden
cell = load_cell("salmonella10.job")
cell.config.update(reference_length=8000)
cell.config["query_entries"] = cell.config["query_entries"][:2]
result, _ = run_cell(cell, 3, 0.2, False, torch.device("cpu"),
                     time.perf_counter())
assert result["correct"], result
print("FORBIDDEN", forbidden(sys.modules))
print("PORT", "slamem_tpu_torch" in sys.modules)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FORBIDDEN []" in proc.stdout
    assert "PORT True" in proc.stdout
