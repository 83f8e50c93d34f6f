"""The plain reference against the program at a tiny size on the CPU (both
float32: agreement to rounding), and the import rules: the reference
imports nothing of the program, no file of the benchmark imports JAX or
the JAX package, and a run refuses to print a result once one is loaded."""
import ast
import sys

import pytest

from port_bench import harness
from port_bench.tests.helpers import run_cell

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mobi_tpu")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("cell", ["tiny_bulk", "tiny_camera", "tiny_train"])
def test_reference_agrees_with_the_program(tiny_bench, cell):
    rc, res, _, err = run_cell(tiny_bench, cell)
    assert rc == 0, err
    assert res["correct"] is True, res["checks"]
    assert all(c["value"] < c["limit"] for c in res["checks"].values())


def test_reference_imports_nothing_of_the_program():
    for path in sorted((harness.BENCH_DIR / "reference").rglob("*.py")):
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert "mobi_tpu_torch" not in tops and not tops & set(FORBIDDEN), (path, tops)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in sorted(harness.BENCH_DIR.rglob("*.py")):
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert not tops & set(FORBIDDEN), (path, tops & set(FORBIDDEN))


def test_forbidden_modules_compare_whole_top_level_names():
    loaded = ["mobi_tpu_torch", "mobi_tpu_torch.ops", "jax.numpy", "mobi_tpu", "flaxen", "optax._src", "jaxlib"]
    assert harness.forbidden_loaded(loaded) == ["jax.numpy", "jaxlib", "mobi_tpu", "optax._src"]


def test_a_run_with_jax_loaded_prints_no_result(tiny_bench, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys.modules["json"])
    rc, res, _, err = run_cell(tiny_bench, "tiny_camera")
    assert rc != 0 and res is None and "jax" in err
