"""No JAX on the card: no file of the benchmark imports it, the
reference imports nothing of the program, and a run that loaded it is
caught by top-level name."""

import ast
import sys
import types

from conftest import ROOT
from port_bench import harness

BENCH = ROOT / "port_bench"


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_imports_jax():
    for path in BENCH.rglob("*.py"):
        for name in imported(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference.py",):
        for name in imported(path):
            assert name.split(".")[0] in ("__future__", "math", "torch"), name


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    import twoace_tpu_torch  # noqa: F401  (passes: not "twoace_tpu")

    assert harness.forbidden_modules() == []
    for name in ("jax", "jax.numpy", "twoace_tpu.ops", "chip_smoke"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == ["chip_smoke", "jax", "twoace_tpu"]
