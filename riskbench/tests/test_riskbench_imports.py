"""What the benchmark may import and read.

Nothing under riskbench/ imports the JAX side (``jax``, ``jaxlib``,
``flax``, ``montecarlo_risk_engine_tpu``) or the bring-up smoke, or names
its benchmark scripts; the references import nothing of the port either.
Names are compared by their top-level module, the part before the first
dot, as a whole: the port's name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

from riskbench import harness

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "montecarlo_risk_engine_tpu", "chip_smoke", "bench",
             "benchmarks"}
PORT = "montecarlo_risk_engine_tpu_torch"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_side(path):
    assert not top_level_imports(path) & FORBIDDEN
    if path == Path(__file__).resolve():
        return  # this file names them
    text = path.read_text()
    assert "benchmarks/" not in text and "bench.py" not in text and "import jax" not in text


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert PORT not in top_level_imports(path)
    assert PORT not in path.read_text()


def test_top_level_names_compare_whole(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, f"{PORT}_probe", types.ModuleType(f"{PORT}_probe"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "montecarlo_risk_engine_tpu.probe",
                        types.ModuleType("montecarlo_risk_engine_tpu.probe"))
    assert harness.forbidden_modules() == ["montecarlo_risk_engine_tpu.probe"]
