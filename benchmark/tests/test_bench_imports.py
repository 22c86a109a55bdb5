"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program; names compare whole, by their
top-level part."""

import ast
import sys
from pathlib import Path

import pytest

from benchmark import run

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "primia_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH / "reference")))
def test_the_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "primia_tpu_torch" not in names and not names & FORBIDDEN
    assert names <= {"__future__", "importlib", "math", "typing", "numpy", "torch",
                     "benchmark"}


def test_the_run_tells_the_port_from_the_jax_package(monkeypatch):
    monkeypatch.delitem(sys.modules, "primia_tpu", raising=False)
    before = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "primia_tpu_torch.fake", object())
    assert set(run.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "primia_tpu.fake", object())
    assert set(run.forbidden_modules()) == before | {"primia_tpu"}
