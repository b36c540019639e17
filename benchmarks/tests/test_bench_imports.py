"""Nothing under benchmarks/ imports JAX or the JAX package, and the plain
reference imports nothing of the program: every import statement's
top-level name (the part before the first dot) is compared whole."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "elemental_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert "elemental_tpu_torch" not in top_level_imports(path)


def test_names_compared_whole():
    # the port's name begins with the JAX package's: a prefix test would
    # confuse them
    assert "elemental_tpu_torch".split(".")[0] not in NEVER
    assert top_level_imports(BENCH / "ops" / "solve.py") >= {
        "harness", "reference"}
