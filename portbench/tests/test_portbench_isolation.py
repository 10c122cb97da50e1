"""What the benchmark imports: no file of it imports JAX or the JAX package,
and the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "rgbnomore_tpu"}


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted([*(BENCH / "reference").glob("*.py"),
                                         *(BENCH / "wires").glob("*.py")]),
                         ids=lambda p: f"{p.parent.name}/{p.name}")
def test_reference_imports_nothing_of_the_port(path):
    assert "rgbnomore_tpu_torch" not in _imports(path)
    assert _imports(path) <= {"__future__", "math", "numpy", "torch", "reference"}


def test_only_program_imports_the_port():
    users = {p.name for p in SOURCES if "rgbnomore_tpu_torch" in _imports(p)}
    assert users == {"program.py"}
