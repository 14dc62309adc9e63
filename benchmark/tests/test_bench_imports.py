"""What the benchmark may import: no JAX and no JAX package anywhere in
what it runs, and nothing of the program in the plain reference.

Names are compared by their top-level module, whole:
``transformer_transducer_tpu_torch`` is the program and passes,
``transformer_transducer_tpu`` is the JAX package and fails."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "transformer_transducer_tpu"}
PROGRAM = "transformer_transducer_tpu_torch"
REFERENCE_MAY_IMPORT = {"__future__", "math", "typing", "numpy", "torch", "benchmark"}


def imported(path: Path):
    """(top-level name, full name) of every import in a file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.module


def run_files():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


def test_there_are_files_to_check():
    names = {p.relative_to(BENCH).as_posix() for p in run_files()}
    assert {"run.py", "harness.py", "reference/model.py", "entries/train.py"} <= names


@pytest.mark.parametrize("path", run_files(), ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax_by_whole_top_level_name(path):
    bad = [full for top, full in imported(path) if top in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for top, full in imported(path):
        assert top != PROGRAM, f"{path} imports {full}"
        assert top in REFERENCE_MAY_IMPORT, f"{path} imports {full}"
        if top == "benchmark":
            assert full.startswith("benchmark.reference"), f"{path} imports {full}"


def test_the_whole_name_rule():
    from benchmark.harness import FORBIDDEN as RUN_FORBIDDEN
    assert set(RUN_FORBIDDEN) == FORBIDDEN
    assert PROGRAM.split(".")[0] not in FORBIDDEN
