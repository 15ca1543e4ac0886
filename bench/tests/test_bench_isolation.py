"""No module of the benchmark imports JAX, Flax or the JAX package, compared
by whole top-level name (``repro_torch`` begins with ``repro``), and only
the timed path imports the program."""
from __future__ import annotations

import ast

import pytest

from bench_small import BENCH
import common

FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
TIMED_PATH = {"serve.py", "train.py", "model.py"}


def _imports(path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_program_only_on_the_timed_path(path):
    tops = _imports(path)
    assert not tops & set(common.FORBIDDEN), path
    if "repro_torch" in tops:
        assert path.name in TIMED_PATH and path.parent == BENCH


def test_whole_name_compare():
    names = ["repro_torch", "repro_torch.serving", "repro", "repro.core.engine", "jax.numpy",
             "jaxlib", "flax", "flaxen", "reprox", "numpy"]
    assert common.forbidden_loaded(names) == ["flax", "jax.numpy", "jaxlib", "repro",
                                              "repro.core.engine"]


def test_reference_reads_no_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        assert not _imports(path) & {"repro_torch", *common.FORBIDDEN}, path
