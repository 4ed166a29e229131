"""What may be imported: top-level names compared whole."""
from __future__ import annotations

import ast

import pytest

from gpubench.harness import spec
from gpubench.harness.imports import FORBIDDEN, forbidden_loaded


@pytest.mark.parametrize("modules,found", [
    ({"repro_torch", "repro_torch.fl.engine", "numpy"}, []),
    ({"repro", "repro.fl"}, ["repro"]),
    ({"jax._src.core", "jaxtyping"}, ["jax"]),
    ({"jaxlib.xla_client", "flax.linen", "reproduce"}, ["flax", "jaxlib"]),
])
def test_forbidden_by_whole_top_level_name(modules, found):
    assert forbidden_loaded(modules) == found


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


FILES = sorted(spec.BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(spec.BENCH_DIR)))
def test_sources_import_no_jax_and_reference_no_program(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert not tops & set(FORBIDDEN)
    rel = path.relative_to(spec.BENCH_DIR).parts
    if rel[0] == "reference":
        assert "repro_torch" not in tops
    if "repro_torch" in tops:
        assert rel in (("harness", "program.py"),
                       ("checks", "check_reference.py"))
