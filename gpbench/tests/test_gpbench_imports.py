"""Nothing under gpbench/ imports JAX or the JAX package, compared by
whole top-level name (the port's name begins with the JAX package's), and
the references import nothing of the program."""

import ast

import pytest
from gpbench_toy import REPO

FILES = sorted((REPO / "gpbench").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "fvgp_tpu"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    REPO)))
def test_no_jax_by_top_level_name(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN
    assert "importlib.import_module(\"jax" not in path.read_text()


@pytest.mark.parametrize("path", sorted((REPO / "gpbench" / "reference")
                                        .glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"math", "numpy", "torch"}


def test_the_top_level_comparison_is_whole():
    assert "fvgp_tpu_torch".split(".")[0] not in FORBIDDEN
