"""Nothing in swarmbench/ imports JAX, flax or the JAX package (compared by
whole top-level module names: the port's name begins with the JAX
package's), and the plain reference imports nothing of the port."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in set(_imports(path))
    assert set(_imports(path)) <= {"__future__", "contextlib", "math",
                                   "typing", "numpy", "torch", "swarmbench"}


def test_reference_imports_only_the_reference():
    for path in (HERE / "reference").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("swarmbench"):
                assert node.module.startswith("swarmbench.reference")


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys

    from swarmbench import harness
    monkeypatch.setitem(sys.modules, "repro_torch_probe", object())
    assert "repro_torch_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.core", object())
    assert "flax" in harness.forbidden_modules()
