"""Nothing the benchmark runs imports JAX or the JAX package; the
reference imports nothing of the program (top-level names compared
whole: ``strive_tpu_torch`` is the program, ``strive_tpu`` the JAX
package)."""

import ast

import pytest

from benchmark.harness import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "strive_tpu"}


def imported(path):
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "strive_tpu_torch" not in imported(path)
    assert "benchmark" not in imported(path)  # only its own relative imports


def test_the_scan_sees_what_it_looks_for(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom strive_tpu.x import y\n"
                 "import strive_tpu_torch\n")
    assert imported(p) == {"jax", "strive_tpu", "strive_tpu_torch"}
    assert imported(p) & FORBIDDEN == {"jax", "strive_tpu"}
