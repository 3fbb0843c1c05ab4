"""No module of the benchmark imports JAX, its libraries or the JAX
package, and the plain reference imports nothing of the port either.
Names are compared by their whole top-level part (before the first dot):
the port's package name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "asvspoof2021_air_tpu"}
PORT = "asvspoof2021_air_tpu_torch"
SOURCES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in set(top_level_imports(path))
    assert not set(top_level_imports(path)) & FORBIDDEN


def test_the_check_compares_whole_names():
    from portbench.harness.bench import FORBIDDEN as RUN_FORBIDDEN

    assert PORT not in RUN_FORBIDDEN
    assert set(RUN_FORBIDDEN) == FORBIDDEN
