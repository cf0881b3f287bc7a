"""Nothing under portbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the port. Each import's top-level name is
compared whole: ``ladine_tpu_torch`` is the port, ``ladine_tpu`` the JAX
package."""

import ast
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "ladine_tpu"}


def imports(path: Path):
    """The top-level names a source imports, wherever in it."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


SOURCES = sorted(PORTBENCH.rglob("*.py"))


def test_guard_reads_every_part():
    parts = {p.relative_to(PORTBENCH).parts[0] for p in SOURCES}
    assert {"run.py", "harness.py", "judge.py", "metrics", "work", "reference", "families", "tests"} <= parts


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PORTBENCH)))
def test_no_jax_anywhere(path):
    assert not imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PORTBENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not imports(path) & (FORBIDDEN | {"ladine_tpu_torch", "portbench"})


def test_the_guard_compares_whole_names(tmp_path):
    src = tmp_path / "x.py"
    src.write_text("import ladine_tpu_torch.kernels\nfrom jaxtyping import Array\n")
    assert not imports(src) & FORBIDDEN
    src.write_text("def f():\n    from ladine_tpu.infer import serve\n")
    assert imports(src) & FORBIDDEN == {"ladine_tpu"}
