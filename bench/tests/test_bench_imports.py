"""No module of the harness imports JAX or the JAX package, comparing
top-level names whole (the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast

import pytest

import _tiny

BENCH = _tiny.ROOT / "bench"
BANNED = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not (top_imports(path) & BANNED)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert top_imports(path) <= {"__future__", "contextlib", "math",
                                 "typing", "torch", "bench"}
    src = path.read_text()
    assert "repro_torch" not in src


def test_whole_names_are_compared():
    from bench import harness
    names = ["repro_torch.serving.engine", "reprox", "jax.numpy",
             "repro.models.common", "flaxen", "jaxlib", "numpy"]
    assert harness.banned_modules(names) == ["jax", "jaxlib", "repro"]
