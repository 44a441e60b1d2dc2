"""Nothing the benchmark runs imports JAX or the JAX package, the plain
reference imports nothing of the program, and nothing reads `benchmarks/`.
Top-level module names are compared whole: `qwen_tts_tpu_torch` is the
program, `qwen_tts_tpu` the JAX package."""

import ast
from pathlib import Path

import pytest

from h100_bench.run import FORBIDDEN

BENCH = Path(__file__).resolve().parent.parent
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & set(FORBIDDEN)
    assert "benchmarks/" not in path.read_text()


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "math", "torch"}


def test_whole_names_are_compared():
    assert "qwen_tts_tpu_torch" not in FORBIDDEN and "qwen_tts_tpu" in FORBIDDEN
    tree = ast.parse("import qwen_tts_tpu_torch.engine\nfrom jax import numpy\n")
    found = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import) else n.module
             for n in tree.body}
    assert found & set(FORBIDDEN) == {"jax"}
