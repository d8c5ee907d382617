"""Nothing of the benchmark imports JAX or the JAX package, and the
reference and its helpers import nothing of the program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REFERENCE_SIDE = ("reference.py", "judge.py", "gen.py", "sq8.py",
                  "roofline.py")


def imported_tops(path: Path) -> set:
    """Whole top-level names of every import in ``path``."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def modules():
    return sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", modules(),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not imported_tops(path) & {"jax", "jaxlib", "flax", "repro"}


def test_reference_side_imports_nothing_of_the_program():
    seen, todo = set(), list(REFERENCE_SIDE)
    while todo:  # the reference's helpers, followed through bench imports
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        tree = ast.parse((BENCH / name).read_text())
        assert "repro_torch" not in imported_tops(BENCH / name), name
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == "bench":
                todo += [f"{a.name}.py" for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("bench."):
                todo.append(node.module.split(".")[1] + ".py")
    assert {"reference.py", "gen.py", "sq8.py"} <= seen


def test_the_prefix_is_compared_whole():
    from bench import run

    assert "repro_torch" not in run.FORBIDDEN
    assert "repro" in run.FORBIDDEN
