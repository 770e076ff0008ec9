"""The port stands alone: no module of ``src/repro_torch``, and neither
``chip_smoke.py`` nor ``tools/*.py``, imports JAX or the JAX package
``repro`` (ROADMAP, Queue C), read from their syntax trees."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted([*(ROOT / "src" / "repro_torch").rglob("*.py"),
                ROOT / "chip_smoke.py", *(ROOT / "tools").glob("*.py")])
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted({name for name in _imports(tree) if _forbidden(name)})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_guard_sees_such_imports():
    src = "import jax.numpy as jnp\nfrom repro.core import krr\nimport repro_torch\n"
    assert sorted(n for n in _imports(ast.parse(src)) if _forbidden(n)) == [
        "jax.numpy", "repro.core"]
    assert len(FILES) > 50
