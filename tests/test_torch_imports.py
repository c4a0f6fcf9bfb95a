"""The port stands alone: no module of krylov_crn_tpu_torch, nor
chip_smoke.py, imports jax or anything of the JAX package (the card's
machine has neither)."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "krylov_crn_tpu")


def _imports(path):
    """Every module name a source file imports, at any depth (imports
    inside functions too)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("root", ["krylov_crn_tpu_torch", "chip_smoke.py"])
def test_port_imports_no_jax(root):
    target = REPO / root
    files = sorted(target.rglob("*.py")) if target.is_dir() else [target]
    assert files
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"the port must not import the JAX side: {bad}"
