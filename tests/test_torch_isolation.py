"""The port stands alone: no module of `src/repro_torch/` and not
`chip_smoke.py` imports JAX or anything of the JAX package `repro`
(only `repro_torch`). The machine with the card has no JAX."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_package():
    assert len(FILES) > 20
    assert (ROOT / "chip_smoke.py").exists()


def test_scan_catches_a_reference_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import numpy\nfrom repro.core import fastmax\n"
                   "import jax.numpy as jnp\nfrom repro_torch import core\n")
    assert [m for m in _imported_modules(bad) if _forbidden(m)] == [
        "repro.core", "jax.numpy"]
