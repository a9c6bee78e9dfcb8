"""The port stands alone: no module of `src/repro_torch/` and not
`chip_smoke.py` imports JAX or anything of the JAX package `repro`
(only `repro_torch`). The machine with the card has no JAX."""
import ast
from pathlib import Path

import pytest
from torch_threads import share_cores  # noqa: F401,E402

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


def test_scan_covers_the_moe_slice():
    """The MoE module and the configs of the MoE slice are scanned."""
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in FILES
             if "repro_torch" in p.parts}
    assert {"models/moe.py", "models/layers.py", "models/transformer.py",
            "configs/llama3_405b.py", "configs/qwen2_5_32b.py",
            "configs/granite_20b.py", "configs/chameleon_34b.py",
            "configs/deepseek_v2_236b.py", "configs/kimi_k2_1t.py"} <= names


def test_scan_covers_the_ssm_slice():
    """The Mamba and xLSTM mixers and the configs built on them are
    scanned."""
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in FILES
             if "repro_torch" in p.parts}
    assert {"models/mamba.py", "models/xlstm.py", "models/param.py",
            "configs/jamba_52b.py", "configs/xlstm_1_3b.py"} <= names


def test_scan_covers_the_autotuner():
    """The schedule autotuner and the digest script it is checked with are
    scanned."""
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in FILES
             if "repro_torch" in p.parts}
    assert {"kernels/autotune.py", "kernels/ops.py",
            "launch/kernel_digest.py"} <= names


def test_scan_catches_a_reference_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import numpy\nfrom repro.core import fastmax\n"
                   "import jax.numpy as jnp\nfrom repro_torch import core\n")
    assert [m for m in _imported_modules(bad) if _forbidden(m)] == [
        "repro.core", "jax.numpy"]


def test_scan_covers_the_kernel_plans():
    """The kernel plans, the mesh context and the rank spawner are
    scanned."""
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in FILES
             if "repro_torch" in p.parts}
    assert {"kernels/sharded.py", "sharding/rules.py", "launch/ranks.py",
            "launch/train.py", "launch/steps.py"} <= names
