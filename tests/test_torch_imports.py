"""The PyTorch port imports neither JAX nor the JAX package.

An AST scan of every .py under dlrover_tpu_torch/ and of chip_smoke.py:
no `import` or `from ... import` of jax, jaxlib, optax or dlrover_tpu
(the exact name or a dotted child). A scan and not a sys.modules check,
because an interpreter may have jax preloaded by site customization."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "optax", "dlrover_tpu")
FILES = sorted((ROOT / "dlrover_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def _banned(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BANNED)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_banned_name_rule():
    assert _banned("jax") and _banned("jax.numpy") and _banned("dlrover_tpu")
    assert _banned("dlrover_tpu.ops.attention") and _banned("optax")
    assert not _banned("dlrover_tpu_torch") and not _banned("jaxtyping")
    assert not _banned("dlrover_tpu_torch.ops")


@pytest.mark.parametrize(
    "path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES]
)
def test_no_jax_imports(path):
    assert path.exists(), path
    bad = [(ln, name) for ln, name in _imports(path) if _banned(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
