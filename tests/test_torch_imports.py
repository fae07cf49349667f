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


# the fleet's modules, named so a rename cannot drop them from the scan
FLEET = ("master/__init__.py", "master/kv_store.py", "brain/__init__.py",
         "brain/datastore.py", "brain/algorithms.py", "serving/affinity.py",
         "serving/handoff.py", "serving/replica.py", "serving/gateway.py")


@pytest.mark.parametrize("rel", FLEET)
def test_fleet_module_scanned(rel):
    path = ROOT / "dlrover_tpu_torch" / rel
    assert path in FILES
    assert not [n for _, n in _imports(path) if _banned(n)]


# the control plane's modules (master, client, transport, data pipeline)
CONTROL = ("common/comm.py", "common/messages.py", "common/node.py",
           "common/constants.py", "master/master.py", "master/servicer.py",
           "master/status_flow.py", "master/node_manager.py",
           "master/rendezvous.py", "master/shard/dataset_splitter.py",
           "master/shard/task_manager.py", "master/monitor/speed_monitor.py",
           "master/monitor/error_monitor.py", "master/elastic_ps.py",
           "master/net_topology.py", "master/stats.py",
           "agent/master_client.py", "trainer/elastic/data.py")


@pytest.mark.parametrize("rel", CONTROL)
def test_control_plane_module_scanned_and_grpc_free(rel):
    path = ROOT / "dlrover_tpu_torch" / rel
    assert path in FILES
    names = [n for _, n in _imports(path)]
    assert not [n for n in names if _banned(n)]
    assert not [n for n in names if n == "grpc" or n.startswith("grpc.")]


def test_every_module_imports_without_grpc():
    """Every module of the port imports in a fresh interpreter where
    `import grpc` fails (as on the card's machine, which has no grpc):
    the port's master, client and transport run on the stdlib."""
    import subprocess
    import sys

    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in FILES if p.parent != ROOT)
    code = (
        "import sys, importlib\n"
        "sys.modules['grpc'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sum(n.startswith('dlrover_tpu_torch') for n in sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= len(mods)


def test_serving_exports_equal_jax():
    import dlrover_tpu.serving as jserving
    import dlrover_tpu_torch.serving as tserving

    assert set(tserving.__all__) == set(jserving.__all__)
    for name in set(tserving.__all__) - {"TIERS"}:
        module = getattr(tserving, name).__module__
        assert module.startswith("dlrover_tpu_torch."), (name, module)
