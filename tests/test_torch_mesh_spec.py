"""F7: the port's `ContinuousBatcher(mesh_spec=...)` against the JAX
engine's, on the tiny f32 Llama.

The knob matrix (None, 1, {"tp": 1}, an object with `.tensor = 1`, 0,
True, {"dp": 2}, 2) is accepted or refused case for case as the JAX
engine does on one device, with the same ValueError text. The JAX side
of this process has 8 virtual CPU devices, so its one-device verdict is
the reference's own `_parse_mesh_tp` + `serving_mesh_spec(...,
n_devices=1)`, which the test first holds to the JAX engine wherever the
device count does not change the verdict. With more devices than the
slice (DLROVER_TPU_TORCH_FORCE_DEVICE_COUNT=8, the counterpart of the
forced host devices), tp > 1 builds a tensor-parallel slice where JAX
builds a mesh, and the invalid cases still raise JAX's ValueError.

At tp=1 the port serves its default path: greedy streams equal the JAX
engine's, and `mesh_shape`, `n_chips` and `kernel_path` equal JAX's."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.parallel.mesh import serving_mesh_spec
from dlrover_tpu.serving import engine as jeng
from dlrover_tpu_torch import _device
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.serving import engine as teng

ENGINE = dict(n_slots=2, max_len=32)
KNOBS = [None, 1, {"tp": 1}, types.SimpleNamespace(tensor=1), 0, True,
         {"dp": 2}, 2]
KNOB_IDS = ["none", "int1", "dict_tp1", "tensor1", "int0", "bool",
            "dict_dp2", "int2"]


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    tparams = tllama.params_from_numpy(tcfg, tree, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _outcome(make):
    try:
        eng = make()
    except ValueError as e:
        return ("ValueError", str(e))
    return ("ok", eng.mesh_tp)


def _jax_verdict(mesh_spec, n_kv: int, n_devices: int):
    """The JAX engine's verdict on `mesh_spec` with `n_devices` local
    devices, from the reference's own parsing and checks."""
    if mesh_spec is None:
        return ("ok", 1)
    try:
        tp = jeng._parse_mesh_tp(mesh_spec)
        serving_mesh_spec(tp, n_kv_heads=n_kv, n_devices=n_devices)
    except ValueError as e:
        return ("ValueError", str(e))
    return ("ok", tp)


@pytest.mark.parametrize("mesh_spec", KNOBS, ids=KNOB_IDS)
def test_knob_matrix_as_jax_on_one_device(model, mesh_spec):
    jcfg, jparams, tcfg, tparams = model
    n_kv = jcfg.n_kv_heads
    one = _jax_verdict(mesh_spec, n_kv, 1)
    if mesh_spec != 2:
        # the verdict does not depend on the device count here: the JAX
        # engine itself (8 virtual devices) gives it
        assert _jax_verdict(mesh_spec, n_kv, jax.local_device_count()) == one
        assert _outcome(lambda: jeng.ContinuousBatcher(
            jcfg, jparams, mesh_spec=mesh_spec, **ENGINE)) == one
    got = _outcome(lambda: teng.ContinuousBatcher(
        tcfg, tparams, device="cpu", mesh_spec=mesh_spec, **ENGINE))
    assert got == one


def test_tp_above_one_with_enough_devices(model, monkeypatch):
    """With eight devices (DLROVER_TPU_TORCH_FORCE_DEVICE_COUNT=8, as
    JAX's eight forced host devices) tp=2 builds a slice in the port
    where JAX builds a mesh, with the same slice properties; tp not
    dividing the KV heads, or past the devices, raises JAX's
    ValueError."""
    jcfg, jparams, tcfg, tparams = model
    monkeypatch.setenv(_device.FORCE_DEVICE_COUNT_ENV, "8")
    assert _jax_verdict(2, jcfg.n_kv_heads, 8) == ("ok", 2)
    j = jeng.ContinuousBatcher(jcfg, jparams, mesh_spec=2, **ENGINE)
    t = teng.ContinuousBatcher(tcfg, tparams, device="cpu", mesh_spec=2,
                               **ENGINE)
    assert t.mesh_tp == j.mesh_tp == 2
    assert t.mesh_shape == j.mesh_shape and t.n_chips == j.n_chips == 2
    assert t.mesh.tp == 2 and t.mesh.axis_names == j.mesh.axis_names
    for tp in (3, 16):
        want = _jax_verdict(tp, jcfg.n_kv_heads, 8)
        assert want[0] == "ValueError"
        assert _outcome(lambda: teng.ContinuousBatcher(
            tcfg, tparams, device="cpu", mesh_spec={"tp": tp},
            **ENGINE)) == want


def test_local_device_count(monkeypatch):
    """`_device.local_devices` (which replaced the engine's device
    count): one CPU, or the forced count of it."""
    cpu = torch.device("cpu")
    monkeypatch.delenv(_device.FORCE_DEVICE_COUNT_ENV, raising=False)
    assert _device.local_devices(cpu) == [cpu]
    monkeypatch.setenv(_device.FORCE_DEVICE_COUNT_ENV, "8")
    assert _device.local_devices(cpu) == [cpu] * 8


@pytest.mark.parametrize("attn_impl", ["reference", "auto"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_slice_properties_equal_jax(model, layout, attn_impl):
    jcfg, jparams, _, tparams = model
    jcfg = dataclasses.replace(jcfg, attn_impl=attn_impl)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, attn_impl=attn_impl)
    for mesh_spec in (None, {"tp": 1}):
        j = jeng.ContinuousBatcher(jcfg, jparams, kv_layout=layout,
                                   mesh_spec=mesh_spec, **ENGINE)
        t = teng.ContinuousBatcher(tcfg, tparams, device="cpu",
                                   kv_layout=layout, mesh_spec=mesh_spec,
                                   **ENGINE)
        assert t.mesh_shape == j.mesh_shape == {"tp": 1}
        assert t.n_chips == j.n_chips == 1
        assert t.kernel_path == j.kernel_path == "reference"
        assert t.elastic_stats()["tp"] == 1.0


def test_greedy_streams_at_mesh_spec_1_equal_jax(model):
    """ROADMAP F7's input: prompts of 5, 9 and 3 tokens from
    default_rng(1), max_new 6."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 250, size=n).tolist() for n in (5, 9, 3)]
    j = jeng.ContinuousBatcher(jcfg, jparams, mesh_spec=1, **ENGINE)
    assert j.mesh is None and j.mesh_tp == 1
    for p in prompts:
        j.submit(p, max_new=6)
    want = [[int(x) for x in o] for o in j.generate_all([])]
    for mesh_spec in (1, {"tp": 1}):
        t = teng.ContinuousBatcher(tcfg, tparams, device="cpu",
                                   mesh_spec=mesh_spec, **ENGINE)
        for p in prompts:
            t.submit(p, max_new=6)
        got = [[int(x) for x in o] for o in t.generate_all([])]
        assert got == want
        assert all(len(s) == 6 for s in got)
