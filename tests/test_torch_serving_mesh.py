"""Tensor-parallel serving in the port (`ContinuousBatcher(mesh_spec=n)`
over a `parallel/mesh.ServingMesh`) against the port at tp=1 and the
JAX engine at tp=2, the oracles of JAX tests/test_serving_mesh.py.

The port's slice is DLROVER_TPU_TORCH_FORCE_DEVICE_COUNT=8 CPU shards
(set for this module, as the conftest forces JAX's eight host
devices). Greedy and sampled streams at tp=2 must equal tp=1's exactly
(dense, paged, int8 KV, prefix cache, speculative, async 0/1, adapters,
int8 weights); greedy streams must also equal the JAX engine's at
tp=2 (its runs cached per module: one compile per config). Sampled
streams are held to the port's own tp=1 (the draws are torch's). The
first-decode logits of the two layouts at tp=2 against tp=1's: byte
equal (the colocated shards take their projections in one product on
the stored weight, `parallel/sharding.Sharded.whole`)."""

import dataclasses
import itertools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.ops import flash_attention as jfa
from dlrover_tpu.ops import paged_attention as jpa
from dlrover_tpu.parallel.mesh import serving_mesh_spec as jserving_mesh_spec
from dlrover_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from dlrover_tpu_torch import _device
from dlrover_tpu_torch.models import decode as tdec
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.ops import flash_attention as tfa
from dlrover_tpu_torch.ops import paged_attention as tpa
from dlrover_tpu_torch.parallel import mesh as tmesh_mod
from dlrover_tpu_torch.parallel.mesh import (
    SERVING_TP_AXIS,
    MeshSpec,
    serving_kv_spec,
    serving_mesh,
    serving_mesh_spec,
)
from dlrover_tpu_torch.parallel.sharding import Sharded
from dlrover_tpu_torch.serving import adapters as tad
from dlrover_tpu_torch.serving.engine import ContinuousBatcher

FORCE = _device.FORCE_DEVICE_COUNT_ENV
ENGINE = dict(n_slots=3, max_len=64, max_new_tokens=10, chunk=4,
              eos_id=None)


@pytest.fixture(scope="module", autouse=True)
def eight_cpu_shards():
    """Eight virtual CPU devices for the port (JAX's conftest forces
    eight host devices) and one intra-op thread (the engine runs many
    small ops beside the other test workers); both restored after."""
    old = os.environ.get(FORCE)
    os.environ[FORCE] = "8"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    if old is None:
        os.environ.pop(FORCE, None)
    else:
        os.environ[FORCE] = old


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    tparams = tllama.params_from_numpy(tcfg, tree, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=n).tolist() for n in lengths]


def _port(model, prompts, **kw):
    _, _, tcfg, tparams = model
    kw = {**ENGINE, **kw}
    eng = ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    return [list(map(int, o)) for o in eng.generate_all(prompts)], eng


_JAX_RUNS = {}


def _jax(model, prompts, **kw):
    """The JAX engine's streams, cached per (prompts, knobs)."""
    key = (json.dumps(prompts), json.dumps(kw, sort_keys=True))
    if key not in _JAX_RUNS:
        jcfg, jparams, _, _ = model
        eng = JaxBatcher(jcfg, jparams, **{**ENGINE, **kw})
        _JAX_RUNS[key] = [list(map(int, o))
                          for o in eng.generate_all(prompts)]
    return _JAX_RUNS[key]


# ---------------------------------------------------------------------------
# parallel/mesh.py serving helpers (JAX TestServingMeshSpec)


class TestServingMeshSpec:
    def test_valid_spec_is_pure_tensor_slice(self):
        assert serving_mesh_spec(2, n_kv_heads=4, n_devices=8) == MeshSpec(
            tensor=2)
        assert jserving_mesh_spec(2, n_kv_heads=4, n_devices=8).tensor == 2

    @pytest.mark.parametrize("args,match", [
        ((4, 8, 2), "local devices"), ((3, 4, 8), "not divisible"),
        ((0, None, 8), ">= 1")])
    def test_invalid_specs_raise_jax_errors(self, args, match):
        tp, kv, n = args
        with pytest.raises(ValueError, match=match) as got:
            serving_mesh_spec(tp, n_kv_heads=kv, n_devices=n)
        with pytest.raises(ValueError) as want:
            jserving_mesh_spec(tp, n_kv_heads=kv, n_devices=n)
        assert str(got.value) == str(want.value)

    def test_serving_mesh_axis(self):
        mesh = serving_mesh(2, n_kv_heads=2, device="cpu")
        assert mesh.axis_names == (SERVING_TP_AXIS,)
        assert mesh.tp == 2
        assert mesh.devices == [torch.device("cpu")] * 2
        assert tmesh_mod.serving_mesh_tp(mesh) == 2
        assert tmesh_mod.serving_mesh_tp(None) == 1

    def test_kv_spec_shards_only_head_axis(self):
        assert tuple(serving_kv_spec()) == (None, None, None,
                                            SERVING_TP_AXIS)
        assert serving_kv_spec().split_dim() == 3

    def test_adapter_and_quant_specs_equal_jax(self):
        from dlrover_tpu.parallel import mesh as jmesh

        jm = jmesh.serving_mesh(2, n_kv_heads=2)
        tm = serving_mesh(2, n_kv_heads=2, device="cpu")
        assert ({k: tuple(v) for k, v in
                 tmesh_mod.serving_adapter_specs(tm).items()}
                == {k: tuple(v) for k, v in
                    jmesh.serving_adapter_specs(jm).items()})
        assert ([(p, tuple(s)) for p, s in
                 tmesh_mod.serving_weight_quant_specs()]
                == [(p, tuple(s)) for p, s in
                    jmesh.serving_weight_quant_specs()])

    @pytest.mark.parametrize("chips,kv,devs", [
        (4, 8, 8), (3, 4, 8), (8, 2, 8), (4, 8, 2), (1, 4, 8), (5, 6, 8)])
    def test_largest_serving_tp_equals_jax(self, chips, kv, devs):
        from dlrover_tpu.parallel.mesh import largest_serving_tp as jl

        assert tmesh_mod.largest_serving_tp(chips, kv, devs) == jl(
            chips, kv, devs)

    def test_local_devices(self, monkeypatch):
        cpu = torch.device("cpu")
        assert _device.local_devices("cpu") == [cpu] * 8
        monkeypatch.delenv(FORCE)
        assert _device.local_devices("cpu") == [cpu]
        monkeypatch.setenv(FORCE, "0")
        with pytest.raises(ValueError, match=FORCE):
            _device.local_devices("cpu")


# ---------------------------------------------------------------------------
# engine knob (JAX TestEngineKnobValidation)


class TestEngineKnobValidation:
    def test_bool_mesh_spec_rejected(self, model):
        _, _, tcfg, tparams = model
        with pytest.raises(ValueError, match="mesh_spec"):
            ContinuousBatcher(tcfg, tparams, device="cpu", mesh_spec=True)

    def test_dict_with_extra_axes_rejected(self, model):
        _, _, tcfg, tparams = model
        with pytest.raises(ValueError, match="extra axes"):
            ContinuousBatcher(tcfg, tparams, device="cpu",
                              mesh_spec={"tp": 2, "dp": 2})

    def test_non_divisible_heads_rejected(self, model):
        _, _, tcfg, tparams = model
        with pytest.raises(ValueError, match="not divisible"):
            ContinuousBatcher(tcfg, tparams, device="cpu", mesh_spec=3)

    def test_one_device_without_the_variable_raises(self, model,
                                                    monkeypatch):
        """JAX's verdict on a one-device host: its ValueError, text for
        text."""
        _, _, tcfg, tparams = model
        monkeypatch.delenv(FORCE)
        with pytest.raises(ValueError) as want:
            jserving_mesh_spec(2, n_kv_heads=2, n_devices=1)
        with pytest.raises(ValueError) as got:
            ContinuousBatcher(tcfg, tparams, device="cpu", mesh_spec=2)
        assert str(got.value) == str(want.value)

    def test_mesh_shape_and_chips(self, model):
        _, _, tcfg, tparams = model
        eng = ContinuousBatcher(tcfg, tparams, device="cpu", n_slots=2,
                                max_len=32)
        assert eng.mesh_shape == {"tp": 1} and eng.n_chips == 1
        assert eng.mesh is None
        eng1 = ContinuousBatcher(tcfg, tparams, device="cpu", n_slots=2,
                                 max_len=32, mesh_spec=1)
        assert eng1.mesh is None and eng1.n_chips == 1

    @pytest.mark.parametrize("layout", ["dense", "paged"])
    def test_tp2_engine_reports_slice_as_jax(self, model, layout):
        jcfg, jparams, tcfg, tparams = model
        j = JaxBatcher(jcfg, jparams, n_slots=2, max_len=32,
                       kv_layout=layout, mesh_spec={"tp": 2})
        t = ContinuousBatcher(tcfg, tparams, device="cpu", n_slots=2,
                              max_len=32, kv_layout=layout,
                              mesh_spec={"tp": 2})
        assert t.mesh_shape == j.mesh_shape == {"tp": 2}
        assert t.n_chips == j.n_chips == 2
        assert t.mesh.axis_names == j.mesh.axis_names == (SERVING_TP_AXIS,)
        assert t.kernel_path == j.kernel_path == "reference"
        assert t.elastic_stats()["tp"] == 2.0

    def test_tp2_placement(self, model):
        """wq/wk/wv split on their output columns (views of the one
        stored tensor on a colocated slice), everything else whole; the
        banks one dict per shard with KV / tp heads."""
        _, _, tcfg, tparams = model
        eng = ContinuousBatcher(tcfg, tparams, device="cpu", n_slots=2,
                                max_len=32, kv_layout="paged",
                                prefix_cache_rows=2, mesh_spec=2)
        lay = eng.params["layers"]
        for name in ("wq", "wk", "wv"):
            leaf = lay[name]
            assert isinstance(leaf, Sharded) and leaf.dim == 2
            assert leaf.whole is tparams["layers"][name]
            assert sum(leaf.widths()) == tparams["layers"][name].shape[2]
        for name in ("wo", "w_gate", "w_up", "w_down", "attn_norm"):
            assert lay[name] is tparams["layers"][name]
        assert isinstance(eng.page_pool, list) and len(eng.page_pool) == 2
        assert eng.page_pool[0]["k"].shape[3] == tcfg.n_kv_heads // 2
        assert eng.pool[1]["v"].shape[3] == tcfg.n_kv_heads // 2
        assert eng._table.shape == (2, 2)  # one host-planned table
        # weight bytes per shard: half of each split leaf
        full = ContinuousBatcher(tcfg, tparams, device="cpu", n_slots=2,
                                 max_len=32).weight_bytes_device()
        split = sum(tparams["layers"][n].numel() * 4
                    for n in ("wq", "wk", "wv"))
        assert eng.weight_bytes_device() == full - split // 2


# ---------------------------------------------------------------------------
# parity (JAX TestMeshParity)


class TestMeshParity:
    def test_tp1_knob_matches_unset(self, model):
        prompts = _prompts((5, 11, 3, 9), seed=1)
        assert _port(model, prompts, mesh_spec=1)[0] == _port(
            model, prompts)[0]

    @pytest.mark.parametrize("layout", ["dense", "paged"])
    def test_tp2_greedy_matches_tp1_and_jax_tp2(self, model, layout):
        prompts = _prompts((5, 11, 3, 9, 16), seed=2)
        got, eng = _port(model, prompts, kv_layout=layout, mesh_spec=2)
        assert got == _port(model, prompts, kv_layout=layout)[0]
        assert got == _jax(model, prompts, kv_layout=layout, mesh_spec=2)
        assert eng.mesh_tp == 2

    def test_tp2_int8_kv_matches_tp1(self, model):
        prompts = _prompts((5, 11, 3), seed=4)
        got, _ = _port(model, prompts, kv_quant=True, mesh_spec=2)
        assert got == _port(model, prompts, kv_quant=True)[0]
        assert got == _jax(model, prompts, kv_quant=True, mesh_spec=2)

    @pytest.mark.parametrize("layout", ["dense", "paged"])
    def test_first_decode_logits_byte_equal(self, model, layout):
        """The decode functions at tp=2 against tp=1 on one prompt:
        prefill, then one decode step; logits and every written cell
        byte-equal."""
        _, _, tcfg, tparams = model
        from dlrover_tpu_torch.serving.engine import (
            _serving_param_rules,
        )
        from dlrover_tpu_torch.parallel.sharding import shard_tree

        mesh = serving_mesh(2, n_kv_heads=2, device="cpu")
        sparams = shard_tree(tparams, mesh, _serving_param_rules())
        prompt = torch.tensor(_prompts((13,), seed=5)[0])
        out = {}
        for tp, (p, m) in {1: (tparams, None), 2: (sparams, mesh)}.items():
            if layout == "dense":
                cache = tdec.init_kv_cache(tcfg, 1, 32, device="cpu",
                                           mesh=m)
                lg0, cache = tdec.prefill(tcfg, p, prompt[None], cache,
                                          mesh=m)
                lg1, cache = tdec.decode_step(tcfg, p, prompt[-1:], cache,
                                              torch.tensor([13]), mesh=m)
            else:
                pool = tdec.init_page_pool(tcfg, 5, 8, device="cpu", mesh=m)
                table = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
                row = tdec.prefill_exact_row(tcfg, p, prompt, 32, mesh=m)
                lg0 = None
                tdec.paged_install_row(pool, row, table[0], 0, 13)
                lg1, pool = tdec.paged_decode_step(
                    tcfg, p, prompt[-1:], pool, table, torch.tensor([13]),
                    mesh=m)
                cache = pool
            out[tp] = (lg0, lg1, tdec.kv_read(cache, lambda a: a))
        for a, b in zip(out[1][:2], out[2][:2]):
            assert a is None or torch.equal(a, b)
        for name, arr in out[1][2].items():
            assert torch.equal(arr, out[2][2][name]), name


SWEEP = list(itertools.product(("dense", "paged"), (0.0, 0.8),
                               ("prefix", "spec"), (0, 1)))


@pytest.mark.parametrize("layout,temperature,feature,depth", SWEEP)
def test_mesh_parity_sweep(model, layout, temperature, feature, depth):
    """JAX TestMeshParitySweep at its sizes: a shared 16-token prefix
    plus 2-10 tokens, five prompts, three slots; port tp=2 against port
    tp=1 in every case, and against the JAX engine at tp=2 in the
    greedy async-0 cases (its draws are threefry's)."""
    seed = int(np.frombuffer(
        f"{layout}{temperature}{feature}{depth}".encode(), np.uint8).sum())
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 250, size=16).tolist()
    prompts = [shared + rng.integers(1, 250, size=int(n)).tolist()
               for n in rng.integers(2, 10, size=5)]
    kw = dict(max_len=60, max_new_tokens=8, temperature=temperature,
              top_k=20 if temperature > 0 else 0, kv_layout=layout,
              async_depth=depth, seed=7)
    if feature == "prefix":
        kw.update(prefix_cache_rows=4, prefix_block=16)
    else:
        kw.update(spec_draft_len=4)
    base, _ = _port(model, prompts, **kw)
    got, eng = _port(model, prompts, mesh_spec=2, **kw)
    assert got == base
    assert eng.mesh_tp == 2
    if temperature == 0.0 and depth == 0:
        assert got == _jax(model, prompts, mesh_spec=2, **kw)


# ---------------------------------------------------------------------------
# ops gates (JAX TestOpsSupportsTp)


class TestOpsSupportsTp:
    def test_flash_divides_heads_per_shard(self):
        q, k = (2, 128, 4, 64), (2, 128, 2, 64)
        assert tfa.supports_shapes(q, k)
        assert tfa.supports_shapes(q, k, tp=2)
        assert not tfa.supports_shapes(q, k, tp=4)
        jq = jax.ShapeDtypeStruct(q, jnp.float32)
        jk = jax.ShapeDtypeStruct(k, jnp.float32)
        for tp in (1, 2, 4):
            assert tfa.supports_shapes(q, k, tp=tp) == jfa.supports(
                jq, jk, tp=tp)

    def test_flash_tp_matches_explicit_shard_shapes(self):
        assert tfa.supports_shapes((2, 128, 8, 64), (2, 128, 4, 64),
                                   tp=2) == tfa.supports_shapes(
            (2, 128, 4, 64), (2, 128, 2, 64))

    def test_paged_divides_heads_per_shard(self):
        q = torch.zeros((2, 4, 64))
        pages = {n: torch.zeros((8, 16, 2, 64)) for n in ("k", "v")}
        table = torch.zeros((2, 4), dtype=torch.int32)
        assert tpa.supports(q, pages, table)
        assert tpa.supports(q, pages, table, tp=2)
        assert not tpa.supports(q, pages, table, tp=4)

    def test_paged_kernel_gate_under_tp(self):
        """CPU tensors take the reference at any tp; on the card the
        kernel wherever the per-shard shapes pass (`takes_kernel`),
        JAX's forced use_kernel."""
        q = torch.zeros((2, 4, 64))
        pages = {n: torch.zeros((8, 16, 2, 64)) for n in ("k", "v")}
        table = torch.zeros((2, 4), dtype=torch.int32)
        assert not tpa.use_kernel(q, pages, table, tp=2)
        assert tpa.takes_kernel((2, 4, 64), (8, 16, 2, 64), (2, 4), "cuda",
                                tp=2)
        assert not tpa.takes_kernel((2, 4, 64), (8, 16, 2, 64), (2, 4),
                                    "cuda", tp=4)
        jq = jax.ShapeDtypeStruct((2, 4, 64), jnp.float32)
        jpages = {n: jax.ShapeDtypeStruct((8, 16, 2, 64), jnp.float32)
                  for n in ("k", "v")}
        assert jpa.supports(jq, jpages, np.zeros((2, 4), np.int32), tp=4) \
            is False


# ---------------------------------------------------------------------------
# control plane: gauges and the heartbeat's slice


class TestMeshTelemetry:
    def test_metrics_expose_mesh_gauges(self):
        from dlrover_tpu.serving.metrics import ServingMetrics as JM
        from dlrover_tpu_torch.serving.metrics import ServingMetrics

        for cls in (ServingMetrics, JM):
            m = cls()
            m.set_mesh(2, 2)
            text = m.render()
            assert "serving_mesh_tp 2" in text
            assert "serving_replica_chips 2" in text
            assert m.mesh_tp == 2 and m.replica_chips == 2

    def test_heartbeat_carries_a_tp2_engines_slice(self, model):
        from dlrover_tpu_torch.serving.replica import InferenceReplica

        _, _, tcfg, tparams = model
        eng = ContinuousBatcher(tcfg, tparams, device="cpu", n_slots=2,
                                max_len=32, mesh_spec=2)
        sched = types.SimpleNamespace(
            engine=eng, pressure=lambda: 0.0, queue_depth=lambda: 0,
            active_count=lambda: 0, on_failure=None, _thread=None,
            crashed=False, start=lambda: None, stop=lambda: None)
        rep = InferenceReplica("rep-0", sched)
        meta = json.loads(rep._meta().decode())
        assert meta["mesh_shape"] == {"tp": 2}
        assert meta["n_chips"] == 2


# ---------------------------------------------------------------------------
# adapters at tp=2 (JAX tests/test_serving_adapters.py:255-275)


@pytest.fixture(scope="module")
def registry(model):
    from dlrover_tpu.models import lora as jlora

    jcfg, jparams, tcfg, _ = model
    reg = tad.AdapterRegistry(tcfg, max_rank=8)
    for i, (aid, alpha) in enumerate((("ad1", 8.0), ("ad2", 4.0))):
        lc = jlora.LoraConfig(rank=4 - 2 * i, alpha=alpha)
        _, p = jlora.inject(jcfg, jparams, lc, jax.random.PRNGKey(i + 1))
        layers = dict(p["layers"])
        for k in list(layers):
            if k.endswith(jlora.LORA_B):
                layers[k] = jax.random.normal(
                    jax.random.PRNGKey(i + 101), layers[k].shape,
                    jnp.float32) * 0.05
        p = dict(p)
        p["layers"] = layers
        sd = jax.tree_util.tree_map(np.asarray, jlora.adapter_state_dict(p))
        reg.register(aid, sd, alpha=alpha)
    return reg


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_adapters_tp2_matches_tp1(model, registry, layout):
    """The sharded bank (B split on its output columns) changes nothing:
    tp=2 mixed-adapter streams equal tp=1's."""
    _, _, tcfg, tparams = model
    prompts = _prompts((5, 9, 7), seed=4)
    aids = ["ad1", "ad2", None]
    outs = {}
    for tp in (1, 2):
        eng = ContinuousBatcher(tcfg, tparams, device="cpu", n_slots=2,
                                max_len=64, max_new_tokens=8, eos_id=None,
                                kv_layout=layout, adapter_registry=registry,
                                mesh_spec=tp)
        for p, a in zip(prompts, aids):
            eng.submit(p, adapter_id=a)
        outs[tp] = [list(map(int, o)) for o in eng.generate_all([])]
        if tp == 2:
            assert eng.mesh_shape == {"tp": 2}
            bank = eng._adapter_cache.bank
            assert isinstance(bank["wq_b"], Sharded)
            assert not isinstance(bank["wq_a"], Sharded)
            assert not isinstance(bank["wo_b"], Sharded)
    assert outs[2] == outs[1]


# ---------------------------------------------------------------------------
# int8 weights at tp=2 (JAX tests/test_serving_weight_quant.py:425-455)


def _q_bytes(params):
    out = []
    for name in sorted(params["layers"]):
        w = params["layers"][name]
        if isinstance(w, Sharded):
            w = w.gather()
        if hasattr(w, "q8"):
            out.append((name, w.q8.numpy().tobytes(),
                        w.s8.numpy().tobytes()))
    return out


class TestTensorParallelInt8:
    def test_tp2_int8_agrees_with_tp1_int8(self, model):
        prompts = _prompts((5, 9, 12), seed=61)
        want, _ = _port(model, prompts, weight_quant="int8")
        got, eng = _port(model, prompts, weight_quant="int8", mesh_spec=2)
        assert eng.weight_quant_path == "int8:reference"
        assert isinstance(eng.params["layers"]["wq"], Sharded)
        assert eng.params["layers"]["wq"].dim == 1   # output-major q8
        assert got == want

    def test_elastic_shrink_reshards_without_requantize(self, model):
        _, _, tcfg, tparams = model
        prompts = _prompts((5, 9, 12), seed=62)
        want, _ = _port(model, prompts, weight_quant="int8", mesh_spec=2)
        eng = ContinuousBatcher(tcfg, tparams, device="cpu",
                                weight_quant="int8", mesh_spec=2, **ENGINE)
        bits_before = _q_bytes(eng.params)
        idxs = [eng.submit(p) for p in prompts]
        eng.step()
        eng.step()
        report = eng.resize(1)
        assert report.direction == "shrink"
        while eng.has_work():
            eng.step()
        got = [list(map(int, eng._requests[i].out)) for i in idxs]
        assert got == want
        assert eng.mesh_tp == 1 and eng.mesh is None
        assert not isinstance(eng.params["layers"]["wq"], Sharded)
        assert _q_bytes(eng.params) == bits_before
        assert eng.elastic_stats()["resize_shrink"] == 1.0
        assert eng.weight_quant_path == "int8:reference"


# ---------------------------------------------------------------------------
# the host KV tier, the handoff and a weight refresh at tp=2: what leaves
# the slice is in the one-device layout


def _churn(eng, rounds):
    out = []
    for prompts in rounds:
        for p in prompts:
            eng.submit(p, max_new=4)
        out.append([list(map(int, o)) for o in eng.generate_all([])])
    return out


@pytest.mark.parametrize("kw", [
    dict(kv_layout="paged", prefix_cache_rows=1),
    dict(prefix_cache_rows=1),
    dict(kv_layout="paged", prefix_cache_rows=1, kv_quant=True)],
    ids=["paged", "dense", "paged-int8"])
def test_kv_tier_demotes_the_one_device_layout(model, kw):
    """Demotions gather the head shards, promotions cut them back: the
    streams, every tier counter (bytes_used included) and the entries'
    bytes equal tp=1's."""
    prompts = _prompts((20, 21, 22, 23), seed=11)
    rounds = [prompts, prompts]
    runs = {}
    for tp in (1, 2):
        eng = _port(model, [], kv_tier_bytes=32 << 20, mesh_spec=tp,
                    **kw)[1]
        runs[tp] = (_churn(eng, rounds), eng.kv_tier_stats(), eng)
    assert runs[2][0] == runs[1][0]
    assert runs[2][1] == runs[1][1]
    assert runs[2][1]["demotions"] >= 2 and runs[2][1]["promotions"] >= 1
    for key, ent in runs[1][2].kv_tier._entries.items():
        ent2 = runs[2][2].kv_tier._entries[key]
        for name, t in ent.data.items():
            assert torch.equal(t, ent2.data[name]), name


def test_pressure_swaps_at_tp2(model):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 250, size=int(k)).tolist()
               for k in rng.integers(12, 30, size=8)]
    kw = dict(n_slots=3, max_new_tokens=12, kv_layout="paged", page_size=8,
              n_pages=14, kv_tier_bytes=64 << 20)
    base, e1 = _port(model, prompts, **kw)
    got, e2 = _port(model, prompts, mesh_spec=2, **kw)
    assert got == base
    assert e2.kv_tier_stats() == e1.kv_tier_stats()
    assert e2.kv_tier_stats()["swap_ins"] > 0
    e2.allocator.check()


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("transport", ["device", "host"])
def test_handoff_packages_equal_tp1s(model, layout, transport):
    """export_run from a tp=2 prefill engine ships tp=1's bytes and
    checksum; a tp=2 decode engine adopts them (and a tp=1 one adopts
    the tp=2 package) with the colocated streams."""
    from dlrover_tpu_torch.serving import handoff

    _, _, tcfg, tparams = model
    prompts = _prompts((5, 12, 8), seed=20)
    kw = dict(kv_layout=layout, kv_checksums=1, n_slots=3, max_len=64,
              max_new_tokens=8, eos_id=None)

    def make(tp, **extra):
        return ContinuousBatcher(tcfg, tparams, device="cpu", mesh_spec=tp,
                                 **kw, **extra)

    coloc = make(1, seed=7)
    for p in prompts:
        coloc.submit(p)
    want = [list(map(int, o)) for o in coloc.generate_all([])]
    pkgs = {}
    for tp in (1, 2):
        pre = make(tp, replica_role="prefill", seed=7)
        for p in prompts:
            pre.submit(p)
        out = []
        while pre.has_work() and len(out) < len(prompts):
            pre.step()
            for req in pre.take_prefilled():
                out.append(handoff.export_run(pre, req.idx,
                                              transport=transport))
                pre.retire(req.idx)
        pkgs[tp] = out
    for a, b in zip(pkgs[1], pkgs[2]):
        assert a.checksum == b.checksum
        assert a.data.keys() == b.data.keys()
        for name in a.data:
            assert torch.equal(a.data[name], b.data[name]), name
    for src, dst in ((2, 2), (2, 1), (1, 2)):
        dec = make(dst, replica_role="decode", seed=99)
        ids = [dec.submit_adopted(p) for p in pkgs[src]]
        while dec.has_work():
            dec.step()
        got = [list(map(int, dec._requests[i].out)) for i in ids]
        assert got == want, (src, dst)


def test_live_refresh_at_tp2(model):
    """update_params(mode='live') re-places the new tree on the slice:
    the streams after the swap equal a tp=1 engine's on the new tree."""
    _, _, tcfg, tparams = model
    tree_b = {k: (v if not isinstance(v, dict) else
                  {n: t * 1.5 if n in ("wq", "wk", "wv", "w_up") else t
                   for n, t in v.items()})
              for k, v in tparams.items()}
    prompts = _prompts((6, 9, 11), seed=30)
    eng1 = _port(model, [], mesh_spec=1)[1]
    eng1.update_params(tree_b)
    want = [list(map(int, o)) for o in eng1.generate_all(prompts)]
    eng2 = _port(model, [], mesh_spec=2)[1]
    eng2.update_params(tree_b)
    assert isinstance(eng2.params["layers"]["wq"], Sharded)
    assert eng2.params["layers"]["wq"].whole is tree_b["layers"]["wq"]
    got = [list(map(int, o)) for o in eng2.generate_all(prompts)]
    assert got == want and eng2.weight_version == 1
