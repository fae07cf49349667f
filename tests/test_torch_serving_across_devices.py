"""Tensor-parallel serving on a slice whose shards are NOT on one device:
the per-shard branch of the design, which a machine with several cards
takes (models/decode.py `_qkv_sharded`'s product loop, the contiguous
pieces of `parallel/sharding.split_leaf`, `Sharded.gather`, the moves of
`ServingMesh.split` / `gather` / `broadcast` and of `kv_read` /
`kv_split`).

This machine has one CPU, so the slice is built over two device objects
that name it, `cpu` and `cpu:0`: they compare unequal, so the mesh is
not `colocated` and every leaf takes its across-devices layout (its own
contiguous piece per shard, no stored `whole`), while the tensors stay
on the CPU. The engine's device list is replaced for this module
(`engine.local_devices`, `elastic.local_devices`).

The oracle is the port at tp=1 (held to the JAX engine by
test_torch_serving_mesh.py): greedy and sampled streams equal, dense and
paged, with the prefix cache, speculative decoding, async dispatch,
int8 KV, int8 weights, adapters, the KV tier, the handoff and a resize
each way. The decode functions' logits and written cells are held to
tp=1's byte for byte: on this CPU a shard's product over its own
columns of wq/wk/wv sums as the whole product does."""

import itertools

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.models import decode as tdec
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models import lora as tlora
from dlrover_tpu_torch.parallel.mesh import ServingMesh
from dlrover_tpu_torch.parallel.sharding import Sharded, shard_tree
from dlrover_tpu_torch.serving import adapters as tad
from dlrover_tpu_torch.serving import elastic as tel
from dlrover_tpu_torch.serving import engine as teng
from dlrover_tpu_torch.serving import handoff

# two names of the one CPU: unequal devices, so the slice is "across
# devices" though every tensor stays where it is
DEVICES = [torch.device("cpu"), torch.device("cpu", 0)]
ENGINE = dict(n_slots=3, max_len=64, max_new_tokens=10, chunk=4,
              eos_id=None)


@pytest.fixture(scope="module", autouse=True)
def across_devices():
    """The engine's and the resize's local devices: DEVICES repeated to
    eight entries; one intra-op thread. Both restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (teng, tel):
            mp.setattr(mod, "local_devices", lambda device=None: DEVICES * 4)
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    return cfg, params


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=n).tolist() for n in lengths]


def _engine(model, tp, **kw):
    cfg, params = model
    return teng.ContinuousBatcher(cfg, params, device="cpu", mesh_spec=tp,
                                  **{**ENGINE, **kw})


def _streams(outs):
    return [list(map(int, o)) for o in outs]


def test_the_slice_is_across_devices(model):
    eng = _engine(model, 2)
    assert isinstance(eng.mesh, ServingMesh)
    assert not eng.mesh.colocated
    assert eng.mesh.devices == DEVICES
    layers = eng.params["layers"]
    for name in ("wq", "wk", "wv"):
        w = layers[name]
        assert isinstance(w, Sharded) and w.whole is None, name
        assert all(s.is_contiguous() for s in w.shards), name
        assert torch.equal(w.gather(), model[1]["layers"][name]), name
    assert not isinstance(layers["wo"], Sharded)


FEATURES = {
    "plain": {},
    "prefix": dict(prefix_cache_rows=4, prefix_block=16, max_len=60),
    "spec": dict(spec_draft_len=4, max_len=60),
    "async": dict(async_depth=1),
    "int8kv": dict(kv_quant=True),
    "int8w": dict(weight_quant="int8"),
}


@pytest.mark.parametrize("layout,temperature,feature", list(
    itertools.product(("dense", "paged"), (0.0, 0.8), FEATURES)))
def test_streams_equal_tp1(model, layout, temperature, feature):
    """Five prompts on a shared 16-token prefix: tp=2 across devices
    against tp=1, token for token."""
    rng = np.random.default_rng(3)
    shared = rng.integers(1, 250, size=16).tolist()
    prompts = [shared + rng.integers(1, 250, size=int(n)).tolist()
               for n in (3, 7, 5, 9, 2)]
    kw = dict(kv_layout=layout, temperature=temperature,
              top_k=20 if temperature > 0 else 0, seed=7,
              **FEATURES[feature])
    want = _streams(_engine(model, 1, **kw).generate_all(prompts))
    eng = _engine(model, 2, **kw)
    assert _streams(eng.generate_all(prompts)) == want
    if feature == "int8w":
        assert eng.weight_quant_path == "int8:reference"
        assert eng.params["layers"]["wq"].whole is None


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_functions_match_tp1(model, layout):
    """Prefill then one decode step through models/decode.py at tp=2
    across devices against tp=1: logits and every written cell byte
    equal."""
    cfg, params = model
    from dlrover_tpu_torch.serving.engine import _serving_param_rules

    mesh = ServingMesh(DEVICES)
    sparams = shard_tree(params, mesh, _serving_param_rules())
    assert sparams["layers"]["wq"].whole is None
    prompt = torch.tensor(_prompts((13,), seed=5)[0])
    out = {}
    for tp, (p, m) in {1: (params, None), 2: (sparams, mesh)}.items():
        if layout == "dense":
            cache = tdec.init_kv_cache(cfg, 1, 32, device="cpu", mesh=m)
            lg0, cache = tdec.prefill(cfg, p, prompt[None], cache, mesh=m)
            lg1, cache = tdec.decode_step(cfg, p, prompt[-1:], cache,
                                          torch.tensor([13]), mesh=m)
        else:
            cache = tdec.init_page_pool(cfg, 5, 8, device="cpu", mesh=m)
            table = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
            row = tdec.prefill_exact_row(cfg, p, prompt, 32, mesh=m)
            lg0 = None
            tdec.paged_install_row(cache, row, table[0], 0, 13)
            lg1, cache = tdec.paged_decode_step(
                cfg, p, prompt[-1:], cache, table, torch.tensor([13]),
                mesh=m)
        out[tp] = (lg0, lg1, tdec.kv_read(cache, lambda a: a))
    for a, b in zip(out[1][:2], out[2][:2]):
        assert a is None or torch.equal(a, b)
    for name, arr in out[1][2].items():
        assert torch.equal(arr, out[2][2][name]), name


def _registry(cfg, params):
    reg = tad.AdapterRegistry(cfg, max_rank=8)
    for i, (aid, rank, alpha) in enumerate((("ad1", 4, 8.0),
                                            ("ad2", 2, 4.0))):
        gen = torch.Generator().manual_seed(i + 1)
        _, p = tlora.inject(cfg, params,
                            tlora.LoraConfig(rank=rank, alpha=alpha), gen)
        layers = dict(p["layers"])
        for k in list(layers):
            if k.endswith(tlora.LORA_B):
                layers[k] = torch.randn(layers[k].shape, generator=gen) * 0.05
        sd = tlora.adapter_state_dict({"layers": layers})
        reg.register(aid, {"layers": {k: v.numpy()
                                      for k, v in sd["layers"].items()}},
                     alpha=alpha)
    return reg


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_adapters_equal_tp1(model, layout):
    """The adapter bank across devices (wq/wk/wv B banks in per-shard
    pieces, the rest replicated): mixed-adapter streams equal tp=1's."""
    cfg, params = model
    reg = _registry(cfg, params)
    prompts = _prompts((5, 9, 7), seed=4)
    outs = {}
    for tp in (1, 2):
        eng = _engine(model, tp, n_slots=2, max_new_tokens=8,
                      kv_layout=layout, adapter_registry=reg)
        for p, a in zip(prompts, ["ad1", "ad2", None]):
            eng.submit(p, adapter_id=a)
        outs[tp] = _streams(eng.generate_all([]))
        if tp == 2:
            bank = eng._adapter_cache.bank
            assert isinstance(bank["wq_b"], Sharded)
            assert bank["wq_b"].whole is None
    assert outs[2] == outs[1]


@pytest.mark.parametrize("layout,temperature", list(
    itertools.product(("dense", "paged"), (0.0, 0.8))))
def test_resize_both_ways(model, layout, temperature):
    """Shrink to tp=1 after two steps and grow back to tp=2 (across
    devices again) a step later: the streams equal the unresized run's;
    int8 weights keep their bytes through both."""
    prompts = _prompts((5, 11, 3, 9, 16), seed=8)
    kw = dict(kv_layout=layout, temperature=temperature,
              top_k=20 if temperature > 0 else 0, seed=7,
              weight_quant="int8")
    want = _streams(_engine(model, 2, **kw).generate_all(prompts))
    eng = _engine(model, 2, **kw)
    q8 = eng.params["layers"]["wq"].gather().q8.clone()
    ids = [eng.submit(p) for p in prompts]
    eng.step()
    eng.step()
    assert eng.resize(1).direction == "shrink"
    eng.step()
    assert eng.resize(2).direction == "grow"
    assert not eng.mesh.colocated
    assert eng.params["layers"]["wq"].whole is None
    while eng.has_work():
        eng.step()
    assert _streams(eng._requests[i].out for i in ids) == want
    assert torch.equal(eng.params["layers"]["wq"].gather().q8, q8)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_kv_tier_entries_equal_tp1(model, layout):
    """Demotions gather the pieces into the one-device layout and
    promotions cut them back: streams, tier counters and entry bytes
    equal tp=1's."""
    prompts = _prompts((20, 21, 22, 23), seed=11)
    runs = {}
    for tp in (1, 2):
        eng = _engine(model, tp, kv_layout=layout, prefix_cache_rows=1,
                      kv_tier_bytes=32 << 20)
        out = []
        for _ in range(2):
            for p in prompts:
                eng.submit(p, max_new=4)
            out.append(_streams(eng.generate_all([])))
        runs[tp] = (out, eng.kv_tier_stats(), eng)
    assert runs[2][0] == runs[1][0]
    assert runs[2][1] == runs[1][1]
    assert runs[2][1]["demotions"] >= 2 and runs[2][1]["promotions"] >= 1
    for key, ent in runs[1][2].kv_tier._entries.items():
        for name, t in ent.data.items():
            assert torch.equal(t, runs[2][2].kv_tier._entries[key]
                               .data[name]), name


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_handoff_equals_tp1(model, layout):
    """A tp=2 prefill engine across devices ships tp=1's bytes and
    checksum; a tp=2 decode engine across devices adopts them with the
    colocated tp=1 streams."""
    prompts = _prompts((5, 12, 8), seed=20)
    kw = dict(kv_layout=layout, kv_checksums=1, max_new_tokens=8)
    coloc = _engine(model, 1, seed=7, **kw)
    want = _streams(coloc.generate_all(prompts))
    pkgs = {}
    for tp in (1, 2):
        pre = _engine(model, tp, replica_role="prefill", seed=7, **kw)
        for p in prompts:
            pre.submit(p)
        out = []
        while pre.has_work() and len(out) < len(prompts):
            pre.step()
            for req in pre.take_prefilled():
                out.append(handoff.export_run(pre, req.idx,
                                              transport="device"))
                pre.retire(req.idx)
        pkgs[tp] = out
    for a, b in zip(pkgs[1], pkgs[2]):
        assert a.checksum == b.checksum
        for name in a.data:
            assert torch.equal(a.data[name], b.data[name]), name
    dec = _engine(model, 2, replica_role="decode", seed=99, **kw)
    ids = [dec.submit_adopted(p) for p in pkgs[2]]
    while dec.has_work():
        dec.step()
    assert _streams(dec._requests[i].out for i in ids) == want
