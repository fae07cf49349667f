"""The port's multi-adapter LoRA serving (dlrover_tpu_torch/serving/
adapters.py, the per-slot delta in models/llama.py and models/decode.py,
and the engine's adapter half) against the JAX package on the same
seed-made params and adapters.

The same numpy adapters are registered in both packages' registries.
Tolerances: the delta itself within 1e-6 (f32, two small products
summed in another order); the decode entries' logits within 1e-4 and
the caches they write within 1e-5 (tests/test_torch_decode.py's f32
rule: two layers of f32 products summed in other orders); greedy
streams, sampled streams against the port's own merged oracle, and all
integer state (bank slots, hit / miss / eviction / upload counters,
prefix-cache stats, paged stats) EXACTLY equal. Sampled streams are
held to the port's own merged-weight oracle under the same per-request
key, not to JAX's (the draws are torch's)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import decode as jdec
from dlrover_tpu.models import llama as jllama
from dlrover_tpu.models import lora as jlora
from dlrover_tpu.serving import adapters as jad
from dlrover_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from dlrover_tpu_torch.models import decode as tdec
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models import lora as tlora
from dlrover_tpu_torch.serving import adapters as tad
from dlrover_tpu_torch.serving import engine as teng

LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5
ENGINE = dict(n_slots=2, max_len=64, max_new_tokens=8, eos_id=None)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's engine runs many small ops: one intra-op thread keeps
    them fast beside the other test workers (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    tparams = tllama.params_from_numpy(tcfg, tree, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _make_adapter(jcfg, jparams, seed, rank=4, alpha=8.0):
    """JAX `inject` with B randomized (inject zeroes B), as the JAX
    tests' `_make_adapter`: the adapter_state_dict as numpy."""
    lc = jlora.LoraConfig(rank=rank, alpha=alpha)
    _, p = jlora.inject(jcfg, jparams, lc, jax.random.PRNGKey(seed))
    layers = dict(p["layers"])
    for k in list(layers):
        if k.endswith(jlora.LORA_B):
            layers[k] = jax.random.normal(
                jax.random.PRNGKey(seed + 100), layers[k].shape,
                jnp.float32) * 0.05
    p = dict(p)
    p["layers"] = layers
    return jax.tree_util.tree_map(np.asarray, jlora.adapter_state_dict(p))


ALPHAS = {"ad1": 8.0, "ad2": 4.0}


@pytest.fixture(scope="module")
def adapters(model):
    """(JAX registry, port registry, the numpy adapters, and the port's
    merged-weight tree per id: the merged-weight oracle)."""
    jcfg, jparams, tcfg, tparams = model
    sds = {"ad1": _make_adapter(jcfg, jparams, 1, rank=4, alpha=8.0),
           "ad2": _make_adapter(jcfg, jparams, 2, rank=2, alpha=4.0)}
    jreg = jad.AdapterRegistry(jcfg, max_rank=8)
    treg = tad.AdapterRegistry(tcfg, max_rank=8)
    merged = {None: tparams}
    for aid, sd in sds.items():
        jreg.register(aid, sd, alpha=ALPHAS[aid])
        treg.register(aid, sd, alpha=ALPHAS[aid])
        sd_t = {"layers": {k: torch.from_numpy(np.array(v, copy=True))
                           for k, v in sd["layers"].items()}}
        merged[aid] = tlora.merge(
            dataclasses.replace(tcfg, lora_alpha=ALPHAS[aid]),
            tlora.load_adapters(tparams, sd_t))
    return jreg, treg, sds, merged


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=n).tolist() for n in lengths]


def _tokens(outs):
    return [list(map(int, o)) for o in outs]


# ---------------------------------------------------------------------------
# registry (JAX TestRegistry, the same exception types and messages)


def test_register_lookup_roundtrip(model, adapters):
    jcfg, _, tcfg, _ = model
    _, _, sds, _ = adapters
    for mod, cfg in ((jad, jcfg), (tad, tcfg)):
        reg = mod.AdapterRegistry(cfg, max_rank=8)
        v1 = reg.register("a", sds["ad1"], alpha=8.0)
        assert "a" in reg and len(reg) == 1 and reg.ids() == ["a"]
        v2 = reg.register("a", sds["ad1"], alpha=8.0)
        assert v2 > v1 and reg.version("a") == v2
        assert reg.get("a").rank == 4 and reg.get("a").scale == 2.0
        reg.unregister("a")
        assert "a" not in reg
        with pytest.raises(KeyError, match="unknown adapter"):
            reg.get("a")
        with pytest.raises(KeyError, match="unknown adapter"):
            reg.unregister("a")


def _layers(sd):
    return dict(sd["layers"])


def _unservable(jcfg, jparams):
    lc = jlora.LoraConfig(rank=2, alpha=4.0, targets=("w_gate",))
    _, p = jlora.inject(jcfg, jparams, lc, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jlora.adapter_state_dict(p))


def _halved(sd):
    return {"layers": {k: v for k, v in sd["layers"].items()
                       if not k.startswith("wq" + jlora.LORA_B)}}


def _mixed(sd):
    layers = _layers(sd)
    layers["wq" + jlora.LORA_A] = layers["wq" + jlora.LORA_A][:, :, :2]
    layers["wq" + jlora.LORA_B] = layers["wq" + jlora.LORA_B][:, :2, :]
    return {"layers": layers}


def _bent(sd):
    layers = _layers(sd)
    layers["wk" + jlora.LORA_A] = layers["wk" + jlora.LORA_A][:, :-1, :]
    return {"layers": layers}


@pytest.mark.parametrize("case,match", [
    ("unservable", "not servable"), ("half_pair", "missing half"),
    ("mixed_ranks", "mixed ranks"), ("rank_above_max", "max_rank"),
    ("shape_drift", "must be"), ("not_a_leaf", "not an adapter leaf"),
    ("empty_id", "non-empty string"), ("no_layers", "adapter_state_dict"),
])
def test_registry_rejects_as_jax(model, adapters, case, match):
    jcfg, jparams, tcfg, _ = model
    _, _, sds, _ = adapters
    sd, max_rank, aid = sds["ad1"], 8, "x"
    if case == "unservable":
        sd = _unservable(jcfg, jparams)
    elif case == "half_pair":
        sd = _halved(sd)
    elif case == "mixed_ranks":
        sd = _mixed(sd)
    elif case == "rank_above_max":
        max_rank = 2
    elif case == "shape_drift":
        sd = _bent(sd)
    elif case == "not_a_leaf":
        sd = {"layers": {"wq": np.zeros((2, 64, 64), np.float32)}}
    elif case == "empty_id":
        aid = ""
    else:
        sd = {"weights": {}}
    for mod, cfg in ((jad, jcfg), (tad, tcfg)):
        reg = mod.AdapterRegistry(cfg, max_rank=max_rank)
        with pytest.raises(ValueError, match=match):
            reg.register(aid, sd)
        assert len(reg) == 0


def test_registry_max_rank_must_be_positive(model):
    jcfg, _, tcfg, _ = model
    for mod, cfg in ((jad, jcfg), (tad, tcfg)):
        with pytest.raises(ValueError, match="max_rank"):
            mod.AdapterRegistry(cfg, max_rank=0)


def test_registry_takes_torch_leaves(model, adapters):
    """The port's registry stores host numpy, whatever the leaves are:
    torch tensors register to the same arrays."""
    _, _, tcfg, _ = model
    _, _, sds, _ = adapters
    reg = tad.AdapterRegistry(tcfg, max_rank=8)
    reg.register("t", {"layers": {k: torch.from_numpy(np.array(v))
                                  for k, v in sds["ad1"]["layers"].items()}},
                 alpha=8.0)
    rec = reg.get("t")
    for t in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(
            rec.a[t], sds["ad1"]["layers"][t + jlora.LORA_A])
        assert isinstance(rec.b[t], np.ndarray)


# ---------------------------------------------------------------------------
# the delta and the decode entries


def _bank_np(cfg, slots=3, rank=4, seed=11):
    """A random stacked bank (slot 0 the zero adapter), its scale."""
    rng = np.random.default_rng(seed)
    bank = {}
    for t, (d_in, d_out) in jad._target_dims(cfg).items():
        a = rng.normal(size=(cfg.n_layers, slots, d_in, rank)) * 0.3
        b = rng.normal(size=(cfg.n_layers, slots, rank, d_out)) * 0.05
        a[:, 0] = 0.0
        b[:, 0] = 0.0
        bank[t + "_a"] = a.astype(np.float32)
        bank[t + "_b"] = b.astype(np.float32)
    scale = np.array([0.0, 2.0, 1.5], np.float32)[:slots]
    return bank, scale


def _operands(bank, scale, idx):
    jx = {"bank": {k: jnp.asarray(v) for k, v in bank.items()},
          "idx": jnp.asarray(idx, jnp.int32), "scale": jnp.asarray(scale)}
    pt = {"bank": {k: torch.from_numpy(v) for k, v in bank.items()},
          "idx": torch.as_tensor(np.asarray(idx), dtype=torch.long),
          "scale": torch.from_numpy(scale)}
    return jx, pt


def test_slot_lora_delta_matches_jax(model):
    jcfg, _, _, _ = model
    bank, scale = _bank_np(jcfg)
    rng = np.random.default_rng(5)
    h = rng.normal(size=(3, 4, jcfg.dim)).astype(np.float32)
    idx = np.array([1, 0, 2])
    want = np.asarray(jllama._slot_lora_delta(
        jnp.asarray(h), jnp.asarray(bank["wq_a"][0]),
        jnp.asarray(bank["wq_b"][0]), jnp.asarray(idx, jnp.int32),
        jnp.asarray(scale)))
    got = tllama._slot_lora_delta(
        torch.from_numpy(h), torch.from_numpy(bank["wq_a"][0]),
        torch.from_numpy(bank["wq_b"][0]), torch.from_numpy(idx),
        torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    # the zero slot adds an exact zero
    assert not got[1].any()


B, M, PS = 3, 32, 8


def _state(cfg, seed=12):
    """Random cache [L, B, M, KV, hd] and page pool with a table
    (the same numpy values on both sides)."""
    rng = np.random.default_rng(seed)
    kv = (cfg.n_layers, B, M, cfg.n_kv_heads, cfg.head_dim)
    cache = {n: (rng.normal(size=kv) * 0.5).astype(np.float32)
             for n in ("k", "v")}
    per_slot = M // PS
    pool = {n: (rng.normal(size=(cfg.n_layers, 1 + B * per_slot, PS) + kv[3:])
                * 0.5).astype(np.float32) for n in ("k", "v")}
    table = (1 + np.arange(B * per_slot, dtype=np.int32)).reshape(B, per_slot)
    return cache, pool, table


def _jx(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _pt(tree):
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in
            tree.items()}


ROWS = np.array([1, 0, 2])     # each row's bank slot
ONE = np.array([2])            # an admitted request's bank slot
TOK = np.array([5, 77, 201])
POS = np.array([10, 20, 5])
PROMPT = np.array([3, 14, 15, 92, 65, 35, 89, 79])
CHUNK = np.array([23, 84, 62, 64])
VERIFY = np.array([[5, 9, 13], [77, 1, 2], [201, 4, 8]])

# (name, one-row operand?, state, call(mod, cfg, params, state, ad) ->
# (logits or None, written cache)); JAX returns what it writes, the port
# writes in place
ENTRIES = [
    ("prefill", False, "cache", lambda m, c, p, s, ad, xp: m.prefill(
        c, p, xp(np.stack([PROMPT] * B)), s, adapters=ad)),
    ("decode_step", False, "cache", lambda m, c, p, s, ad, xp: m.decode_step(
        c, p, xp(TOK), s, xp(POS), adapters=ad)),
    ("verify_step", False, "cache", lambda m, c, p, s, ad, xp: m.verify_step(
        c, p, xp(VERIFY), s, xp(POS), adapters=ad)),
    ("prefill_into_slot", True, "cache", lambda m, c, p, s, ad, xp: (
        None, m.prefill_into_slot(c, p, xp(PROMPT), s, 1, adapters=ad))),
    ("prefill_exact_row", True, None, lambda m, c, p, s, ad, xp: (
        None, m.prefill_exact_row(c, p, xp(PROMPT), M, adapters=ad))),
    ("prefill_chunk_into_slot", True, "cache",
     lambda m, c, p, s, ad, xp: (None, m.prefill_chunk_into_slot(
         c, p, xp(CHUNK), s, 2, 6, adapters=ad))),
    ("paged_decode_step", False, "pool",
     lambda m, c, p, s, ad, xp: m.paged_decode_step(
         c, p, xp(TOK), s[0], s[1], xp(POS), adapters=ad)),
    ("paged_verify_step", False, "pool",
     lambda m, c, p, s, ad, xp: m.paged_verify_step(
         c, p, xp(VERIFY), s[0], s[1], xp(POS), adapters=ad)),
    ("paged_prefill_chunk", True, "pool",
     lambda m, c, p, s, ad, xp: (None, m.paged_prefill_chunk(
         c, p, xp(CHUNK), s[0], s[1][1], 6, adapters=ad))),
]


@pytest.mark.parametrize("entry", ENTRIES, ids=[e[0] for e in ENTRIES])
def test_decode_entry_with_adapters_matches_jax(model, entry):
    """Each decode entry the JAX package takes `adapters` on, with a
    mixed operand (rows on slots 1, 0, 2; or one admitted row on slot
    2): the logits and the cache or pool it writes against JAX's."""
    _, one_row, kind, call = entry
    jcfg, jparams, tcfg, tparams = model
    bank, scale = _bank_np(jcfg)
    jad_op, tad_op = _operands(bank, scale, ONE if one_row else ROWS)
    cache, pool, table = _state(jcfg)
    ts = _torch_state(cache, pool, table, kind)
    js = (_jx(cache) if kind == "cache" else
          (_jx(pool), jnp.asarray(table)) if kind == "pool" else None)
    jl, jc = call(jdec, jcfg, jparams, js, jad_op,
                  lambda a: jnp.asarray(a, jnp.int32))
    tl, tc = call(tdec, tcfg, tparams, ts, tad_op, _long)
    if jl is not None:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=CACHE_ATOL, err_msg=name)
    # not vacuous: the adapters move what the entry writes
    _, tc0 = call(tdec, tcfg, tparams, _torch_state(cache, pool, table, kind),
                  None, _long)
    assert not torch.equal(tc0["k"], tc["k"])


def _long(a):
    return torch.from_numpy(np.asarray(a)).long()


def _torch_state(cache, pool, table, kind):
    if kind == "cache":
        return _pt(cache)
    if kind == "pool":
        return _pt(pool), torch.from_numpy(table)
    return None


def test_adapters_none_is_the_base_forward(model):
    """adapters with every row on the zero slot computes exactly what
    adapters=None computes (an added exact zero)."""
    _, _, tcfg, tparams = model
    bank, scale = _bank_np(tcfg)
    _, op = _operands(bank, scale, np.zeros(B, np.int64))
    cache, _, _ = _state(tcfg)
    a, ca = tdec.decode_step(tcfg, tparams, torch.from_numpy(TOK),
                             _pt(cache), torch.from_numpy(POS), adapters=op)
    b, cb = tdec.decode_step(tcfg, tparams, torch.from_numpy(TOK),
                             _pt(cache), torch.from_numpy(POS))
    assert torch.equal(a, b)
    assert all(torch.equal(ca[n], cb[n]) for n in ca)


# ---------------------------------------------------------------------------
# the device cache


def _cache_sequence(mod, cfg, reg, dev_kw):
    """JAX TestDeviceCache's acquire / release sequence; returns every
    observable after each step."""
    cache = mod.DeviceAdapterCache(cfg, reg, cache_slots=2, **dev_kw)
    seen = []

    def note(tag, val=None):
        seen.append((tag, val, cache.stats(), list(cache.resident_ids()),
                     {a: cache.slot_of(a) for a in ("ad1", "ad2", "ad3",
                                                    None)},
                     cache.pinned_count()))

    note("a1", cache.acquire("ad1"))
    note("a2", cache.acquire("ad2"))
    with pytest.raises(mod.AdapterCacheFull):
        cache.acquire("ad3")
    note("full")
    cache.release("ad2")
    note("a3", cache.acquire("ad3"))
    note("a1 again", cache.acquire("ad1"))
    cache.release("ad1")
    cache.release("ad1")
    cache.release("ad3")
    note("a2 back", cache.acquire("ad2"))
    note("none", cache.acquire(None))
    cache.release(None)
    with pytest.raises(RuntimeError, match="without a matching"):
        cache.release("ad1")
    with pytest.raises(KeyError, match="unknown adapter"):
        cache.acquire("nope")
    note("end")
    return seen, cache


def test_device_cache_matches_jax(model, adapters):
    """The slot map, hits / misses / evictions / uploads, residency and
    pins equal JAX's over one acquire / release sequence, and the bank
    slots hold the registered arrays (rank-padded with zeros)."""
    jcfg, jparams, tcfg, _ = model
    jreg, treg, _, _ = adapters
    sd3 = _make_adapter(jcfg, jparams, 9, rank=2, alpha=4.0)
    jreg.register("ad3", sd3, alpha=4.0)
    treg.register("ad3", sd3, alpha=4.0)
    try:
        want, jcache = _cache_sequence(jad, jcfg, jreg, {})
        got, tcache = _cache_sequence(tad, tcfg, treg, dict(device="cpu"))
        assert got == want
        for name, arr in jcache.bank.items():
            np.testing.assert_array_equal(tcache.bank[name].numpy(),
                                          np.asarray(arr), err_msg=name)
        assert tcache.bank_bytes() == sum(
            np.asarray(a).nbytes for a in jcache.bank.values())
    finally:
        jreg.unregister("ad3")
        treg.unregister("ad3")


def test_device_cache_reupload_on_new_version(model, adapters):
    """Re-registering a resident id re-uploads it into the same slot on
    the next acquire (a miss, no eviction), as JAX's does."""
    jcfg, _, tcfg, _ = model
    _, _, sds, _ = adapters
    out = []
    for mod, cfg, kw in ((jad, jcfg, {}), (tad, tcfg, dict(device="cpu"))):
        reg = mod.AdapterRegistry(cfg, max_rank=8)
        reg.register("a", sds["ad1"], alpha=8.0)
        cache = mod.DeviceAdapterCache(cfg, reg, cache_slots=2, **kw)
        s1 = cache.acquire("a")
        cache.release("a")
        reg.register("a", sds["ad2"], alpha=4.0)
        s2 = cache.acquire("a")
        out.append((s1, s2, cache.stats(),
                    np.asarray(cache.bank["scale"]).tolist()))
    assert out[0] == out[1]
    assert out[1][0] == out[1][1]


# ---------------------------------------------------------------------------
# the engine


PROMPTS = _prompts((5, 9, 7, 12), seed=3)
AIDS = ["ad1", None, "ad2", "ad1"]
KEYS = [17 + i for i in range(len(PROMPTS))]


def _port_engine(model, reg, **kw):
    _, _, tcfg, tparams = model
    return teng.ContinuousBatcher(
        tcfg, tparams, device="cpu",
        **{**ENGINE, "adapter_registry": reg, "adapter_cache_slots": 2,
           **kw})


def _run(eng, prompts, aids, keys=None):
    keys = keys or [None] * len(prompts)
    for p, a, k in zip(prompts, aids, keys):
        eng.submit(p, adapter_id=a, prng_key=k)
    return _tokens(eng.generate_all([]))


def _port_oracle(model, merged, prompt, key=None, **kw):
    """The port's merged-weight oracle: one request alone on an
    adapterless engine over lora.merge's tree."""
    _, _, tcfg, _ = model
    eng = teng.ContinuousBatcher(tcfg, merged, device="cpu",
                                 **{**ENGINE, **kw})
    return _run(eng, [prompt], [None], [key])[0]


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("async_depth", [0, 1], ids=["sync", "async"])
def test_mixed_batch_greedy_matches_jax_and_merged_oracle(
        model, adapters, layout, async_depth):
    """JAX's test_mixed_batch_matches_merged_oracle setup, greedy: the
    port's streams equal the JAX adapter engine's and the port's
    merged-weight oracle's, and the adapter counters equal JAX's."""
    jcfg, jparams, _, _ = model
    jreg, treg, _, merged = adapters
    kw = dict(kv_layout=layout, async_depth=async_depth)
    jeng = JaxBatcher(jcfg, jparams, adapter_registry=jreg,
                      adapter_cache_slots=2, **ENGINE, **kw)
    want = _run(jeng, PROMPTS, AIDS)
    port = _port_engine(model, treg, **kw)
    got = _run(port, PROMPTS, AIDS)
    assert got == want
    assert port.adapter_stats() == jeng.adapter_stats()
    assert port.adapter_stats()["uploads"] >= 2
    for i, (p, aid) in enumerate(zip(PROMPTS, AIDS)):
        assert got[i] == _port_oracle(model, merged[aid], p, **kw), (i, aid)
    if layout == "paged":
        assert port.paged_stats() == {
            k: v for k, v in jeng.paged_stats().items()
            if k in port.paged_stats()}


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("async_depth", [0, 1], ids=["sync", "async"])
def test_mixed_batch_sampled_matches_merged_oracle(
        model, adapters, layout, async_depth):
    """Sampled (temperature 0.8, top-k 5): each request's stream equals
    the port's merged-weight oracle's under the same per-request
    prng_key, whatever else shares its batch."""
    _, treg, _, merged = adapters
    kw = dict(kv_layout=layout, async_depth=async_depth, temperature=0.8,
              top_k=5)
    got = _run(_port_engine(model, treg, **kw), PROMPTS, AIDS, KEYS)
    for i, (p, aid, k) in enumerate(zip(PROMPTS, AIDS, KEYS)):
        assert got[i] == _port_oracle(model, merged[aid], p, key=k, **kw), (
            i, aid)
    # the key seeds the stream: another key, another stream
    other = _run(_port_engine(model, treg, **kw), PROMPTS, AIDS,
                 [k + 1000 for k in KEYS])
    assert other != got


def test_prng_key_accepts_jax_key_words(model, adapters):
    """A JAX PRNGKey's two uint32 words seed the request as one int,
    high word first; the stream repeats under the same words."""
    _, treg, _, _ = adapters
    kw = dict(temperature=0.8, top_k=5)
    key = np.asarray(jax.random.PRNGKey(17))
    a = _run(_port_engine(model, treg, **kw), PROMPTS[:1], [None], [key])
    b = _run(_port_engine(model, treg, **kw), PROMPTS[:1], [None],
             [(int(key[0]) << 32) | int(key[1])])
    assert a == b
    assert teng._seed_of(np.array([1, 2], np.uint32)) == (1 << 32) | 2
    with pytest.raises(ValueError, match="prng_key"):
        _port_engine(model, treg).submit([1, 2, 3], prng_key=-1)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_base_traffic_matches_adapterless_engine(model, adapters, layout):
    """adapter_id=None rows ride the zero slot 0: byte-identical to an
    engine with no registry at all (JAX :275)."""
    _, treg, _, _ = adapters
    prompts = _prompts((5, 9, 7), seed=5)
    with_reg = _run(_port_engine(model, treg, kv_layout=layout), prompts,
                    [None] * 3)
    without = _run(_port_engine(model, None, kv_layout=layout), prompts,
                   [None] * 3)
    assert with_reg == without


def _knob_prompts():
    """Shared 8-token prefix + tails (prefix hits for base requests),
    and pattern repeats (drafts for speculation)."""
    rng = np.random.default_rng(21)
    shared = rng.integers(1, 250, size=8).tolist()
    pat = rng.integers(1, 250, size=3).tolist()
    return [shared + rng.integers(1, 250, size=t).tolist() for t in
            (3, 5, 4, 6)] + [pat * 4, shared + pat * 2]


KNOB_AIDS = [None, "ad1", None, "ad2", "ad1", None]
KNOBS = [("prefill_chunk", dict(prefill_chunk=4)),
         ("spec", dict(spec_draft_len=2)),
         ("prefix_cache", dict(prefix_cache_rows=2, prefix_block=4))]


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("knob", KNOBS, ids=[k[0] for k in KNOBS])
def test_adapters_under_serving_knobs_match_jax(model, adapters, layout,
                                                knob):
    """Adapters under prefill_chunk=4, spec_draft_len=2 and the prefix
    cache: greedy streams, prefix-cache stats (adapted requests neither
    hit nor publish), spec and prefill counters and the adapter
    counters equal the JAX engine's."""
    jcfg, jparams, _, _ = model
    jreg, treg, _, _ = adapters
    kw = dict(kv_layout=layout, chunk=4, **knob[1])
    prompts = _knob_prompts()
    jeng = JaxBatcher(jcfg, jparams, adapter_registry=jreg,
                      adapter_cache_slots=2, **ENGINE, **kw)
    want = _run(jeng, prompts, KNOB_AIDS)
    port = _port_engine(model, treg, **kw)
    got = _run(port, prompts, KNOB_AIDS)
    assert got == want
    assert port.adapter_stats() == jeng.adapter_stats()
    if port.prefix_cache is not None:
        assert port.prefix_cache.stats() == jeng.prefix_cache.stats()
        assert port.prefix_cache.hits > 0
    if port.spec is not None:
        assert port.spec.stats() == jeng.spec.stats()
        assert port.verify_steps > 0
    jp, tp = jeng.prefill_stats(), port.prefill_stats()
    jp.pop("admission_stall_ms")
    tp.pop("admission_stall_ms")
    assert tp == jp
    if layout == "paged":
        js, ts = jeng.paged_stats(), port.paged_stats()
        assert {k: js[k] for k in ts} == ts
        port.allocator.check()
        assert port.allocator._refs == jeng.allocator._refs


def test_adapters_with_preemption_replay_match_jax(model, adapters):
    """A pool too small for every request: preempted adapted requests
    keep their pin and replay on the same bank slot; streams and the
    paged counters equal JAX's."""
    jcfg, jparams, _, _ = model
    jreg, treg, _, _ = adapters
    kw = dict(kv_layout="paged", page_size=8, n_pages=9, chunk=2,
              max_new_tokens=12)
    prompts = _prompts((28, 30, 25, 33), seed=8)
    aids = ["ad1", "ad2", None, "ad1"]
    jeng = JaxBatcher(jcfg, jparams, adapter_registry=jreg,
                      adapter_cache_slots=2, **{**ENGINE, **kw})
    want = _run(jeng, prompts, aids)
    port = _port_engine(model, treg, **kw)
    got = _run(port, prompts, aids)
    assert got == want
    assert port.paged_stats()["swap_preemptions"] > 0
    assert port.paged_stats()["swap_preemptions"] == (
        jeng.paged_stats()["swap_preemptions"])
    assert port.adapter_stats() == jeng.adapter_stats()


def test_engine_backpressure_then_recovery(model, adapters):
    """With one bank slot the second adapter is refused while the first
    decodes (AdapterCacheFull, no ledger entry left), and admits after
    it retires (JAX :357)."""
    _, treg, _, _ = adapters
    eng = _port_engine(model, treg, max_new_tokens=4, adapter_cache_slots=1)
    eng.submit(_prompts((5,))[0], adapter_id="ad1")
    with pytest.raises(tad.AdapterCacheFull):
        eng.submit(_prompts((6,))[0], adapter_id="ad2")
    assert eng.queue_len() == 1 and len(eng._requests) == 1
    eng.generate_all([])
    idx = eng.submit(_prompts((6,))[0], adapter_id="ad2")
    assert len(eng.generate_all([])[0]) == 4
    assert idx == 1
    assert eng.adapter_stats()["evictions"] == 1.0


def test_unknown_adapter_raises_before_ledger(model, adapters):
    _, treg, _, _ = adapters
    eng = _port_engine(model, treg)
    with pytest.raises(KeyError, match="unknown adapter"):
        eng.submit([1, 2, 3], adapter_id="nope")
    assert eng.queue_len() == 0 and not eng._requests
    assert eng._next_idx == 0


def test_adapter_id_without_registry_rejected(model):
    eng = _port_engine(model, None)
    with pytest.raises(ValueError, match="adapter_registry"):
        eng.submit([1, 2, 3], adapter_id="ad1")
    assert eng.queue_len() == 0


def test_retire_and_cancel_release_pins(model, adapters):
    """retire and cancel unpin; a preemption does not (its replay must
    land on the same slot)."""
    _, treg, _, _ = adapters
    eng = _port_engine(model, treg, max_new_tokens=4)
    i0 = eng.submit(_prompts((5,))[0], adapter_id="ad1")
    i1 = eng.submit(_prompts((6,))[0], adapter_id="ad2")
    eng.step()
    cache = eng._adapter_cache
    assert cache.pinned_count() == 2
    slot = next(s for s in range(eng.n_slots) if eng.slot_req[s] is not None
                and eng.slot_req[s].idx == i1)
    eng._preempt_slot(slot)
    assert cache.pinned_count() == 2
    eng.cancel(i1)
    assert cache.pinned_count() == 1
    while eng.has_work():
        eng.step()
    eng.retire(i0)
    assert cache.pinned_count() == 0
    assert sorted(cache.resident_ids()) == ["ad1", "ad2"]


def test_reset_clears_pins_and_mirrors(model, adapters):
    """reset drops the ledger's pins and the index mirror, rebuilds the
    bank from the registry (residents keep their slots and bytes), and
    the engine serves cleanly after (JAX :515)."""
    _, treg, _, _ = adapters
    for layout in ("dense", "paged"):
        eng = _port_engine(model, treg, max_new_tokens=4, kv_layout=layout,
                           prefix_cache_rows=2, prefix_block=4,
                           spec_draft_len=2)
        eng.submit(_prompts((5,))[0], adapter_id="ad1")
        eng.submit(_prompts((9,), seed=1)[0])
        eng.step()
        cache = eng._adapter_cache
        assert cache.pinned_count() == 1
        bank_before = {k: v.clone() for k, v in cache.bank.items()}
        next_idx = eng._next_idx
        eng.reset()
        assert cache.pinned_count() == 0
        assert not eng.adapt.any() and eng.done.all()
        assert not eng.has_work() and not eng._requests
        assert cache.resident_ids() == ["ad1"]
        for k, v in cache.bank.items():
            assert torch.equal(v, bank_before[k]), k
        if layout == "paged":
            eng.allocator.check()
            assert eng.allocator.free_pages == eng.allocator.capacity
        assert eng.prefix_cache.stats()["hits"] == 0
        # indices stay monotonic, and the engine serves after the rebuild
        idx = eng.submit(_prompts((6,))[0], adapter_id="ad2")
        assert idx == next_idx
        out = eng.generate_all([])
        assert len(out[0]) == 4
        fresh = _run(_port_engine(model, treg, max_new_tokens=4,
                                  kv_layout=layout), [_prompts((6,))[0]],
                     ["ad2"])
        assert _tokens(out) == fresh


def test_stats_and_residency(model, adapters):
    """Telemetry (JAX :538): counters equal JAX's after the same run."""
    jcfg, jparams, _, _ = model
    jreg, treg, _, _ = adapters
    kw = dict(max_new_tokens=2)
    jeng = JaxBatcher(jcfg, jparams, adapter_registry=jreg,
                      adapter_cache_slots=2, **{**ENGINE, **kw})
    port = _port_engine(model, treg, **kw)
    for eng in (jeng, port):
        eng.submit(_prompts((5,))[0], adapter_id="ad1")
        eng.submit(_prompts((6,))[0], adapter_id="ad1")
        assert eng.adapter_active() == {"ad1": 2}
        eng.generate_all([])
    s = port.adapter_stats()
    assert s == jeng.adapter_stats()
    assert s["registered"] == 2.0
    assert s["hits"] >= 1.0 and s["misses"] == 1.0
    assert port.adapter_residency() == jeng.adapter_residency() == ["ad1"]
    assert port.adapter_active() == {}


def test_adapterless_engine_reports_empty(model):
    """JAX :554."""
    eng = _port_engine(model, None)
    assert eng.adapter_stats() == {}
    assert eng.adapter_residency() == []
    assert eng.adapter_active() == {}
    assert eng._adapter_args() is None
