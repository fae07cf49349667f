"""The port's speculative decoding in the serving engine
(`spec_draft_len` > 0) against the JAX engine on the same seed-made
prompts and params.

Greedy streams must be EXACTLY the JAX engine's, and so must the
speculation counters (`spec.stats()`: proposals, acceptances, rounds,
emitted tokens and the controller's state, which follows the accepted
counts), dense and paged, with eos, int8 weights, an int8 KV cache,
prefix-cache warm admissions, page-pressure preemption with replay,
interleaved prefill (speculation is bypassed while a slot is
mid-prefill) and prompts that end a few cells before max_len. The
integer state must match too: `paged_stats`, the allocator's
refcounts, the prefix-cache and prefill counters, each request's page
need and the auto page size, which both size for the verify window
(max_len + K cells a slot). spec_draft_len=0 is the plain engine,
allocation and all. The knob validation raises JAX's errors. Sampled
speculation draws from another RNG than JAX's, so it is held to the
port itself (budgets, determinism); tests/test_torch_speculative.py
holds its acceptance rule to the target distribution."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from dlrover_tpu.serving.engine import _Request as JaxRequest
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.serving import engine as teng

ENGINE = dict(n_slots=2, max_len=64, max_new_tokens=8, chunk=4, pad_id=-1)


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


def _mixed_prompts(seed=0, n=6):
    """Random prompts plus pattern-repeat prompts, so the drafter sees
    both regimes (misses on noise, hits on repetition)."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(1, 250, size=int(m)).tolist()
           for m in rng.integers(3, 20, size=n)]
    pat = rng.integers(1, 250, size=4).tolist()
    return out + [pat * 5, (pat * 3)[:-1]]


def _shared_prompts(seed, lengths, shared):
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 250, size=shared).tolist()
    pat = rng.integers(1, 250, size=3).tolist()
    return [base + (pat * 9)[:n] for n in lengths]


def _drain(engine, prompts):
    return [list(map(int, r)) for r in engine.generate_all(prompts)]


def _port(model, prompts, **kw):
    _, _, tcfg, tparams = model
    eng = teng.ContinuousBatcher(tcfg, tparams, device="cpu",
                                 **{**ENGINE, **kw})
    return eng, _drain(eng, prompts)


def _jax(model, prompts, **kw):
    jcfg, jparams, _, _ = model
    eng = JaxBatcher(jcfg, jparams, **{**ENGINE, **kw})
    return eng, _drain(eng, prompts)


def _assert_same_state(jax_eng, port):
    assert port.spec.stats() == jax_eng.spec.stats()
    for s in range(port.n_slots):
        assert (port.spec.controller.current_k(s)
                == jax_eng.spec.controller.current_k(s))
    pf_j, pf_t = jax_eng.prefill_stats(), port.prefill_stats()
    pf_j.pop("admission_stall_ms")
    pf_t.pop("admission_stall_ms")
    assert {k: pf_j[k] for k in pf_t} == pf_t
    if port._paged:
        js, ts = jax_eng.paged_stats(), port.paged_stats()
        assert {k: js[k] for k in ts} == ts
        port.allocator.check()
        assert port.allocator._refs == jax_eng.allocator._refs
    if port.prefix_cache is not None:
        assert port.prefix_cache.stats() == jax_eng.prefix_cache.stats()


CASES = [
    ("plain", dict(), dict(seed=0)),
    ("eos", dict(eos_id=7), dict(seed=1)),
    ("int8_weights", dict(weight_quant="int8"), dict(seed=2)),
    ("int8_kv", dict(kv_quant=True), dict(seed=3)),
    ("oversubscribed", dict(max_new_tokens=12), dict(seed=5, n=10)),
    ("prefill_chunk", dict(prefill_chunk=4), dict(seed=6)),
]


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("kw,pkw", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_greedy_streams_and_stats_equal_jax(model, kw, pkw, layout):
    prompts = _mixed_prompts(**pkw)
    kw = dict(kw, spec_draft_len=4, kv_layout=layout)
    jax_eng, want = _jax(model, prompts, **kw)
    port, got = _port(model, prompts, **kw)
    assert got == want
    assert port.spec.proposed > 0, "the drafter never fired: vacuous"
    assert port.verify_steps > 0
    _assert_same_state(jax_eng, port)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefix_cache_warm_admissions_equal_jax(model, layout):
    prompts = _shared_prompts(4, (1, 3, 20, 9, 27), shared=32)
    kw = dict(spec_draft_len=4, kv_layout=layout, prefix_cache_rows=4)
    jax_eng, want = _jax(model, prompts, **kw)
    port, got = _port(model, prompts, **kw)
    assert got == want
    assert port.prefix_cache.stats()["hits"] > 0, "no reuse: vacuous"
    assert port.spec.proposed > 0
    _assert_same_state(jax_eng, port)


@pytest.mark.parametrize("prefix", [0, 4], ids=["noprefix", "prefix"])
def test_pressure_preemption_replay_equals_jax(model, prefix):
    """max_len 60 with K=4: a 64-cell bank in pages of 16, and a pool of
    6 pages that cannot hold three requests' runs at once."""
    prompts = _shared_prompts(7, (4, 18, 6, 11, 3, 25, 8),
                              shared=16 if prefix else 0)
    kw = dict(spec_draft_len=4, kv_layout="paged", max_len=60,
              max_new_tokens=24, n_slots=3, chunk=3, n_pages=6,
              prefix_cache_rows=prefix)
    jax_eng, want = _jax(model, prompts, **kw)
    port, got = _port(model, prompts, **kw)
    assert got == want
    st = port.paged_stats()
    assert port.page_size == jax_eng.page_size == 16
    assert st["swap_preemptions"] > 0, "pool never pressured"
    assert st["swap_resumes"] == st["swap_preemptions"]
    _assert_same_state(jax_eng, port)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_near_max_len_boundary_equals_jax(model, k, layout):
    """Prompts leaving a handful of cells before max_len: the verify
    window reaches past the last valid cell into the over-allocation,
    and no slot emits past its limit."""
    rng = np.random.default_rng(7 + k)
    max_len = 32
    prompts = [rng.integers(1, 250, size=n).tolist()
               for n in (max_len - 2, max_len - 3, max_len - 6, 5)]
    pat = rng.integers(1, 250, size=2).tolist()
    prompts.append((pat * 20)[: max_len - 4])
    kw = dict(max_len=max_len, max_new_tokens=16, kv_layout=layout)
    jax_eng, want = _jax(model, prompts, spec_draft_len=k, **kw)
    port, got = _port(model, prompts, spec_draft_len=k, **kw)
    assert got == want
    _assert_same_state(jax_eng, port)
    _, plain = _port(model, prompts, **kw)
    assert got == plain
    for p, o in zip(prompts, got):
        assert len(p) + len(o) <= max_len


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_zero_draft_len_is_the_plain_engine(model, layout):
    prompts = _mixed_prompts(seed=8)
    off, got = _port(model, prompts, spec_draft_len=0, kv_layout=layout)
    base, want = _port(model, prompts, kv_layout=layout)
    assert off.spec is None and off.verify_steps == 0
    assert got == want
    bank = "page_pool" if layout == "paged" else "cache"
    for name, arr in getattr(base, bank).items():
        assert getattr(off, bank)[name].shape == arr.shape, name
    if layout == "paged":
        assert off.page_size == base.page_size
        assert off.paged_stats() == base.paged_stats()


@pytest.mark.parametrize(
    "kw",
    [dict(spec_draft_len=-1), dict(spec_draft_len=64),
     dict(spec_draft_len=70), dict(async_depth=2), dict(async_depth=-1),
     dict(spec_draft_len=2, spec_ngram_min=3, spec_ngram_max=2),
     dict(spec_draft_len=2, spec_ngram_min=0),
     dict(spec_draft_len=2, spec_accept_threshold=0.0),
     dict(spec_draft_len=2, spec_probe_interval=0),
     dict(spec_draft_len=4, max_len=64, kv_layout="paged", page_size=16)],
    ids=["negative", "at_max_len", "past_max_len", "depth_2",
         "depth_negative", "ngram_range", "ngram_min_0", "threshold",
         "probe", "page_vs_bank"],
)
def test_validation_raises_jax_errors(model, kw):
    jcfg, jparams, tcfg, tparams = model
    with pytest.raises(ValueError) as want:
        JaxBatcher(jcfg, jparams, **{**ENGINE, **kw})
    with pytest.raises(ValueError) as got:
        teng.ContinuousBatcher(tcfg, tparams, device="cpu",
                               **{**ENGINE, **kw})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("max_len,k,prefix", [
    (64, 4, 0), (60, 4, 0), (62, 2, 0), (2044, 4, 0), (2048, 4, 0),
    (60, 4, 4), (120, 8, 4), (40, 3, 0),
])
def test_page_sizing_equals_jax(model, max_len, k, prefix):
    """The auto page size (a power of two <= 16 dividing max_len + K),
    pages a slot, the pool size and each request's page need, which
    counts the K cells a verify writes past its limit."""
    jcfg, jparams, tcfg, tparams = model
    kw = dict(ENGINE, max_len=max_len, spec_draft_len=k, kv_layout="paged",
              prefix_cache_rows=prefix)
    j = JaxBatcher(jcfg, jparams, **kw)
    t = teng.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    assert (t.page_size, t._pages_per_slot, t.n_pages) == (
        j.page_size, j._pages_per_slot, j.n_pages)
    assert t.page_pool["k"].shape == tuple(j.page_pool["k"].shape)
    ts, js = t.allocator.stats(), j.allocator.stats()
    assert ts == {name: js[name] for name in ts}
    rng = np.random.default_rng(max_len + k)
    for _ in range(10):
        p = int(rng.integers(1, max_len - 1))
        max_new = int(rng.integers(1, max_len))
        prompt = np.ones(p, np.int64)
        want = j._request_pages(
            JaxRequest(idx=0, prompt=prompt, max_new=max_new))
        got = t._request_pages(
            teng._Request(idx=0, prompt=prompt, max_new=max_new))
        assert got == want, (p, max_new)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_sampled_spec_runs_within_budget_and_repeats(model, layout):
    """Sampled speculation: every request ends within its budget with
    valid tokens, drafts were verified, and the same seed gives the
    same streams and stats."""
    prompts = _mixed_prompts(seed=9)
    kw = dict(spec_draft_len=4, kv_layout=layout, temperature=0.9,
              top_k=40, top_p=0.95, seed=3)
    a, out_a = _port(model, prompts, **kw)
    b, out_b = _port(model, prompts, **kw)
    assert out_a == out_b and a.spec.stats() == b.spec.stats()
    assert a.spec.proposed > 0 and a.verify_steps > 0
    for o in out_a:
        assert 0 < len(o) <= ENGINE["max_new_tokens"]
        assert all(0 <= t < model[2].vocab_size for t in o)
