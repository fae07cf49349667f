"""The port's host-DRAM KV tier (dlrover_tpu_torch/serving/kv_tier.py and
the engine's tier paths) against the JAX package's, on the tiny f32
Llama.

- `HostKVTier` semantics: one sequence of puts, matches, pins, swaps,
  clears run through both tiers gives the same answers, stats and LRU
  order; the advertised prefix digests are `prefix_digest_chain`'s.
- Churn parity (JAX test_serving_kv_tier.py's churn): a 1-row radix
  cache evicts (demotes) on every publish and the repeat round promotes.
  Greedy streams equal the JAX engine's and the port's own tier-less
  run; sampled streams (torch's draws) equal the port's tier-less run.
  `kv_tier_stats()` and `pages_promoted` equal the JAX engine's in every
  case.
- Swap-to-host under pool pressure (n_slots 3, page 8, 14 pages):
  streams, `swap_outs`, `swap_ins`, `_swap_resumes` equal JAX's.
- kv_tier_promote="never", swap_to_host=False, the tier-capacity
  pressure accounting, the chaos crash mid-demotion, leak freedom after
  cancel and reset, and the tier off by default (no tier object, no
  transfer called).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.serving import affinity as jaff
from dlrover_tpu.serving.chaos import FaultInjector as JaxInjector
from dlrover_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from dlrover_tpu.serving.kv_tier import HostKVTier as JaxTier
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.serving import engine as teng
from dlrover_tpu_torch.serving import kv_tier as tkv
from dlrover_tpu_torch.serving.affinity import prefix_digest_chain
from dlrover_tpu_torch.serving.chaos import FaultInjector


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


ENGINE = dict(n_slots=1, max_len=64, max_new_tokens=6, chunk=4)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=int(n)).tolist() for n in lengths]


def _jax(model, **kw):
    return JaxBatcher(model[0], model[1], **{**ENGINE, **kw})


def _port(model, **kw):
    return teng.ContinuousBatcher(model[2], model[3], device="cpu",
                                  **{**ENGINE, **kw})


def _churn(cb, rounds):
    """Sequential generate_all rounds: with prefix_cache_rows=1 each
    distinct published prefix evicts the previous one (a demotion), and
    the repeat round asks for what was demoted (a promotion)."""
    return [[int(t) for t in cb.generate_all([p])[0]]
            for prompts in rounds for p in prompts]


# ---------------------------------------------------------------------------
# HostKVTier semantics, against the JAX tier


def _staged(nbytes, torch_side):
    if torch_side:
        return {"k": torch.zeros(nbytes, dtype=torch.int8)}
    return {"k": np.zeros(nbytes, np.int8)}


def _tier_script(tier_cls, torch_side):
    """One sequence of tier operations; returns every observable."""
    seen = []
    st = lambda n=64: _staged(n, torch_side)  # noqa: E731
    tier = tier_cls(150, block=2)
    a, b = [1, 2, 3, 4], [5, 6, 7, 8]
    seen.append(tier.put_prefix(a, st(), 4))
    seen.append(tier.put_prefix(b, st(), 4))
    ent = tier.match_prefix(a + [9])
    seen.append((ent.depth, ent.final, ent.digest))
    # the match touched A: a third entry evicts B
    seen.append(tier.put_prefix([9, 9, 9, 9], st(), 4))
    seen.append(tier.match_prefix(b) is None)
    seen.append(tier.match_prefix(a) is not None)
    # the tier wins only strictly deeper than the radix match
    seen.append(tier.match_prefix(a, min_depth=4) is None)
    seen.append(tier.match_prefix(a, min_depth=2) is not None)
    # an oversize put is rejected without evicting
    seen.append(tier.put_prefix([3, 4], st(151), 2))
    # a pinned entry is never evicted
    pinned = tier.match_prefix(a)
    tier.acquire(pinned)
    seen.append(tier.put_prefix([7, 7], st(), 2))
    tier.release(pinned)
    seen.append(tier.put_prefix([7, 7], st(), 2))
    seen.append(tier.stats())
    seen.append(list(tier._entries))
    # swap entries: salted keys, consumed once, replaced in place
    big = tier_cls(1 << 20, block=2)
    toks = [1, 2, 3]
    big.put_swap(toks, st(), 1, 8, salt="")
    big.put_swap(toks, st(), 1, 8, salt="lora-a")
    big.put_swap([1, 2], st(64), 1, 8)
    big.put_swap([1, 2], st(96), 1, 8)
    sw = big.peek_swap(toks)
    seen.append((sw.n_pages, sw.page_size, sw.digest))
    seen.append(big.peek_swap(toks) is not None)
    big.consume(sw)
    seen.append(big.peek_swap(toks) is None)
    seen.append(big.peek_swap(toks, salt="lora-a").digest)
    big.put_prefix([4, 5, 6, 7], st(), 4)
    seen.append(big.prefix_digests())
    seen.append(big.stats())
    big.clear()
    seen.append((big.entry_count(), big.bytes_used, big.stats()["demotions"]))
    return seen


def test_host_tier_semantics_equal_jax():
    assert _tier_script(tkv.HostKVTier, True) == _tier_script(JaxTier, False)


def test_host_tier_validation():
    for bad in (dict(capacity_bytes=0), dict(capacity_bytes=-1),
                dict(capacity_bytes=1024, block=0)):
        with pytest.raises(ValueError):
            tkv.HostKVTier(**bad)


def test_prefix_digests_are_the_affinity_chain():
    tier = tkv.HostKVTier(1 << 20, block=2)
    toks = [4, 5, 6, 7]
    tier.put_prefix(toks, _staged(8, True), 4)
    tier.put_swap([9, 9], _staged(8, True), 1, 8)   # never advertised
    assert tier.prefix_digests() == [prefix_digest_chain(toks, 2)[-1]]
    assert tier.prefix_digests() == [jaff.prefix_digest_chain(toks, 2)[-1]]
    assert tkv.swap_digest(toks, "a") != tkv.swap_digest(toks)


def test_published_blocks_digests_equal_jax(model):
    """The radix cache's published prefixes hash to the JAX cache's
    digests (`cache_digests`) after the same admissions."""
    from dlrover_tpu_torch.serving.affinity import cache_digests

    prompts = _prompts((20, 37, 18), seed=5)
    kw = dict(n_slots=2, prefix_cache_rows=3, prefix_block=8)
    j, t = _jax(model, **kw), _port(model, **kw)
    j.generate_all(prompts)
    t.generate_all(prompts)
    assert cache_digests(t.prefix_cache) == jaff.cache_digests(j.prefix_cache)
    assert len(cache_digests(t.prefix_cache)) == 3


# ---------------------------------------------------------------------------
# demote -> promote parity


TIER_CONFIGS = [
    ("greedy", {}),
    ("sampled", dict(temperature=0.8, top_k=20, seed=3)),
    ("spec", dict(spec_draft_len=4)),
    ("async", dict(async_depth=1)),
]


@pytest.mark.parametrize("kw", [c[1] for c in TIER_CONFIGS],
                         ids=[c[0] for c in TIER_CONFIGS])
def test_churn_parity_paged(model, kw):
    prompts = _prompts((20, 21, 22, 23), seed=11)
    rounds = [prompts, prompts]
    base = dict(kv_layout="paged", prefix_cache_rows=1, **kw)
    oracle = _churn(_port(model, **base), rounds)
    jeng = _jax(model, kv_tier_bytes=32 << 20, **base)
    want = _churn(jeng, rounds)
    cb = _port(model, kv_tier_bytes=32 << 20, **base)
    got = _churn(cb, rounds)
    assert got == oracle
    if "temperature" not in kw:
        assert got == want
    st = cb.kv_tier_stats()
    assert st == jeng.kv_tier_stats()
    assert st["demotions"] >= 3 and st["promotions"] >= 1
    assert st["promote_hits"] >= 1
    assert cb.paged_stats()["pages_promoted"] > 0
    assert (cb.paged_stats()["pages_promoted"]
            == jeng.paged_stats()["pages_promoted"])
    assert cb.allocator._refs == jeng.allocator._refs
    cb.allocator.check()
    # only the live published row holds pages; a reset hands all back
    cb.reset()
    assert cb.allocator.used_pages == 0


def test_churn_parity_dense(model):
    """The tier backs the DENSE engine's prefix pool too."""
    prompts = _prompts((20, 22, 24), seed=13)
    rounds = [prompts, prompts]
    kw = dict(prefix_cache_rows=1)
    jeng = _jax(model, kv_tier_bytes=32 << 20, **kw)
    want = _churn(jeng, rounds)
    cb = _port(model, kv_tier_bytes=32 << 20, **kw)
    assert _churn(cb, rounds) == want == _churn(_port(model, **kw), rounds)
    st = cb.kv_tier_stats()
    assert st == jeng.kv_tier_stats()
    assert st["demotions"] >= 2 and st["promotions"] >= 1


def test_churn_parity_paged_int8(model):
    """An int8 page pool: promotions land through paged_install_row's
    quantize-on-install, so the streams equal a cold re-prefill's."""
    prompts = _prompts((20, 21, 22), seed=17)
    rounds = [prompts, prompts]
    kw = dict(kv_layout="paged", prefix_cache_rows=1, kv_quant=True)
    jeng = _jax(model, kv_tier_bytes=32 << 20, **kw)
    want = _churn(jeng, rounds)
    cb = _port(model, kv_tier_bytes=32 << 20, **kw)
    assert _churn(cb, rounds) == want == _churn(_port(model, **kw), rounds)
    assert cb.kv_tier_stats() == jeng.kv_tier_stats()
    assert cb.kv_tier_stats()["promotions"] >= 1


def test_promoted_pages_equal_the_published_bytes(model):
    """A promoted prefix's pages hold exactly the bytes the original
    publish installed (int8 pool: the same quantize-on-install)."""
    prompts = _prompts((20, 21), seed=19)
    cb = _port(model, kv_layout="paged", prefix_cache_rows=1,
               kv_quant=True, kv_tier_bytes=32 << 20, max_new_tokens=2)
    cb.generate_all([prompts[0]])
    row_a = next(iter(cb._row_pages))
    before = {n: a[:, cb._row_pages[row_a]].clone()
              for n, a in cb.page_pool.items()}
    cb.generate_all([prompts[1]])      # evicts (demotes) prompt 0's row
    assert cb.kv_tier_stats()["demotions"] == 1
    cb.generate_all([prompts[0]])      # promotes it back
    assert cb.kv_tier_stats()["promotions"] == 1
    row = cb.prefix_cache.match(prompts[0])[1]
    after = {n: a[:, cb._row_pages[row]] for n, a in cb.page_pool.items()}
    for name in before:
        assert torch.equal(before[name], after[name]), name


def test_promote_never_gate(model):
    """kv_tier_promote="never" demotes but never uploads: the streams
    still match (a cold prefill is always right), no promotion."""
    prompts = _prompts((20, 21, 22), seed=15)
    rounds = [prompts, prompts]
    kw = dict(kv_layout="paged", prefix_cache_rows=1)
    oracle = _churn(_port(model, **kw), rounds)
    cb = _port(model, kv_tier_bytes=32 << 20, kv_tier_promote="never", **kw)
    jeng = _jax(model, kv_tier_bytes=32 << 20, kv_tier_promote="never", **kw)
    assert _churn(cb, rounds) == oracle == _churn(jeng, rounds)
    st = cb.kv_tier_stats()
    assert st["demotions"] > 0 and st["promotions"] == 0
    assert st == jeng.kv_tier_stats()


# ---------------------------------------------------------------------------
# swap-to-host preemption


def _pressure_prompts(n):
    rng = np.random.default_rng(7)
    return [rng.integers(1, 250, size=int(k)).tolist()
            for k in rng.integers(12, 30, size=n)]


PRESSURE = dict(n_slots=3, max_new_tokens=12, kv_layout="paged",
                page_size=8, n_pages=14)


@pytest.mark.parametrize("kw", [{}, dict(temperature=0.8, top_k=20, seed=3),
                                dict(async_depth=1), dict(kv_quant=True)],
                         ids=["greedy", "sampled", "async", "int8"])
def test_pressure_swap_parity(model, kw):
    """A pool too small for the working set preempts; with the tier on,
    victims swap to host and resume from the stored pages instead of
    replaying, with the same streams and the JAX engine's counts."""
    prompts = _pressure_prompts(8)

    def run(make, **extra):
        cb = make(model, **PRESSURE, **kw, **extra)
        return cb, [[int(t) for t in o] for o in cb.generate_all(prompts)]

    cb0, oracle = run(_port)
    cb1, tiered = run(_port, kv_tier_bytes=64 << 20)
    jeng, want = run(_jax, kv_tier_bytes=64 << 20)
    if not kw.get("kv_quant"):
        # an int8 bank's swapped pages hold the cells decode quantized;
        # a replay re-quantizes exact prefill values instead
        assert tiered == oracle
    if "temperature" not in kw:
        assert tiered == want
    assert cb0._swap_preemptions > 0, "scenario never preempted"
    st = cb1.kv_tier_stats()
    assert st["swap_outs"] > 0 and st["swap_ins"] > 0
    assert st == jeng.kv_tier_stats()
    assert cb1._swap_resumes == cb1._swap_preemptions
    assert (cb1._swap_resumes, cb1._swap_preemptions) == (
        jeng._swap_resumes, jeng._swap_preemptions)
    assert cb1.paged_stats()["pages_promoted"] == (
        jeng.paged_stats()["pages_promoted"])
    cb1.allocator.check()
    cb1.reset()
    assert cb1.allocator.used_pages == 0


def test_swapped_pages_round_trip_byte_exact(model):
    """The pages a swap-in installs hold exactly the bytes its victim's
    run held when it was preempted."""
    cb = _port(model, kv_tier_bytes=64 << 20, n_slots=3, max_new_tokens=20,
               chunk=2, kv_layout="paged", page_size=8)

    def cells(slot, n):
        """The slot's first n logical cells, read through its run."""
        run = cb._slot_pages[slot]
        return {k: a[:, run].flatten(1, 2)[:, :n].clone()
                for k, a in cb.page_pool.items()}

    for p in _pressure_prompts(3):
        cb.submit(p)
    for _ in range(2):
        cb.step()
    slot = cb._pick_preempt_slot()
    req = cb.slot_req[slot]
    # cells [0, pos) are final; cell pos is the frontier the resumed
    # first step rewrites
    n = int(cb.pos[slot])
    before = cells(slot, n)
    cb._preempt_slot(slot)
    assert cb.kv_tier_stats()["swap_outs"] == 1
    cb.step()                                  # readmits the victim
    slot = next(s for s in range(cb.n_slots) if cb.slot_req[s] is req)
    assert cb.kv_tier_stats()["swap_ins"] == 1
    after = cells(slot, n)
    for k in before:
        assert torch.equal(before[k], after[k]), k
    cb.generate_all([])


def test_swap_to_host_off_knob(model):
    """swap_to_host=False keeps the tier for prefixes only: no victim
    demotes, replay serves, the streams hold."""
    prompts = _pressure_prompts(6)

    def run(make, **extra):
        cb = make(model, **PRESSURE, **extra)
        return cb, [[int(t) for t in o] for o in cb.generate_all(prompts)]

    _, oracle = run(_port)
    cb, got = run(_port, kv_tier_bytes=64 << 20, swap_to_host=False)
    jeng, want = run(_jax, kv_tier_bytes=64 << 20, swap_to_host=False)
    assert got == oracle == want
    st = cb.kv_tier_stats()
    assert st["swap_outs"] == 0 and st["swap_ins"] == 0
    assert st == jeng.kv_tier_stats()


@pytest.mark.parametrize("chunk", [0, 8], ids=["blocking", "chunked"])
def test_swap_out_entry_point(model, chunk):
    """swap_out (a scheduler's admission preemption) demotes the live
    run and cancels; resubmitting the folded sequence promotes it (a
    chunked engine through its chunked admission), and the continuation
    is what the undisturbed request would emit."""
    prompt = _prompts((9,), seed=7)[0]
    kw = dict(max_new_tokens=8, chunk=2, kv_layout="paged",
              prefill_chunk=chunk)
    eng = _port(model, kv_tier_bytes=32 << 20, **kw)
    jeng = _jax(model, kv_tier_bytes=32 << 20, **kw)
    full = [int(t) for t in _port(model, **kw).generate_all([prompt])[0]]
    outs = []
    for e in (eng, jeng):
        idx = e.submit(prompt, max_new=8)
        req = e._requests[idx]
        while len(req.out) < 2:
            e.step()
        emitted = [int(t) for t in req.out]
        e.swap_out(idx)
        assert e.kv_tier_stats()["swap_outs"] == 1
        rest = e.generate_all([prompt + emitted])[0]
        assert e.kv_tier_stats()["swap_ins"] == 1
        outs.append(emitted + [int(t) for t in rest])
    assert outs[0] == outs[1]
    # greedy: the resumed continuation extends the undisturbed stream
    assert outs[0][:len(full)] == full
    assert eng.kv_tier_stats() == jeng.kv_tier_stats()
    eng.allocator.check()
    assert eng.allocator.used_pages == 0


# ---------------------------------------------------------------------------
# leak freedom, capacity pressure, the chaos leg


def test_cancel_and_reset_leak_free(model):
    prompts = _prompts((20, 21), seed=17)
    kw = dict(n_slots=2, kv_layout="paged", prefix_cache_rows=1,
              kv_tier_bytes=32 << 20)
    cbs = [_port(model, **kw), _jax(model, **kw)]
    for cb in cbs:
        idx = [cb.submit(p, max_new=8) for p in prompts]
        for _ in range(3):
            cb.step()
        cb.cancel(idx[0])
        for _ in range(2):
            cb.step()
    assert cbs[0].kv_tier_stats() == cbs[1].kv_tier_stats()
    assert cbs[0].allocator._refs == cbs[1].allocator._refs
    cb = cbs[0]
    cb.reset()
    cb.allocator.check()
    assert cb.allocator.used_pages == 0
    assert cb.kv_tier.entry_count() == 0 and cb.kv_tier.bytes_used == 0
    # the engine still serves correctly after the reset
    out = [int(t) for t in cb.generate_all([prompts[0]])[0]]
    fresh = _port(model, n_slots=2, kv_layout="paged")
    assert out == [int(t) for t in fresh.generate_all([prompts[0]])[0]]


def test_tier_pressure_eviction_accounting(model):
    """A tier far too small for the churn evicts and rejects; the byte
    accounting stays exact and the streams hold."""
    prompts = _prompts((20, 21, 22, 23, 24), seed=19)
    rounds = [prompts, prompts]
    kw = dict(kv_layout="paged", prefix_cache_rows=1)
    oracle = _churn(_port(model, **kw), rounds)
    cb = _port(model, kv_tier_bytes=24 << 10, **kw)
    jeng = _jax(model, kv_tier_bytes=24 << 10, **kw)
    assert _churn(cb, rounds) == oracle == _churn(jeng, rounds)
    tier = cb.kv_tier
    assert tier.bytes_used == sum(e.nbytes for e in tier._entries.values())
    assert tier.bytes_used <= tier.capacity_bytes
    assert tier.evictions + tier.rejects > 0
    assert cb.kv_tier_stats() == jeng.kv_tier_stats()
    cb.allocator.check()


def test_chaos_crash_mid_demotion_falls_back_to_replay(model):
    """A fault injected inside the tier's record path fires
    mid-demotion: nothing is stored or leaked, a demote failure is
    counted, and the streams stay byte-identical."""
    prompts = _prompts((20, 21, 22), seed=23)
    rounds = [prompts, prompts]
    kw = dict(kv_layout="paged", prefix_cache_rows=1)
    oracle = _churn(_port(model, **kw), rounds)
    fi, jfi = FaultInjector(), JaxInjector()
    fi.fail_engine_step("eng#kvtier", at_step=1)
    jfi.fail_engine_step("eng#kvtier", at_step=1)
    cb = _port(model, kv_tier_bytes=32 << 20, chaos=fi, chaos_tag="eng", **kw)
    jeng = _jax(model, kv_tier_bytes=32 << 20, chaos=jfi, chaos_tag="eng",
                **kw)
    assert _churn(cb, rounds) == oracle == _churn(jeng, rounds)
    tier = cb.kv_tier
    assert tier.demote_failures >= 1
    assert fi.fired and fi.fired == jfi.fired
    assert tier.bytes_used == sum(e.nbytes for e in tier._entries.values())
    assert cb.kv_tier_stats() == jeng.kv_tier_stats()
    cb.allocator.check()
    cb.reset()
    assert cb.allocator.used_pages == 0


# ---------------------------------------------------------------------------
# off by default


def test_default_engine_has_no_tier(model, monkeypatch):
    """kv_tier_bytes=0: no tier object, {} stats, and a churn that
    evicts calls none of the transfer functions."""
    def boom(*a, **k):
        raise AssertionError("a tier transfer ran with the tier off")

    for name in ("snapshot_row", "snapshot_pages", "upload_row",
                 "install_row_pages", "upload_pages"):
        monkeypatch.setattr(tkv, name, boom)
    cb = _port(model, kv_layout="paged", prefix_cache_rows=1)
    assert cb.kv_tier is None and cb.kv_tier_stats() == {}
    out = _churn(cb, [_prompts((20, 21), seed=29)])
    assert cb.prefix_cache.evictions >= 1
    jeng = _jax(model, kv_layout="paged", prefix_cache_rows=1)
    assert out == _churn(jeng, [_prompts((20, 21), seed=29)])
    assert cb.health_stats() == {}
