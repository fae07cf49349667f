"""The port's admission-time prefix cache (dlrover_tpu_torch/serving/
prefix_cache.py and the engine's warm admission paths) against the JAX
package's.

- The radix tree: a seeded fuzz of operation sequences applied to both
  packages' `RadixPrefixCache`, every return, raised exception, eviction
  callback and `stats()` compared step by step.
- The engine with `prefix_cache_rows > 0`, dense and paged, with and
  without the int8 KV cache: greedy streams EXACTLY equal to the JAX
  engine's, with equal integer state (prefix-cache stats, the page
  allocator's counts, `paged_stats`), and equal to the port's own run
  without the cache. Covered: shared-prefix traffic (warm admissions
  publish and hit), full-prefix hits, a non-power-of-two max_len whose
  match retreats, and eviction under a one-row pool."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from dlrover_tpu.serving.prefix_cache import RadixPrefixCache as JaxRadix
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.serving import engine as teng
from dlrover_tpu_torch.serving.prefix_cache import RadixPrefixCache


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


# -- the radix tree -----------------------------------------------------------

_OPS = ("match", "insert", "acquire", "release", "evict")


def _apply(cache, log, kind, toks, row):
    try:
        if kind == "match":
            return cache.match(toks)
        if kind == "insert":
            return cache.insert(toks)
        if kind == "acquire":
            return cache.acquire(row)
        if kind == "release":
            return cache.release(row)
        return cache.evict_lru()
    except (KeyError, ValueError) as e:
        return type(e).__name__
    finally:
        log.append(("stats", cache.stats()))


@pytest.mark.parametrize("seed", range(6))
def test_radix_fuzz_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        rows = int(rng.integers(1, 4))
        block = int(rng.choice([1, 2, 4]))
        jlog, tlog = [], []
        # the callback gets the evicted prefix's block path (what the
        # host KV tier keys a demotion by) in both packages
        jax_cache = JaxRadix(
            rows, block=block,
            on_evict=lambda row, blocks: jlog.append(("evict", row, blocks)))
        port = RadixPrefixCache(
            rows, block=block,
            on_evict=lambda row, blocks: tlog.append(("evict", row, blocks)))
        for _ in range(int(rng.integers(1, 60))):
            kind = _OPS[int(rng.integers(len(_OPS)))]
            toks = rng.integers(0, 4, size=int(rng.integers(0, 10))).tolist()
            row = int(rng.integers(-1, rows + 1))
            want = _apply(jax_cache, jlog, kind, toks, row)
            got = _apply(port, tlog, kind, toks, row)
            assert got == want, (kind, toks, row)
            assert tlog == jlog
            assert [port.refcount(r) for r in range(rows)] == [
                jax_cache.refcount(r) for r in range(rows)]
            assert port.aligned_len(len(toks)) == jax_cache.aligned_len(
                len(toks))


def test_radix_record_admission_and_underflow():
    port, ref = RadixPrefixCache(2, block=2), JaxRadix(2, block=2)
    for cache in (port, ref):
        row, is_new = cache.insert([1, 2])
        assert is_new
        with pytest.raises(ValueError, match="unreferenced"):
            cache.release(row)
        for reused in (0, 4, 2, 0):
            cache.record_admission(reused)
    assert port.stats() == ref.stats()
    assert port.hit_rate() == ref.hit_rate() == 0.5
    with pytest.raises(ValueError, match="n_rows"):
        RadixPrefixCache(0)


# -- the engine ---------------------------------------------------------------


def _shared_prompts(seed=0, tails=(3, 9, 9, 9)):
    """Fixed tails on a shared 40-token prefix, then one unrelated
    5-token miss (the JAX tests' traffic)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 250, size=40).tolist()
    return [shared + rng.integers(1, 250, size=t).tolist() for t in tails] + [
        rng.integers(1, 250, size=5).tolist()]


def _drain(engine, prompts):
    return [list(map(int, r)) for r in engine.generate_all(prompts)]


def _both(model, prompts, **kw):
    jcfg, jparams, tcfg, tparams = model
    jax_eng = JaxBatcher(jcfg, jparams, **kw)
    want = _drain(jax_eng, prompts)
    port = teng.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    got = _drain(port, prompts)
    return jax_eng, want, port, got


def _assert_same_state(jax_eng, port):
    """The integer state the two engines must share after a drain."""
    if port.prefix_cache is not None:
        assert port.prefix_cache.stats() == jax_eng.prefix_cache.stats()
    if port._paged:
        js, ts = jax_eng.paged_stats(), port.paged_stats()
        assert {k: js[k] for k in ts} == ts
        port.allocator.check()
        assert port.allocator._refs == jax_eng.allocator._refs
    jp, tp = jax_eng.prefill_stats(), port.prefill_stats()
    jp.pop("admission_stall_ms")
    tp.pop("admission_stall_ms")
    assert tp == jp


def _cold(model, prompts, **kw):
    _, _, tcfg, tparams = model
    kw = {k: v for k, v in kw.items() if not k.startswith("prefix")}
    return _drain(teng.ContinuousBatcher(tcfg, tparams, device="cpu", **kw),
                  prompts)


LAYOUTS = [("dense", False), ("dense", True), ("paged", False),
           ("paged", True)]
LAYOUT_IDS = [f"{lay}-{'int8' if q else 'f32'}" for lay, q in LAYOUTS]


@pytest.mark.parametrize("layout,quant", LAYOUTS, ids=LAYOUT_IDS)
def test_shared_prefix_streams_equal_jax(model, layout, quant):
    prompts = _shared_prompts(seed=1)
    kw = dict(n_slots=2, max_len=64, max_new_tokens=6, chunk=4,
              prefix_cache_rows=4, kv_layout=layout, kv_quant=quant)
    jax_eng, want, port, got = _both(model, prompts, **kw)
    assert got == want
    assert port.prefix_cache.hits > 0
    _assert_same_state(jax_eng, port)
    assert got == _cold(model, prompts, **kw)
    if layout == "paged":
        # hits share published pages by refcount, copy-free
        assert port.paged_stats()["pages_shared"] > 0


@pytest.mark.parametrize("layout,quant", LAYOUTS, ids=LAYOUT_IDS)
def test_full_prefix_hit_equals_jax(model, layout, quant):
    """A block-aligned prompt that is wholly cached admits with no
    prefill (paged: the frontier page copied on write)."""
    rng = np.random.default_rng(4)
    shared = rng.integers(1, 250, size=32).tolist()
    prompts = [shared, shared, shared + [5, 7], shared]
    kw = dict(n_slots=2, max_len=64, max_new_tokens=6, chunk=4,
              prefix_cache_rows=4, kv_layout=layout, kv_quant=quant)
    jax_eng, want, port, got = _both(model, prompts, **kw)
    assert got == want
    assert port.prefix_cache.stats()["tokens_reused"] >= 64
    _assert_same_state(jax_eng, port)
    assert got == _cold(model, prompts, **kw)
    if layout == "paged":
        assert port.paged_stats()["cow_copies"] > 0


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_non_pow2_max_len_retreats_like_jax(model, layout):
    """max_len 50 (pages of 2): a deep match whose suffix bucket cannot
    fit retreats, possibly to a cold admission."""
    rng = np.random.default_rng(5)
    shared = rng.integers(1, 250, size=32).tolist()
    prompts = [shared + rng.integers(1, 250, size=n).tolist()
               for n in (3, 13, 17, 16)]
    kw = dict(n_slots=2, max_len=50, max_new_tokens=4, chunk=4,
              prefix_cache_rows=4, kv_layout=layout)
    jax_eng, want, port, got = _both(model, prompts, **kw)
    assert got == want
    _assert_same_state(jax_eng, port)
    assert got == _cold(model, prompts, **kw)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_eviction_under_pressure_equals_jax(model, layout):
    """A one-row pool, three distinct prefixes interleaved across two
    slots: rows are published, evicted and published again while other
    requests decode."""
    rng = np.random.default_rng(7)
    prompts = []
    for _ in range(3):
        pre = rng.integers(1, 250, size=16).tolist()
        prompts += [pre + rng.integers(1, 250, size=3).tolist()
                    for _ in range(2)]
    kw = dict(n_slots=2, max_len=64, max_new_tokens=4, chunk=4,
              prefix_cache_rows=1, kv_layout=layout)
    jax_eng, want, port, got = _both(model, prompts, **kw)
    assert got == want
    assert port.prefix_cache.evictions > 0
    _assert_same_state(jax_eng, port)


def test_auto_page_size_divides_prefix_block(model):
    _, _, tcfg, tparams = model
    eng = teng.ContinuousBatcher(tcfg, tparams, n_slots=2, max_len=64,
                                 kv_layout="paged", prefix_cache_rows=2,
                                 prefix_block=8, device="cpu")
    assert eng.page_size == 8
    with pytest.raises(ValueError, match="prefix_block"):
        teng.ContinuousBatcher(tcfg, tparams, max_len=64, kv_layout="paged",
                               page_size=16, prefix_cache_rows=2,
                               prefix_block=8, device="cpu")
