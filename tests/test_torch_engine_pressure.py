"""The port's paged engine under page-pool pressure (n_pages below the
dense-equivalent pool) against the JAX engine: a dry pool evicts
unreferenced prefix runs, then preempts the coldest live request and
replays it.

Greedy streams must be EXACTLY the JAX engine's (int8 KV cache off and
on, prefix cache off and on) and the port's own on the dense-equivalent
pool; the integer state must match too: `paged_stats` (swap
preemptions and resumes, pages allocated / freed / shared, CoW copies),
the allocator's refcounts and the prefix-cache stats. The admission
headroom gate agrees with JAX's step by step. Sampled streams are held
to the port itself: with one seed, pressure, the prefix cache and
prefill_chunk (each alone and together) leave the stream unchanged,
because a preempted request carries its generator's state and a
chunked admission installs its generator only when it starts
decoding."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.serving import engine as teng

ENGINE = dict(n_slots=3, max_len=64, max_new_tokens=24, chunk=3)


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


def _prompts(lengths, seed=0, shared_prefix=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 250, size=shared_prefix).tolist()
    return [base + rng.integers(1, 250, size=n).tolist() for n in lengths]


PROMPTS = dict(lengths=(4, 18, 6, 11, 3, 25, 8), seed=2)


def _port(model, prompts, **kw):
    _, _, tcfg, tparams = model
    eng = teng.ContinuousBatcher(tcfg, tparams, device="cpu",
                                 **{**ENGINE, **kw})
    return eng, [list(map(int, r)) for r in eng.generate_all(prompts)]


def _jax(model, prompts, **kw):
    jcfg, jparams, _, _ = model
    eng = JaxBatcher(jcfg, jparams, **{**ENGINE, **kw})
    return eng, [list(map(int, r)) for r in eng.generate_all(prompts)]


def _assert_same_state(jax_eng, port):
    js, ts = jax_eng.paged_stats(), port.paged_stats()
    assert {k: js[k] for k in ts} == ts
    port.allocator.check()
    assert port.allocator._refs == jax_eng.allocator._refs
    if port.prefix_cache is not None:
        assert port.prefix_cache.stats() == jax_eng.prefix_cache.stats()


@pytest.mark.parametrize("prefix", [0, 4], ids=["noprefix", "prefix"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("n_pages", [5, 6])
def test_pressure_streams_equal_jax(model, n_pages, quant, prefix):
    shared = 20 if prefix else 0
    prompts = _prompts(**PROMPTS, shared_prefix=shared)
    kw = dict(kv_layout="paged", n_pages=n_pages, kv_quant=quant,
              prefix_cache_rows=prefix)
    jax_eng, want = _jax(model, prompts, **kw)
    port, got = _port(model, prompts, **kw)
    assert got == want
    st = port.paged_stats()
    assert st["swap_preemptions"] > 0, "pool never pressured"
    assert st["swap_resumes"] == st["swap_preemptions"]
    _assert_same_state(jax_eng, port)
    held = {p for run in port._row_pages.values() for p in run}
    assert port.allocator.used_pages == len(held)
    if not quant:
        # a replay prefills the emitted tokens' K/V where decode wrote
        # them: the same values for an exact bank; an int8 bank attends
        # its dequantized cells in decode, so there (as in JAX) a
        # replayed stream is the engine's own, not the roomy pool's
        _, roomy = _port(model, prompts, kv_layout="paged",
                         prefix_cache_rows=prefix)
        assert got == roomy


def test_preempted_request_folds_its_tokens(model):
    """`_preempt_slot` on a decoding slot: the request goes back to the
    FRONT of the queue with its emitted tokens folded into its prompt,
    the same absolute cap and its page run freed; after its replay the
    stream equals the undisturbed one."""
    prompts = _prompts(**PROMPTS)
    _, want = _port(model, prompts, kv_layout="paged")
    port = teng.ContinuousBatcher(model[2], model[3], device="cpu",
                                  kv_layout="paged", **ENGINE)
    for p in prompts:
        port.submit(p)
    port.step()
    port.step()
    slot = 1
    req = port.slot_req[slot]
    emitted, p0, limit = list(req.out), len(req.prompt), int(port.limit[slot])
    assert emitted and not port.done[slot]
    used = port.allocator.used_pages
    port._preempt_slot(slot)
    assert port._queue[0] is req and req.preempted
    assert req.folded == len(emitted)
    assert list(req.prompt[p0:]) == emitted
    assert len(req.prompt) + req.max_new == limit
    assert port.allocator.used_pages < used and port.done[slot]
    assert port.paged_stats()["swap_preemptions"] == 1
    while port.has_work():
        port.step()
    got = [list(map(int, r)) for r in port.generate_all([])]
    assert got == want
    assert port.paged_stats()["swap_resumes"] == 1
    port.allocator.check()
    assert port.allocator.used_pages == 0


def test_headroom_gate_equals_jax(model):
    prompts = _prompts(**PROMPTS)
    kw = dict(kv_layout="paged", n_pages=6, swap_headroom=1)
    jcfg, jparams, tcfg, tparams = model
    jax_eng = JaxBatcher(jcfg, jparams, **ENGINE, **kw)
    port = teng.ContinuousBatcher(tcfg, tparams, device="cpu", **ENGINE,
                                  **kw)
    assert port.admission_headroom_ok() and jax_eng.admission_headroom_ok()
    seen = set()
    for p in prompts:
        jax_eng.submit(p)
        port.submit(p)
        assert port.admission_headroom_ok() == jax_eng.admission_headroom_ok()
    while jax_eng.has_work():
        jax_eng.step()
        port.step()
        assert port.has_work() == jax_eng.has_work()
        ok = port.admission_headroom_ok()
        assert ok == jax_eng.admission_headroom_ok()
        seen.add(ok)
    assert seen == {True, False}
    dense = teng.ContinuousBatcher(tcfg, tparams, device="cpu", **ENGINE)
    assert dense.admission_headroom_ok() and dense.paged_stats() == {}


KNOBS = [
    ("pressure", dict(kv_layout="paged", n_pages=5)),
    ("prefix", dict(prefix_cache_rows=4)),
    ("paged-prefix", dict(kv_layout="paged", prefix_cache_rows=4)),
    ("chunk", dict(prefill_chunk=4)),
    ("paged-chunk", dict(kv_layout="paged", prefill_chunk=4)),
    ("all", dict(kv_layout="paged", n_pages=6, prefix_cache_rows=4,
                 prefill_chunk=4)),
]


@pytest.fixture(scope="module")
def sampled_baseline(model):
    prompts = _prompts(**PROMPTS, shared_prefix=20)
    return prompts, _port(model, prompts, temperature=0.8, top_k=20,
                          seed=3)[1]


@pytest.mark.parametrize("kw", [k[1] for k in KNOBS],
                         ids=[k[0] for k in KNOBS])
def test_sampled_stream_unchanged_by_knobs(model, sampled_baseline, kw):
    prompts, want = sampled_baseline
    eng, got = _port(model, prompts, temperature=0.8, top_k=20, seed=3,
                     **kw)
    assert got == want
    if kw.get("n_pages"):
        assert eng.paged_stats()["swap_preemptions"] > 0
    if kw.get("prefix_cache_rows") and not kw.get("prefill_chunk"):
        assert eng.prefix_cache.hits > 0
    if kw.get("prefill_chunk"):
        assert eng.prefill_stats()["prefill_chunks_total"] > 0
    _, other = _port(model, prompts, temperature=0.8, top_k=20, seed=4,
                     **kw)
    assert other != want
