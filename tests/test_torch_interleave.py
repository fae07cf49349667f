"""The port's interleaved chunked prefill (`prefill_chunk > 0`) against
the JAX engine: an admission installs the slot frozen with a write
frontier, and each dispatch runs up to prefill_chunk prompt tokens of
the oldest mid-prefill slot (through `_cached_attention`, never flash)
before the usual decode steps.

Greedy streams must be EXACTLY the JAX engine's for prefill_chunk 4 and
16, dense and paged, int8 KV cache off and on, and with all three knobs
together (pressure, the prefix cache, prefill_chunk); for exact banks
they also equal the port's own blocking run (prefill_chunk=0). An int8
bank attends the dequantized earlier chunks where a blocking prefill
attends full-precision activations, so there the chunked stream is held
to JAX's only, as the JAX package documents. The integer state must
match: `prefill_stats` (all but the stall time), `paged_stats`, the
allocator's refcounts, the prefix-cache stats. The lifecycle: a cancel
mid-prefill frees the slot's pages, and a partly prefilled slot
preempted under pressure replays (its readmission waits, with no swap
rights, instead of livelocking)."""

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

ENGINE = dict(n_slots=2, max_len=64, max_new_tokens=8, chunk=4)


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
    jp, tp = jax_eng.prefill_stats(), port.prefill_stats()
    jp.pop("admission_stall_ms")
    tp.pop("admission_stall_ms")
    assert tp == jp
    if port._paged:
        js, ts = jax_eng.paged_stats(), port.paged_stats()
        assert {k: js[k] for k in ts} == ts
        port.allocator.check()
        assert port.allocator._refs == jax_eng.allocator._refs
    if port.prefix_cache is not None:
        assert port.prefix_cache.stats() == jax_eng.prefix_cache.stats()


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("pc", [4, 16])
def test_chunked_streams_equal_jax(model, pc, layout, quant):
    prompts = _prompts((21, 9, 40, 3, 17), seed=3)
    kw = dict(prefill_chunk=pc, kv_layout=layout, kv_quant=quant)
    if layout == "paged":
        kw["n_pages"] = 24
    jax_eng, want = _jax(model, prompts, **kw)
    port, got = _port(model, prompts, **kw)
    assert got == want
    assert port.prefill_stats()["prefill_chunks_total"] >= len(prompts)
    assert port.prefill_stats()["prefilling_slots"] == 0
    _assert_same_state(jax_eng, port)
    if not quant:
        _, blocking = _port(model, prompts, **{**kw, "prefill_chunk": 0})
        assert got == blocking


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_all_knobs_together_equal_jax(model, layout, quant):
    """Pressure (paged), the prefix cache and prefill_chunk at once, on
    shared-prefix traffic with sampling off."""
    prompts = _prompts((4, 18, 6, 11, 3, 25, 8), seed=2, shared_prefix=20)
    kw = dict(n_slots=3, max_new_tokens=24, chunk=3, kv_layout=layout,
              kv_quant=quant, prefix_cache_rows=4, prefill_chunk=4)
    if layout == "paged":
        kw["n_pages"] = 6
    jax_eng, want = _jax(model, prompts, **kw)
    port, got = _port(model, prompts, **kw)
    assert got == want
    _assert_same_state(jax_eng, port)
    if layout == "paged":
        assert port.paged_stats()["swap_preemptions"] > 0


def test_chunk_lengths_equal_jax(model):
    jcfg, jparams, tcfg, tparams = model
    jax_eng = JaxBatcher(jcfg, jparams, **ENGINE, prefill_chunk=16)
    port = teng.ContinuousBatcher(tcfg, tparams, device="cpu", **ENGINE,
                                  prefill_chunk=16)
    for rem in range(1, 40):
        assert port._pf_chunk_len(rem) == jax_eng._pf_chunk_len(rem)


def test_mid_prefill_slot_is_frozen_and_counted(model):
    """A mid-prefill slot is occupied on the host, draws no decode
    steps (the chunk length ignores it), and reports negative
    preemption progress."""
    _, _, tcfg, tparams = model
    eng = teng.ContinuousBatcher(tcfg, tparams, device="cpu", **ENGINE,
                                 prefill_chunk=4)
    idx = eng.submit(_prompts((40,), seed=6)[0])
    eng.step()
    assert eng._prefilling[0] and not eng.done[0]
    assert eng._frontier[0] == 4 and eng.active_count() == 1
    assert eng._next_chunk_len() == 1
    assert eng._slot_progress(0) == 4 - 40
    assert eng.prefill_stats()["prefilling_slots"] == 1
    assert eng._slot_gen[0] is None
    assert eng.slot_req[0].out == []
    while eng.has_work():
        eng.step()
    assert len(eng.retire(idx)) == 8


@pytest.mark.parametrize("how", ["cancel", "retire"])
def test_release_mid_prefill_frees_pages(model, how):
    _, _, tcfg, tparams = model
    eng = teng.ContinuousBatcher(
        tcfg, tparams, device="cpu", n_slots=1, max_len=64,
        max_new_tokens=6, chunk=4, prefill_chunk=2, kv_layout="paged",
        n_pages=24, prefix_cache_rows=2)
    idx = eng.submit(_prompts((40,), seed=6)[0])
    eng.step()
    assert eng._prefilling.any() and eng.allocator.used_pages > 0
    if how == "cancel":
        eng.cancel(idx)
    else:
        eng.retire(idx)
    assert not eng._prefilling.any() and int(eng._frontier.sum()) == 0
    eng.allocator.check()
    assert eng.allocator.used_pages == 0 and eng.done.all()
    assert not eng.has_work()
    fresh = _prompts((7,), seed=7)
    _, want = _port(model, fresh, n_slots=1, max_new_tokens=6)
    assert _drain(eng, fresh) == want


def test_preempted_mid_prefill_slot_replays(model):
    """Page pressure mid-prefill: the arrival preempts the partly
    prefilled slot (the coldest: nothing to regenerate), whose
    readmission waits for pages; the streams equal the JAX engine's and
    an unpressured blocking run's."""
    prompts = _prompts((40, 36), seed=8)
    kw = dict(chunk=2, max_new_tokens=6, prefill_chunk=4, kv_layout="paged",
              n_pages=5)
    _, want = _port(model, prompts, chunk=2, max_new_tokens=6)
    jcfg, jparams, tcfg, tparams = model
    runs = []
    for eng in (JaxBatcher(jcfg, jparams, **{**ENGINE, **kw}),
                teng.ContinuousBatcher(tcfg, tparams, device="cpu",
                                       **{**ENGINE, **kw})):
        eng.submit(prompts[0])
        eng.step()
        assert eng._prefilling.any()
        eng.submit(prompts[1])
        n = 0
        while eng.has_work():
            eng.step()
            n += 1
            assert n < 500, "admission livelocked"
        runs.append((eng, _drain(eng, [])))
    (jax_eng, jax_out), (port, got) = runs
    assert got == jax_out == want
    st = port.paged_stats()
    assert st["swap_preemptions"] >= 1
    assert st["swap_resumes"] == st["swap_preemptions"]
    _assert_same_state(jax_eng, port)
    assert port.allocator.used_pages == 0
