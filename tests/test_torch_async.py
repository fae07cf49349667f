"""The port's one-deep dispatch pipeline (`async_depth=1`): step()
harvests dispatch N-1, then admits and drafts from the refreshed host
mirrors, then enqueues dispatch N without waiting for it. Both depths
run the same dispatches on the same state, so streams (greedy and
sampled) and `spec.stats()` must be IDENTICAL across depths, dense and
paged, with and without speculation and under the JAX package's
composition sweep (tests/test_serving_paged.py's CONFIGS); only the
call on which events surface moves, exactly one call later. The port at
depth 1 equals the JAX engine at depth 1 (greedy streams and stats).
The lifecycle: a cancel that lands while a dispatch is in flight frees
the slot for good and leaves every other stream untouched;
drain_inflight and a raising step orphan the in-flight dispatch, whose
tokens are then regenerated from the last harvested state; step_stats
has JAX's keys and counts its dispatches."""

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

ENGINE = dict(n_slots=3, max_len=64, max_new_tokens=10, chunk=4)


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
    """Random prompts after a shared prefix, and a repeating one, so
    the prefix cache hits and the drafter proposes."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 250, size=shared_prefix).tolist()
    out = [base + rng.integers(1, 250, size=n).tolist() for n in lengths]
    pat = rng.integers(1, 250, size=3).tolist()
    return out + [base + pat * 4]


PROMPTS = dict(lengths=(3, 5, 2, 7, 12, 9), seed=1, shared_prefix=20)


def _engine(model, **kw):
    _, _, tcfg, tparams = model
    return teng.ContinuousBatcher(tcfg, tparams, device="cpu",
                                  **{**ENGINE, **kw})


def _drain(engine, prompts):
    return [list(map(int, r)) for r in engine.generate_all(prompts)]


def _stats(engine):
    return None if engine.spec is None else engine.spec.stats()


# the JAX package's composition sweep (tests/test_serving_paged.py),
# each at both depths here
CONFIGS = [
    ("plain", {}),
    ("int8", dict(kv_quant=True)),
    ("prefix", dict(prefix_cache_rows=4)),
    ("int8_prefix", dict(kv_quant=True, prefix_cache_rows=4)),
    ("spec", dict(spec_draft_len=4)),
    ("kitchen_sink", dict(prefix_cache_rows=4, spec_draft_len=4)),
    ("sampled", dict(temperature=0.8, top_k=20, seed=3)),
    ("sampled_spec", dict(temperature=0.8, top_k=20, seed=3,
                          spec_draft_len=4)),
    ("chunked_spec", dict(prefill_chunk=4, spec_draft_len=3)),
]


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("kw", [c[1] for c in CONFIGS],
                         ids=[c[0] for c in CONFIGS])
def test_streams_and_stats_identical_across_depths(model, kw, layout):
    prompts = _prompts(**PROMPTS)
    e0 = _engine(model, kv_layout=layout, **kw)
    e1 = _engine(model, kv_layout=layout, async_depth=1, **kw)
    out0, out1 = _drain(e0, prompts), _drain(e1, prompts)
    assert out0 == out1
    assert _stats(e0) == _stats(e1)
    assert (e0.decode_steps, e0.verify_steps) == (
        e1.decode_steps, e1.verify_steps)
    if e0.spec is not None:
        assert e0.spec.proposed > 0
    if layout == "paged":
        assert e0.paged_stats() == e1.paged_stats()
        e1.allocator.check()
        # the dense bank serves the same streams
        dense = _engine(model, async_depth=1, **kw)
        assert _drain(dense, prompts) == out1


@pytest.mark.parametrize("kw", [
    dict(spec_draft_len=4, kv_layout="paged"),
    dict(spec_draft_len=4, prefix_cache_rows=4),
    dict(kv_layout="paged", n_pages=6, max_new_tokens=24, chunk=3),
    dict(spec_draft_len=3, prefill_chunk=4, kv_layout="paged"),
], ids=["spec_paged", "spec_prefix_dense", "pressure", "chunked_spec"])
def test_depth_1_equals_jax_depth_1(model, kw):
    jcfg, jparams, _, _ = model
    prompts = _prompts(**PROMPTS)
    jax_eng = JaxBatcher(jcfg, jparams, **{**ENGINE, **kw}, async_depth=1)
    want = _drain(jax_eng, prompts)
    port = _engine(model, async_depth=1, **kw)
    assert _drain(port, prompts) == want
    if port.spec is not None:
        assert port.spec.stats() == jax_eng.spec.stats()
    if port._paged:
        js, ts = jax_eng.paged_stats(), port.paged_stats()
        assert {k: js[k] for k in ts} == ts
    assert port.step_stats()["dispatches"] == (
        jax_eng.step_stats()["dispatches"])


def _step_events(engine, prompts):
    for p in prompts:
        engine.submit(p)
    calls = []
    while engine.has_work():
        calls.append(engine.step())
    return calls


@pytest.mark.parametrize("kw", [{}, dict(spec_draft_len=4),
                                dict(prefill_chunk=4)],
                         ids=["chunk", "spec", "chunked"])
def test_events_surface_one_call_later(model, kw):
    prompts = _prompts(**PROMPTS)
    sync = _step_events(_engine(model, **kw), prompts)
    pipe = _step_events(_engine(model, async_depth=1, **kw), prompts)
    assert pipe[0] == []
    assert pipe[1:] == sync
    assert any(sync)


def _interleaved(model, depth, seed, **kw):
    """A seeded sequence of submit / cancel / step calls that depends
    only on the rng, so both depths replay it exactly."""
    rng = np.random.default_rng(seed)
    eng = _engine(model, n_slots=2, async_depth=depth, **kw)
    prompts = _prompts((5, 9, 3, 7, 4, 6, 8), seed=seed)
    emitted, submitted, cancelled, pi = {}, [], set(), 0
    for _ in range(60):
        r = rng.random()
        if r < 0.35 and pi < len(prompts):
            idx = eng.submit(prompts[pi])
            submitted.append(idx)
            emitted[idx] = []
            pi += 1
        elif r < 0.5 and submitted:
            victim = submitted[int(rng.integers(len(submitted)))]
            if victim not in cancelled:
                eng.cancel(victim)
                cancelled.add(victim)
        else:
            for idx, toks, _fin in eng.step():
                emitted[idx].extend(toks)
    while eng.has_work():
        for idx, toks, _fin in eng.step():
            emitted[idx].extend(toks)
    return eng, {i: t for i, t in emitted.items() if i not in cancelled}


@pytest.mark.parametrize("kw", [dict(kv_layout="paged"),
                                dict(kv_layout="paged", spec_draft_len=4),
                                dict(spec_draft_len=4)],
                         ids=["paged", "paged_spec", "dense_spec"])
@pytest.mark.parametrize("seed", range(3))
def test_cancel_mid_flight_leaves_the_others(model, seed, kw):
    """A cancel landing between a dispatch and its harvest frees the
    slot (and its pages) for good, and every surviving stream equals
    the sync run of the same call sequence. A cancelled stream may stop
    one dispatch earlier at depth 1, so it is not compared."""
    e0, want = _interleaved(model, 0, seed, **kw)
    e1, got = _interleaved(model, 1, seed, **kw)
    assert got == want
    assert e1._inflight is None and e1.done.all()
    if e1._paged:
        e1.allocator.check()
        assert e1.allocator.used_pages == 0


def test_cancel_while_in_flight_frees_the_slot(model):
    eng = _engine(model, async_depth=1, kv_layout="paged", n_slots=1)
    idx = eng.submit(_prompts((9,))[0])
    assert eng.step() == []              # admitted, dispatch in flight
    assert eng._inflight is not None
    eng.cancel(idx)
    assert eng.slot_req[0] is None
    assert eng.step() == []              # the harvest emits nothing
    assert eng.done.all() and not eng.has_work()
    eng.allocator.check()
    assert eng.allocator.used_pages == 0
    # the slot serves fresh work
    out = _drain(eng, _prompts((4,), seed=7))
    assert out == _drain(_engine(model, kv_layout="paged", n_slots=1),
                         _prompts((4,), seed=7))


@pytest.mark.parametrize("kw", [{}, dict(spec_draft_len=4),
                                dict(prefill_chunk=4, kv_layout="paged")],
                         ids=["chunk", "spec", "chunked_paged"])
def test_drain_inflight_regenerates_the_dispatch(model, kw):
    """drain_inflight abandons the in-flight dispatch: its events never
    surface, the mirrors stay at the last harvested state, and the next
    dispatch runs from there (greedy: the same tokens again)."""
    prompts = _prompts(**PROMPTS)
    want = _drain(_engine(model, **kw), prompts)
    eng = _engine(model, async_depth=1, **kw)
    for p in prompts:
        eng.submit(p)
    seen, call = {}, 0
    while eng.has_work():
        call += 1
        if call in (3, 7):
            pos = eng.pos.copy()
            eng.drain_inflight()
            assert eng._inflight is None
            np.testing.assert_array_equal(eng.pos, pos)
        for idx, toks, _fin in eng.step():
            seen.setdefault(idx, []).extend(toks)
    assert _drain(eng, []) == want
    assert [seen[i] for i in sorted(seen)] == want


@pytest.mark.parametrize("depth,raise_at", [(0, 6), (1, 5)])
def test_raising_step_orphans_its_dispatch(model, depth, raise_at):
    """A step that raises leaves nothing in flight: the dispatch it held
    (at depth 0 the one it just enqueued, at depth 1 the previous
    step's) never surfaces, and the next step re-dispatches from the
    last harvested state."""
    prompts = _prompts(**PROMPTS)
    want = _drain(_engine(model, spec_draft_len=4), prompts)
    eng = _engine(model, async_depth=depth, spec_draft_len=4)
    real = eng._harvest
    calls = {"n": 0}

    def harvest():
        calls["n"] += 1
        if calls["n"] == raise_at:
            assert eng._inflight is not None
            raise RuntimeError("injected")
        return real()

    eng._harvest = harvest
    for p in prompts:
        eng.submit(p)
    raised = 0
    while eng.has_work():
        try:
            eng.step()
        except RuntimeError:
            raised += 1
            assert eng._inflight is None
    assert raised == 1
    assert _drain(eng, []) == want


def test_step_stats_keys_and_counts(model):
    jcfg, jparams, _, _ = model
    prompts = _prompts(**PROMPTS)
    for depth in (0, 1):
        eng = _engine(model, async_depth=depth, spec_draft_len=4)
        jax_eng = JaxBatcher(jcfg, jparams, **ENGINE, async_depth=depth,
                             spec_draft_len=4)
        assert eng.step_stats() == {"host_ms": 0.0, "device_wait_ms": 0.0,
                                    "dispatches": 0.0, "overlap_ratio": 0.0}
        _drain(eng, prompts)
        _drain(jax_eng, prompts)
        st, jst = eng.step_stats(), jax_eng.step_stats()
        assert set(st) == set(jst)
        assert st["dispatches"] == jst["dispatches"] > eng.verify_steps > 0
        assert st["host_ms"] > 0 and st["device_wait_ms"] >= 0
        assert 0.0 <= st["overlap_ratio"] <= 1.0
