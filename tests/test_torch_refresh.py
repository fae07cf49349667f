"""The port's versioned weight refresh (`ContinuousBatcher.update_params`,
`weight_refresh_mode`, `weight_refresh_replay`) against the JAX engine,
case for case with JAX's TestWeightRefresh
(tests/test_serving_elastic.py), on the same seed-made params and
prompts.

Greedy streams, each request's `versions`, `weight_version` and every
`elastic_stats()` field must be EQUAL to the JAX engine's; after an int8
refresh the installed q8 / s8 must be byte-equal to JAX's (the same f32
values quantized by the same formula). JAX's
test_refresh_retires_stale_program_cache_keys has no counterpart: the
port compiles no programs, so no program cache holds a stale version."""

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

# JAX's `_engine`: chunk small beside max_new, so a drain spans steps
ENGINE = dict(n_slots=3, max_len=64, max_new_tokens=12, chunk=2, pad_id=-1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """JAX's tiny f32 tree, its `x * 1.01` bump (TestWeightRefresh's
    refresh), and both carried into the port."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    jbumped = jax.tree_util.tree_map(lambda x: x * 1.01, jparams)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)

    def port(tree):
        return tllama.params_from_numpy(
            tcfg, jax.tree_util.tree_map(np.asarray, tree), device="cpu")

    return jcfg, jparams, jbumped, tcfg, port(jparams), port(jbumped)


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=n).tolist() for n in lengths]


def _engines(model, **kw):
    jcfg, jparams, _, tcfg, tparams, _ = model
    return (JaxBatcher(jcfg, jparams, **{**ENGINE, **kw}),
            teng.ContinuousBatcher(tcfg, tparams, device="cpu",
                                   **{**ENGINE, **kw}))


def _drain(eng):
    while eng.has_work():
        eng.step()


def _outs(eng, idxs):
    return [list(map(int, eng._requests[i].out)) for i in idxs]


def _assert_same(jeng, port, idxs=()):
    assert port.weight_version == jeng.weight_version
    assert port.elastic_stats() == jeng.elastic_stats()
    for i in idxs:
        assert port._requests[i].versions == jeng._requests[i].versions, i
    assert _outs(port, idxs) == _outs(jeng, idxs)


def test_idle_refresh_commits_immediately(model):
    _, _, jbumped, _, _, tbumped = model
    jeng, port = _engines(model)
    assert port.weight_version == 0
    jeng.update_params(jbumped)
    port.update_params(tbumped)
    assert port.weight_version == 1
    assert port.params is tbumped
    prompts = _prompts((6,), 71)
    want = [list(map(int, o)) for o in jeng.generate_all(prompts)]
    got = [list(map(int, o)) for o in port.generate_all(prompts)]
    assert got == want and len(got[0]) > 0
    _assert_same(jeng, port)


def test_defer_fences_each_request_to_one_version(model):
    _, _, jbumped, _, _, tbumped = model
    jeng, port = _engines(model, weight_refresh_mode="defer")
    idx = []
    for eng, bumped in ((jeng, jbumped), (port, tbumped)):
        i0 = eng.submit(_prompts((6,), 72)[0])
        eng.step()                     # mid-drain
        eng.update_params(bumped)
        # staged, not committed: the request keeps its version
        assert eng.weight_version == 0
        _drain(eng)
        assert eng._requests[i0].versions == {0}
        # the next submit crosses the fence: the swap commits first
        i1 = eng.submit(_prompts((7,), 73)[0])
        assert eng.weight_version == 1
        _drain(eng)
        assert eng._requests[i1].versions == {1}
        idx = [i0, i1]
    stats = port.elastic_stats()
    assert stats["refresh_deferred"] == 1.0
    assert stats["refresh_committed"] == 1.0
    _assert_same(jeng, port, idx)


def test_defer_commits_at_the_idle_step(model):
    """A staged refresh also commits at the step() that finds the engine
    idle, not only at submit."""
    _, _, jbumped, _, _, tbumped = model
    jeng, port = _engines(model, weight_refresh_mode="defer")
    for eng, bumped in ((jeng, jbumped), (port, tbumped)):
        eng.submit(_prompts((5,), 78)[0])
        eng.step()
        eng.update_params(bumped)
        _drain(eng)
        assert eng.weight_version == 0
        eng.step()
        assert eng.weight_version == 1
    _assert_same(jeng, port, [0])


def test_raise_mode_refuses_mid_drain(model):
    _, _, jbumped, _, _, tbumped = model
    jeng, port = _engines(model, weight_refresh_mode="raise")
    for eng, bumped in ((jeng, jbumped), (port, tbumped)):
        eng.submit(_prompts((6,), 74)[0])
        eng.step()
        with pytest.raises(RuntimeError, match="in flight"):
            eng.update_params(bumped)
        _drain(eng)
        eng.update_params(bumped)  # idle: fine
        assert eng.weight_version == 1
    _assert_same(jeng, port, [0])


LIVE = [("dense", 0), ("dense", 1), ("paged", 0), ("paged", 1)]


@pytest.mark.parametrize("layout,depth", LIVE,
                         ids=[f"{lay}-depth{d}" for lay, d in LIVE])
def test_live_mode_replays_under_new_version(model, layout, depth):
    """A live swap with replay preempts every live slot (highest slot
    first) and replays it under the new version; at depth 1 the
    in-flight dispatch is abandoned. Streams, versions and counters
    equal JAX's."""
    _, _, jbumped, _, _, tbumped = model
    kw = dict(weight_refresh_mode="live", kv_layout=layout,
              async_depth=depth)
    jeng, port = _engines(model, **kw)
    prompts = _prompts((6, 9, 4, 11), 75)
    for eng, bumped in ((jeng, jbumped), (port, tbumped)):
        for p in prompts:
            eng.submit(p)
        eng.step()
        eng.step()
        eng.update_params(bumped)
        assert eng.weight_version == 1
        _drain(eng)
        # the one case a request may span two versions: only by replay
        assert eng._requests[0].versions <= {0, 1}
        assert 1 in eng._requests[0].versions
    assert port.elastic_stats()["replayed_requests"] >= 1.0
    _assert_same(jeng, port, range(len(prompts)))
    if layout == "paged":
        js, ts = jeng.paged_stats(), port.paged_stats()
        assert {k: js[k] for k in ts} == ts
        port.allocator.check()


def test_live_mode_without_replay_finishes_on_new_weights(model):
    """weight_refresh_replay=False: live requests keep their old KV and
    finish under the new weights, with no replay."""
    _, _, jbumped, _, _, tbumped = model
    jeng, port = _engines(model, weight_refresh_mode="live",
                          weight_refresh_replay=False)
    for eng, bumped in ((jeng, jbumped), (port, tbumped)):
        eng.submit(_prompts((8,), 79)[0])
        eng.step()
        eng.update_params(bumped)
        _drain(eng)
        assert eng._requests[0].versions == {0, 1}
    assert port.elastic_stats()["replayed_requests"] == 0.0
    _assert_same(jeng, port, [0])


def _poison_shape(tree, port):
    out = dict(tree)
    out["embed"] = {"weight": (torch.zeros(3) if port
                               else jnp.zeros((3,), jnp.float32))}
    return out


def _poison_dtype(tree, port):
    out = dict(tree)
    w = tree["final_norm"]["scale"]
    out["final_norm"] = {"scale": (w.to(torch.bfloat16) if port
                                   else w.astype(jnp.bfloat16))}
    return out


def _poison_structure(tree, port):
    out = dict(tree)
    out["layers"] = {k: v for k, v in tree["layers"].items() if k != "wq"}
    return out


@pytest.mark.parametrize("poison", [_poison_shape, _poison_dtype,
                                    _poison_structure],
                         ids=["shape", "dtype", "structure"])
@pytest.mark.parametrize("mode", ["defer", "live"])
def test_poisoned_refresh_rolls_back(model, poison, mode):
    """A tree with a leaf's shape or dtype changed, or a leaf missing,
    raises in both engines; the old version keeps serving, byte for
    byte, and rolled_back counts it."""
    _, jparams, _, _, tparams, _ = model
    jeng, port = _engines(model)
    prompts = _prompts((6,), 76)
    for eng, tree, is_port in ((jeng, jparams, False), (port, tparams, True)):
        baseline = [list(o) for o in eng.generate_all(prompts)]
        eng.submit(prompts[0])
        eng.step()
        with pytest.raises(ValueError, match="weight refresh rejected"):
            eng.update_params(poison(tree, is_port), mode=mode)
        assert eng.weight_version == 0
        assert eng.elastic_stats()["refresh_rolled_back"] == 1.0
        _drain(eng)
        assert list(map(int, eng._requests[1].out)) == list(baseline[0])
        assert eng.generate_all([])
    assert port.params is tparams
    _assert_same(jeng, port)


def test_update_params_rejects_unknown_mode(model):
    _, _, _, _, tparams, _ = model
    with pytest.raises(ValueError, match="weight_refresh_mode"):
        teng.ContinuousBatcher(tllama.LlamaConfig.tiny(dtype=torch.float32),
                               tparams, device="cpu",
                               weight_refresh_mode="now")
    _, port = _engines(model)
    with pytest.raises(ValueError, match="mode"):
        port.update_params(tparams, mode="now")


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_int8_live_refresh_requantizes_to_jax_bytes(model, layout):
    """weight_quant="int8": a live refresh re-quantizes the incoming
    dense tree behind the fence; every q8 / s8 after the commit equals
    JAX's byte for byte, and the streams and versions equal JAX's."""
    _, _, jbumped, _, _, tbumped = model
    jeng, port = _engines(model, weight_quant="int8",
                          weight_refresh_mode="live", kv_layout=layout)
    prompts = _prompts((6, 9), 80)
    for eng, bumped in ((jeng, jbumped), (port, tbumped)):
        for p in prompts:
            eng.submit(p)
        eng.step()
        eng.update_params(bumped)
        _drain(eng)
    for name, tw in sorted(port.params["layers"].items()):
        jw = jeng.params["layers"][name]
        if not hasattr(tw, "q8"):
            continue
        assert tw.q8.numpy().tobytes() == np.asarray(jw.q8).tobytes(), name
        assert tw.s8.numpy().tobytes() == np.asarray(jw.s8).tobytes(), name
    th, jh = port.params["lm_head"]["weight"], jeng.params["lm_head"]["weight"]
    assert th.q8.numpy().tobytes() == np.asarray(jh.q8).tobytes()
    # the refresh tree itself stays dense (the caller's)
    assert not hasattr(tbumped["layers"]["wq"], "q8")
    for key in ("weight_quant_leaves", "weight_quant_skipped"):
        assert (port.weight_quant_stats()[key]
                == jeng.weight_quant_stats()[key]), key
    _assert_same(jeng, port, range(len(prompts)))


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_sampled_live_refresh_at_depth_1_replays_the_harvested_draws(
        model, layout):
    """Sampled, depth 1: the live refresh abandons the in-flight dispatch
    and winds each slot's generator back to its state before that
    dispatch's draws, so the replay continues the stream the harvested
    dispatches left (JAX replays on its harvested key mirror): the
    streams equal a depth-0 run whose refresh came after the same
    harvested dispatch."""
    _, _, _, _, _, tbumped = model
    prompts = _prompts((6, 9, 4), 81)
    outs = []
    for depth, steps in ((1, 2), (0, 1)):
        _, port = _engines(model, weight_refresh_mode="live",
                           kv_layout=layout, async_depth=depth,
                           temperature=0.8, top_k=5)
        for i, p in enumerate(prompts):
            port.submit(p, prng_key=100 + i)
        for _ in range(steps):
            port.step()
        port.update_params(tbumped)
        _drain(port)
        outs.append(_outs(port, range(len(prompts))))
    assert outs[0] == outs[1]


def test_drain_inflight_rerun_draws_the_same_tokens(model):
    """Sampled, depth 1: a dispatch abandoned by drain_inflight and run
    again draws the same tokens, so the streams equal an undrained
    run's."""
    prompts = _prompts((6, 9, 4), 82)
    outs = []
    for drain_at in (None, 2):
        _, port = _engines(model, async_depth=1, temperature=0.8, top_k=5)
        for i, p in enumerate(prompts):
            port.submit(p, prng_key=200 + i)
        n = 0
        while port.has_work():
            port.step()
            n += 1
            if n == drain_at:
                port.drain_inflight()
        outs.append(_outs(port, range(len(prompts))))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_after_a_live_commit_the_engine_serves_as_a_fresh_one(model, layout):
    """After a live refresh and its drain, every slot's mirrors are a
    fresh engine's (pad token, position 0, limit 0: a done row rides the
    dispatches, and on the card its position sets the paged kernel's
    work split), and later prompts give a fresh engine's streams on the
    new tree."""
    _, _, _, tcfg, _, tbumped = model
    _, port = _engines(model, weight_refresh_mode="live", kv_layout=layout)
    for p in _prompts((6, 9, 4, 11), 83):
        port.submit(p)
    port.step()
    port.update_params(tbumped)
    assert all(len(o) == 12 for o in port.generate_all([]))
    assert (port.tok == -1).all() and not port.pos.any()
    assert not port.limit.any() and port.done.all()
    later = _prompts((7, 5), 84)
    fresh = teng.ContinuousBatcher(tcfg, tbumped, device="cpu",
                                   kv_layout=layout, **ENGINE)
    assert ([list(o) for o in port.generate_all(later)]
            == [list(o) for o in fresh.generate_all(later)])
