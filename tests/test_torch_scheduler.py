"""The port's RequestScheduler (dlrover_tpu_torch/serving/scheduler.py,
a copy of the JAX package's) over the port's engine, against the JAX
scheduler over the JAX engine, on the tiny f32 Llama carried across.

Every case of JAX tests/test_serving_scheduler.py and of
tests/test_serving_tiers.py's TestStrictPriority, TestAgingEscalator,
TestPreemption, TestPreemptResumeParity and TestTierMetrics runs as one
scenario on both sides: the same prompts, the same SloConfig and a fake
clock each side advances alike (one tick per pump). A scenario returns
its integer outcome: the order in which requests reached the engine,
their states, tokens, preemptions and effective tiers, the finish
order, the rejection and shed messages and counters, and the rendered
metrics (wall-time values masked). The port's outcome must equal JAX's,
and the JAX test's own assertions are checked on it.

Sampled runs draw torch's bits, not jax.random's: there the port's
streams are held to the port's own undisturbed run under the same
pinned keys (the preempted request resumes from its journaled generator
state), and only the integer outcomes but the tokens are held to
JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.serving import engine as jeng
from dlrover_tpu.serving import metrics as jmetrics
from dlrover_tpu.serving import scheduler as jsched
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.serving import engine as teng
from dlrover_tpu_torch.serving import metrics as tmetrics
from dlrover_tpu_torch.serving import scheduler as tsched

ENGINE = dict(n_slots=2, max_len=64, max_new_tokens=8, chunk=4, pad_id=-1)
TICK = 0.001
# rendered values read from the wall clock (perf_counter / monotonic)
WALL = ("serving_tokens_per_sec", "serving_step_host_ms",
        "serving_step_device_wait_ms", "serving_step_overlap_ratio",
        "serving_admission_stall_ms")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
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


class Side:
    """One package: its engine over the shared weights, its scheduler
    module, its metrics, and a fake clock."""

    def __init__(self, name, make, sched_mod, metrics_mod):
        self.name = name
        self._make = make
        self.S = sched_mod
        self.M = metrics_mod
        self.now = [0.0]

    def engine(self, **kw):
        return self._make(**{**ENGINE, **kw})

    def sched(self, engine, slo=None, metrics=None, **kw):
        """A scheduler on this side's fake clock. Its engine's submit is
        logged (prompt length and head) to give the dispatch order."""
        engine._order = []
        submit = engine.submit

        def logged(prompt, *a, **k):
            engine._order.append((len(prompt), int(prompt[0])))
            return submit(prompt, *a, **k)

        engine.submit = logged
        return self.S.RequestScheduler(
            engine, slo or self.S.SloConfig(),
            metrics=metrics or self.M.ServingMetrics(),
            clock=lambda: self.now[0], **kw)

    def drain(self, sched, limit=10_000):
        """pump() until idle, one clock tick a pump; returns the pumps."""
        for n in range(limit):
            busy = sched.pump()
            self.now[0] += TICK
            if not busy:
                return n + 1
        raise AssertionError("scheduler did not drain")


@pytest.fixture(scope="module")
def sides(model):
    jcfg, jparams, tcfg, tparams = model
    return (
        lambda: Side("jax", lambda **kw: jeng.ContinuousBatcher(
            jcfg, jparams, **kw), jsched, jmetrics),
        lambda: Side("port", lambda **kw: teng.ContinuousBatcher(
            tcfg, tparams, device="cpu", **kw), tsched, tmetrics),
    )


def both(sides, scenario, *args):
    """(jax outcome, port outcome) of one scenario, fresh sides each."""
    return tuple(scenario(make(), *args) for make in sides)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=n).tolist() for n in lengths]


def _req(r):
    return dict(state=r.state.value, tokens=list(r.tokens),
                preemptions=r.preemptions, tier=r.tier,
                effective_tier=r.effective_tier,
                ttft=(None if r.first_token_ts is None
                      else round(r.first_token_ts - r.submit_ts, 9)),
                finish=(None if r.finish_ts is None
                        else round(r.finish_ts, 9)))


def _finish_order(reqs):
    done = [(r.finish_ts, i) for i, r in enumerate(reqs)
            if r.finish_ts is not None]
    return [i for _, i in sorted(done)]


def _mask(text):
    out = []
    for ln in text.splitlines():
        if ln.startswith("# HELP "):
            ln = " ".join(ln.split()[:3])
        elif ln.startswith(WALL):
            ln = ln.rsplit(" ", 1)[0]
        out.append(ln)
    return out


def _outcome(side, sched, reqs, **extra):
    m = sched.metrics
    return dict(
        reqs=[_req(r) for r in reqs],
        finish_order=_finish_order(reqs),
        dispatch=list(sched.engine._order),
        counters=dict(requests=m.requests_total, completed=m.completed_total,
                      rejected=m.rejected_total, shed=m.shed_total,
                      tokens=m.tokens_total,
                      preempted=m.tier_preempted_total,
                      escalated=m.tier_escalated_total,
                      tier_shed=m.tier_shed_total,
                      admitted=m.tier_admitted_total),
        render=_mask(m.render()),
        **extra,
    )


# ---- the engine's step API (TestEngineStepApi) --------------------------


def _step_api(side):
    prompts = _prompts((5, 12, 3, 20, 9), seed=1)
    eng = side.engine()
    ids = [eng.submit(p) for p in prompts]
    streamed = {i: [] for i in ids}
    while eng.has_work():
        for idx, toks, _done in eng.step():
            streamed[idx].extend(toks)
    retired = [list(map(int, eng.retire(i))) for i in ids]
    ledger = (len(eng._requests), len(eng._pending))
    eng2 = side.engine()
    i = eng2.submit(_prompts((5,), seed=3)[0], max_new=3)
    while eng2.has_work():
        eng2.step()
    first = list(map(int, eng2.retire(i)))
    later = [list(map(int, o)) for o in
             eng2.generate_all([_prompts((7,), seed=4)[0]])]
    return dict(streamed=[streamed[i] for i in ids], retired=retired,
                ledger=ledger, first=first, later=later)


def test_step_deltas_and_retire_equal_jax(sides):
    j, t = both(sides, _step_api)
    assert t == j
    assert t["streamed"] == t["retired"]
    assert t["ledger"] == (0, 0)
    assert len(t["later"]) == 1 and len(t["later"][0]) == 8


# ---- admission (TestAdmission, TestStrictPriority's rejections) ---------


def _rejections(side):
    S = side.S
    out = []

    def attempt(sched, *a, **k):
        try:
            sched.submit(*a, **k)
            out.append("ok")
        except S.AdmissionError as e:
            out.append(e.reason)
        out.append(sched.metrics.rejected_total)

    p = _prompts((4,), seed=5)[0]
    s = side.sched(side.engine(), S.SloConfig(max_queue_depth=2,
                                              max_new_tokens=8))
    for _ in range(3):
        attempt(s, p)
    s = side.sched(side.engine(max_new_tokens=32),
                   S.SloConfig(max_new_tokens=8))
    attempt(s, _prompts((4,), seed=6)[0], max_new=9)
    s = side.sched(side.engine(max_len=16))
    attempt(s, list(range(1, 17)))
    attempt(s, [])
    s = side.sched(side.engine())
    attempt(s, _prompts((4,), seed=2)[0], tier="gold")
    attempt(s, p, adapter_id="nope")
    s = side.sched(side.engine(), S.SloConfig(tier_budgets={"batch": 1}))
    for tier in ("batch", "batch", "standard"):
        attempt(s, _prompts((4,), seed=3)[0], tier=tier)
    s = side.sched(side.engine())
    for tier in ("latency", "latency", "batch"):
        s.submit(p, tier=tier)
    out.append(s.tier_queue_depths())
    out.append((s.queue_depth(), s.active_count(), s.pressure(),
                s.has_work()))
    return out


def test_admission_rejections_equal_jax(sides):
    j, t = both(sides, _rejections)
    assert t == j
    assert tsched.TIERS == jsched.TIERS == ("latency", "standard", "batch")
    assert [x for x in t if isinstance(x, str) and x != "ok"][:3] == [
        "queue full (2 waiting)", "token budget: max_new 9 > 8",
        "prompt length 16 leaves no room to generate (max_len 16)"]
    assert t[-2] == {"latency": 2, "standard": 0, "batch": 1}


# ---- shedding and order (TestSheddingAndOrder) --------------------------


def _shedding(side):
    S = side.S
    out = {}
    s = side.sched(side.engine(), S.SloConfig(default_deadline_s=10.0))
    req = s.submit(_prompts((4,), seed=7)[0], deadline_s=5.0)
    side.now[0] += 6.0
    side.drain(s)
    out["expired"] = _outcome(side, s, [req],
                              stream=list(req.iter_stream(timeout=1.0)),
                              waited=req.wait(timeout=1.0))
    s = side.sched(side.engine(n_slots=1, chunk=2))
    req = s.submit(_prompts((4,), seed=8)[0], max_new=6, deadline_s=5.0)
    assert s.pump()
    side.now[0] += 100.0
    side.drain(s)
    out["running"] = _outcome(side, s, [req])
    s = side.sched(side.engine(n_slots=1))
    relaxed = s.submit(_prompts((4,), seed=9)[0], max_new=2,
                       deadline_s=500.0)
    urgent = s.submit(_prompts((5,), seed=10)[0], max_new=2, deadline_s=5.0)
    side.drain(s)
    out["edf"] = _outcome(side, s, [relaxed, urgent])
    s = side.sched(side.engine(n_slots=1))
    long_req = s.submit(_prompts((20,), seed=12)[0], max_new=2,
                        deadline_s=500.0)
    short_req = s.submit(_prompts((4,), seed=13)[0], max_new=2,
                         deadline_s=500.0)
    heap = [len(item[-1].prompt) for item in sorted(s._waiting["standard"])]
    side.drain(s)
    out["tie"] = _outcome(side, s, [long_req, short_req], heap=heap)
    return out


def test_shedding_and_edf_order_equal_jax(sides):
    j, t = both(sides, _shedding)
    assert t == j
    e = t["expired"]
    assert e["reqs"][0]["state"] == "shed" and e["stream"] == []
    assert e["counters"]["shed"] == 1 and e["waited"]
    r = t["running"]
    assert r["reqs"][0]["state"] == "done"
    assert len(r["reqs"][0]["tokens"]) == 6 and r["counters"]["shed"] == 0
    assert t["edf"]["finish_order"] == [1, 0]
    assert t["tie"]["heap"] == [4, 20]
    assert t["tie"]["finish_order"] == [1, 0]


def _parity(side):
    prompts = _prompts((5, 12, 3, 20, 9, 7, 15), seed=11)
    s = side.sched(side.engine(n_slots=3))
    reqs = [s.submit(p, max_new=8) for p in prompts]
    side.drain(s)
    return _outcome(side, s, reqs)


def test_scheduler_parity_with_jax(sides):
    """Admission + EDF + slot re-admission: every stream, the dispatch
    order and the rendered metrics equal JAX's."""
    j, t = both(sides, _parity)
    assert t == j
    assert all(r["state"] == "done" and len(r["tokens"]) == 8
               for r in t["reqs"])


def _counters(side):
    s = side.sched(side.engine())
    reqs = [s.submit(p, max_new=4) for p in _prompts((5, 9, 3), seed=12)]
    side.drain(s)
    return _outcome(side, s, reqs, text=s.metrics.render())


def test_counters_and_render_equal_jax(sides):
    j, t = both(sides, _counters)
    text = t.pop("text")
    j.pop("text")
    assert t == j
    assert t["counters"]["requests"] == t["counters"]["completed"] == 3
    assert t["counters"]["tokens"] == sum(len(r["tokens"]) for r in t["reqs"])
    for needle in (
        "# TYPE serving_ttft_ms summary",
        "# TYPE serving_tpot_ms summary",
        "# TYPE serving_queue_depth gauge",
        "serving_requests_total 3",
        'serving_ttft_ms{quantile="0.5"}',
        'serving_kernel_path_steps_total{path="reference"}',
        "serving_mesh_tp 1",
    ):
        assert needle in text, text


# ---- tiers (TestStrictPriority, TestAgingEscalator) ---------------------


def _priority(side):
    S = side.S
    s = side.sched(side.engine(n_slots=1), S.SloConfig(tier_aging_s=0.0))
    ps = _prompts((5, 6, 7), seed=1)
    reqs = [s.submit(ps[0], max_new=2, deadline_s=1000.0, tier="batch"),
            s.submit(ps[1], max_new=2, deadline_s=2000.0, tier="standard"),
            s.submit(ps[2], max_new=2, deadline_s=3000.0, tier="latency")]
    while s.pump():
        side.now[0] += 1.0
    return _outcome(side, s, reqs)


def test_priority_beats_edf_across_tiers_equal_jax(sides):
    j, t = both(sides, _priority)
    assert t == j
    assert t["finish_order"] == [2, 1, 0]
    assert all(r["state"] == "done" for r in t["reqs"])


def _starved(side, aging_s):
    S = side.S
    s = side.sched(side.engine(n_slots=1), S.SloConfig(tier_aging_s=aging_s))
    batch = s.submit(_prompts((5,), seed=5)[0], max_new=2, deadline_s=300.0,
                     tier="batch")
    reqs = [batch]
    lat = _prompts((4, 6), seed=6)
    for _ in range(12):
        for p in lat:
            reqs.append(s.submit(p, max_new=2, deadline_s=500.0,
                                 tier="latency"))
        s.pump()
        s.pump()
        side.now[0] += 2.0
        if batch.state is S.RequestState.DONE:
            break
    return _outcome(side, s, reqs)


@pytest.mark.parametrize("aging_s", [4.0, 0.0], ids=["aging", "no_aging"])
def test_aging_escalator_equal_jax(sides, aging_s):
    j, t = both(sides, _starved, aging_s)
    assert t == j
    batch = t["reqs"][0]
    if aging_s:
        assert batch["state"] == "done"
        assert batch["effective_tier"] == "latency"
        assert t["counters"]["escalated"]["batch"] >= 1
    else:
        assert batch["state"] == "queued"
        assert t["counters"]["escalated"]["batch"] == 0


# ---- admission preemption (TestPreemption) ------------------------------


def _preempt(side, first_tier, second_tier, seed):
    s = side.sched(side.engine(n_slots=1, chunk=2))
    ps = _prompts((6, 9) if seed == 7 else (5, 7), seed=seed)
    a = s.submit(ps[0], max_new=8, deadline_s=600.0, tier=first_tier)
    s.pump()
    running = a.state.value
    b = s.submit(ps[1], max_new=4 if seed == 7 else 2, deadline_s=600.0,
                 tier=second_tier)
    s.pump()
    mid = (a.preemptions, a.state.value, b.state.value,
           s.metrics.tier_preempted_total["batch"])
    side.drain(s)
    return _outcome(side, s, [a, b], running=running, mid=mid)


@pytest.mark.parametrize(
    "first_tier,second_tier,seed",
    [("batch", "latency", 7), ("batch", "standard", 8),
     ("standard", "latency", 9)],
    ids=["latency_preempts_batch", "standard_does_not_preempt",
         "no_batch_victim"],
)
def test_preemption_equal_jax(sides, first_tier, second_tier, seed):
    j, t = both(sides, _preempt, first_tier, second_tier, seed)
    assert t == j
    a, b = t["reqs"]
    assert t["running"] == "running"
    assert a["state"] == b["state"] == "done"
    if second_tier == "latency" and first_tier == "batch":
        assert t["mid"][0] == 1 and t["mid"][3] == 1
        assert a["preemptions"] == 1
        assert t["finish_order"] == [1, 0]
        # the victim replays its prompt with the tokens it emitted
        assert t["dispatch"][2][1] == t["dispatch"][0][1]
        assert t["dispatch"][2][0] > t["dispatch"][0][0]
    else:
        assert t["mid"] == (0, "running", "queued", 0)
        assert t["finish_order"] == [0, 1]


# ---- preempt-resume parity (TestPreemptResumeParity) --------------------

VARIANTS = [
    {},
    {"kv_layout": "paged"},
    {"temperature": 0.9, "top_k": 20, "seed": 5},
    {"kv_layout": "paged", "temperature": 0.9, "top_k": 20, "seed": 5},
    {"async_depth": 1},
    {"async_depth": 1, "temperature": 0.9, "top_k": 20, "seed": 5},
    {"async_depth": 1, "kv_layout": "paged"},
    {"async_depth": 1, "kv_layout": "paged", "temperature": 0.9,
     "top_k": 20, "seed": 5},
]
VARIANT_IDS = ["dense-greedy", "paged-greedy", "dense-sampled",
               "paged-sampled", "async-dense-greedy", "async-dense-sampled",
               "async-paged-greedy", "async-paged-sampled"]


def _keys(n):
    return [np.asarray(jax.random.PRNGKey(100 + i), np.uint32)
            for i in range(n)]


def _undisturbed(side, prompts, keys, engine_kw):
    """Every prompt to completion on one synchronous engine, same keys."""
    kw = {k: v for k, v in engine_kw.items() if k != "async_depth"}
    eng = side.engine(n_slots=len(prompts), **kw)
    ids = [eng.submit(p, max_new=8, prng_key=k)
           for p, k in zip(prompts, keys)]
    streamed = {i: [] for i in ids}
    while eng.has_work():
        for idx, toks, _done in eng.step():
            streamed[idx].extend(toks)
    return [streamed[i] for i in ids]


def _preempt_resume(side, fuzz_seed, engine_kw):
    rng = np.random.default_rng(fuzz_seed)
    prompts = _prompts((6, 9, 4, 7), seed=20 + fuzz_seed)
    keys = _keys(len(prompts))
    s = side.sched(side.engine(chunk=2, **engine_kw))
    tiers = ("batch", "batch", "latency", "standard")
    reqs = [s.submit(prompts[i], max_new=8, deadline_s=600.0,
                     tier=tiers[i], prng_key=keys[i]) for i in (0, 1)]
    for _ in range(int(rng.integers(1, 3))):
        s.pump()
    reqs += [s.submit(prompts[i], max_new=8, deadline_s=600.0,
                      tier=tiers[i], prng_key=keys[i]) for i in (2, 3)]
    side.drain(s)
    return _outcome(side, s, reqs), prompts, keys


@pytest.mark.parametrize("fuzz_seed", [0, 1])
@pytest.mark.parametrize("engine_kw", VARIANTS, ids=VARIANT_IDS)
def test_preempt_resume_parity_sweep(sides, fuzz_seed, engine_kw):
    (j, _, _), (t, prompts, keys) = both(sides, _preempt_resume, fuzz_seed,
                                         engine_kw)
    sampled = engine_kw.get("temperature", 0.0) > 0
    assert t["counters"]["preempted"]["batch"] >= 1
    assert sum(r["preemptions"] for r in t["reqs"][:2]) >= 1
    want = _undisturbed(sides[1](), prompts, keys, engine_kw)
    for r, w in zip(t["reqs"], want):
        assert r["state"] == "done"
        assert r["tokens"] == w
    if sampled:
        # torch's draws: hold the integer outcomes, not the tokens
        for side_out in (t, j):
            for r in side_out["reqs"]:
                r["tokens"] = len(r["tokens"])
            side_out["render"] = [ln for ln in side_out["render"]
                                  if not ln.startswith("serving_tokens_")]
    assert t == j


# ---- per-tier shed attribution (TestTierMetrics) ------------------------


def _shed_per_tier(side):
    s = side.sched(side.engine())
    ps = _prompts((4, 5), seed=10)
    b = s.submit(ps[0], deadline_s=5.0, tier="batch")
    lat = s.submit(ps[1], deadline_s=5.0, tier="latency")
    side.now[0] = 6.0
    side.drain(s)
    return _outcome(side, s, [b, lat])


def test_shed_attributed_per_tier_equal_jax(sides):
    j, t = both(sides, _shed_per_tier)
    assert t == j
    assert [r["state"] for r in t["reqs"]] == ["shed", "shed"]
    assert t["counters"]["tier_shed"] == {"latency": 1, "standard": 0,
                                          "batch": 1}
    assert t["counters"]["shed"] == 2


# ---- the phase-split hooks ----------------------------------------------


def _handoff_pair(side, wired):
    """A prefill-role and a decode-role engine, each behind its own
    scheduler. Wired, the prefill scheduler's on_handoff adopts every
    exported package on the decode scheduler (the coordinator's job);
    unwired, each handoff falls back to replay on the prefill replica
    until max_handoff_retries fails the request."""
    prompts = _prompts((5, 9, 3), seed=16)
    pre = side.sched(side.engine(kv_layout="paged",
                                 replica_role="prefill"))
    dec = side.sched(side.engine(kv_layout="paged", replica_role="decode"),
                     metrics=pre.metrics)
    if wired:
        pre.on_handoff = lambda sched, ticket, pkg: dec.adopt(
            ticket.req, ticket, pkg)
    reqs = [pre.submit(p, max_new=6) for p in prompts]
    for _ in range(200):
        busy = pre.pump()
        busy = dec.pump() or busy
        side.now[0] += TICK
        if not busy:
            break
    m = pre.metrics
    out = _outcome(side, pre, reqs, handoffs=m.handoff_total,
                   failed=m.failed_total,
                   retries=[r.retries for r in reqs],
                   decode_dispatch=list(dec.engine._order))
    # the coordinator call's wall time
    out["render"] = [ln for ln in out["render"]
                     if not ln.startswith("serving_handoff_latency_ms")]
    return out


@pytest.mark.parametrize("wired", [True, False], ids=["adopt", "no_coordinator"])
def test_handoff_hooks_equal_jax(sides, wired):
    j, t = both(sides, _handoff_pair, wired)
    assert t == j
    states = [r["state"] for r in t["reqs"]]
    if wired:
        assert states == ["done"] * 3
        assert t["handoffs"]["device"] == 3 and t["failed"] == 0
        want = [list(map(int, o)) for o in sides[1]().engine(
            kv_layout="paged").generate_all(_prompts((5, 9, 3), seed=16))]
        assert [r["tokens"][:6] for r in t["reqs"]] == [w[:6] for w in want]
    else:
        assert states == ["failed"] * 3 and t["failed"] == 3
        assert t["retries"] == [3, 3, 3]


# ---- the rest of the surface --------------------------------------------


def _cancel_and_telemetry(side):
    s = side.sched(side.engine(n_slots=1, chunk=2))
    ps = _prompts((5, 6, 7), seed=14)
    a = s.submit(ps[0], max_new=8, deadline_s=600.0)
    b = s.submit(ps[1], max_new=4, deadline_s=600.0)
    s.pump()
    tele = {k: v for k, v in s.telemetry().items() if k != "step_latency_s"}
    cancelled = (s.cancel(a), s.cancel(b), s.cancel(a))
    c = s.submit(ps[2], max_new=3, deadline_s=600.0)
    side.drain(s)
    return _outcome(side, s, [a, b, c], tele=tele, cancelled=cancelled,
                    cancelled_total=s.metrics.cancelled_total,
                    free=(s.engine.active_count(), s.engine.has_work()))


def test_cancel_and_telemetry_equal_jax(sides):
    j, t = both(sides, _cancel_and_telemetry)
    assert t == j
    assert t["cancelled"] == (True, True, False)
    assert [r["state"] for r in t["reqs"]] == ["cancelled", "cancelled",
                                               "done"]
    assert t["tele"]["n_chips"] == 1 and t["tele"]["active"] == 1
    assert t["free"] == (0, False)


def test_background_thread_serves_and_stops(model):
    """start() / stop(): the pump thread drains submitted work on its
    own (the gateway path) and joins on stop()."""
    _, _, tcfg, tparams = model
    eng = teng.ContinuousBatcher(tcfg, tparams, device="cpu", **ENGINE)
    s = tsched.RequestScheduler(eng, tsched.SloConfig())
    s.start()
    try:
        req = s.submit(_prompts((5,), seed=15)[0], max_new=4)
        assert req.wait(timeout=60.0)
        chunks = list(req.iter_stream(timeout=1.0))
    finally:
        s.stop()
    assert s._thread is None
    assert req.state is tsched.RequestState.DONE
    assert [t for c in chunks for t in c] == req.tokens
    assert len(req.tokens) == 4


def test_resize_and_refresh_under_the_lock(model):
    """resize_engine at one card is the tp=1 no-op report;
    refresh_weights commits through update_params."""
    _, _, tcfg, tparams = model
    eng = teng.ContinuousBatcher(tcfg, tparams, device="cpu",
                                 mesh_spec={"tp": 1}, **ENGINE)
    s = tsched.RequestScheduler(eng, tsched.SloConfig())
    rep = s.resize_engine()
    assert (rep.old_tp, rep.new_tp, rep.direction) == (1, 1, "noop")
    s.refresh_weights(tparams)
    assert eng.weight_version == 1


def test_public_names_are_the_jax_packages():
    """dlrover_tpu_torch.serving exports JAX's public serving names,
    limited to what the port has: the scheduler stack among them."""
    import dlrover_tpu.serving as jserving
    import dlrover_tpu_torch.serving as tserving

    assert set(tserving.__all__) <= set(jserving.__all__)
    for name in tserving.__all__:
        assert getattr(tserving, name) is not None, name
    for name in ("RequestScheduler", "ServingMetrics", "FailoverManager",
                 "generate_trace", "TIERS", "ContinuousBatcher"):
        assert name in tserving.__all__
    assert tserving.TIERS == jserving.TIERS
