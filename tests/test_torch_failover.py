"""The port's serving/failover.py (a copy of the JAX package's) and the
scheduler's crash path, against the JAX package, on the tiny f32 Llama.

- CircuitBreaker: the same sequence of failures, successes and clock
  moves gives the same states, probe answers and backoffs (JAX
  tests/test_serving_failover.py TestCircuitBreaker), the seeded jitter
  included.
- The scheduler-level crash path without a replica pool: a
  FaultInjector crashes an engine at a step; the crashing scheduler
  snapshots its journal into resume tickets and hands them to a
  FailoverManager over a two-replica stand-in pool, which re-admits
  them on the survivor. The tickets at the crash (replay prompts,
  budgets, order), every request's state and greedy stream, and the
  failover counters equal JAX's, and every stream equals the uncrashed
  run. With an int8 KV bank the port's crash run is held to the port's
  own runs, not to JAX's: a request caught mid-decode equals its
  emitted tokens plus a fresh engine's continuation of prompt + emitted
  (the replay prefills exact K/V where the decode attended dequantized
  cells), the others the uncrashed run. A sampled request resumes on
  a differently seeded engine from its journaled generator state and
  equals the uncrashed stream.
- Without a callback in-flight work fails; the retry budget fails a
  request that keeps crashing; a readmission past its deadline is shed;
  a lost chip at tp=1 crashes the replica; restart() serves again.
- Engine lifecycle (TestEngineLifecycle): cancel frees the slot and the
  prefix pin; reset rebuilds the device state.
- The same crash through the real ReplicaPool, which wires its own
  FailoverManager as each scheduler's on_failure: streams, tickets,
  counters and the health round's ejection equal JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.serving import chaos as jchaos
from dlrover_tpu.serving import engine as jeng
from dlrover_tpu.serving import failover as jfo
from dlrover_tpu.serving import metrics as jmetrics
from dlrover_tpu.serving import replica as jrep
from dlrover_tpu.serving import scheduler as jsched
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.serving import chaos as tchaos
from dlrover_tpu_torch.serving import engine as teng
from dlrover_tpu_torch.serving import failover as tfo
from dlrover_tpu_torch.serving import metrics as tmetrics
from dlrover_tpu_torch.serving import replica as trep
from dlrover_tpu_torch.serving import scheduler as tsched

ENGINE = dict(n_slots=2, max_len=64, max_new_tokens=8, chunk=2)


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


@dataclasses.dataclass
class Side:
    make: object       # engine factory
    S: object          # scheduler module
    M: object          # metrics module
    F: object          # failover module
    C: object          # chaos module

    def engine(self, **kw):
        return self.make(**{**ENGINE, **kw})


@pytest.fixture(scope="module")
def sides(model):
    jcfg, jparams, tcfg, tparams = model
    return (
        Side(lambda **kw: jeng.ContinuousBatcher(jcfg, jparams, **kw),
             jsched, jmetrics, jfo, jchaos),
        Side(lambda **kw: teng.ContinuousBatcher(tcfg, tparams, device="cpu",
                                                 **kw),
             tsched, tmetrics, tfo, tchaos),
    )


def both(sides, scenario, *args):
    return tuple(scenario(side, *args) for side in sides)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=n).tolist() for n in lengths]


# ---- the circuit breaker --------------------------------------------------


def _breaker(F):
    t = [0.0]
    trace = []

    def snap(b):
        trace.append((b.state, round(b.retry_in_s, 9)))

    b = F.CircuitBreaker(max_strikes=2, clock=lambda: t[0])
    b.record_failure()
    snap(b)
    trace.append(b.should_probe())
    b.record_failure()
    snap(b)
    trace.append(b.should_probe())
    snap(b)
    b = F.CircuitBreaker(max_strikes=1, backoff_base_s=1.0,
                         backoff_max_s=4.0, clock=lambda: t[0])
    for dt in (0.0, 1.0, 2.0, 4.0, 4.0):
        b.record_failure()
        snap(b)
        trace.append(b.should_probe())
        t[0] += dt
        trace.append(b.should_probe())
        snap(b)
    b.record_success()
    snap(b)
    b.record_failure()
    trace.append(b.should_probe())
    b = F.CircuitBreaker(max_strikes=1, backoff_base_s=1.0,
                         backoff_max_s=8.0, clock=lambda: t[0],
                         jitter_seed=3)
    for _ in range(5):
        b.record_failure()
        trace.append(b.should_probe())
        snap(b)
        t[0] += 10.0
        b.should_probe()
    b.trip()
    snap(b)
    return trace


def test_circuit_breaker_equal_jax():
    got, want = _breaker(tfo), _breaker(jfo)
    assert got == want
    assert (tfo.CLOSED, tfo.OPEN, tfo.HALF_OPEN) == (
        jfo.CLOSED, jfo.OPEN, jfo.HALF_OPEN)
    t = [0.0]
    b = tfo.CircuitBreaker(max_strikes=1, backoff_base_s=1.0,
                           backoff_max_s=4.0, clock=lambda: t[0])
    b.record_failure()
    assert b.should_probe()         # the first trip re-probes at once
    b.record_failure()
    assert not b.should_probe() and b.retry_in_s == pytest.approx(1.0)


def test_journal_keys_copy_and_pin():
    """The port's keys: a generator state is cloned, an int seed kept,
    JAX-style words copied; pinning keeps the first two as they are."""
    state = torch.Generator().manual_seed(3).get_state()
    c = tfo.copy_key(state)
    assert torch.equal(c, state) and c.data_ptr() != state.data_ptr()
    assert tfo.pin_key(c) is c
    assert tfo.copy_key(np.int64(7)) == 7 and tfo.pin_key(7) == 7
    words = np.asarray([0, 101], np.uint32)
    assert tfo.copy_key(words).tolist() == [0, 101]
    assert tfo.pin_key([0, 101]).dtype == np.uint32


# ---- the crash path -------------------------------------------------------


class _Rep:
    def __init__(self, rid, scheduler):
        self.id = rid
        self.scheduler = scheduler
        self.healthy = True

    def load(self):
        s = self.scheduler
        return s.pressure() + s.active_count() / max(1, s.engine.n_slots)


class _Pool:
    """The pool surface FailoverManager reads, without a ReplicaPool."""

    def __init__(self, side, metrics, reps, clock):
        self.metrics = metrics
        self._reps = reps
        self.breakers = {r.id: side.F.CircuitBreaker(clock=clock)
                         for r in reps}

    def replicas(self):
        return list(self._reps)


def _crash_pool(side, fi, engine_kw=None, max_retries=2, clock=None,
                n_replicas=2):
    """Two direct-driven schedulers, engines chaos-wired as
    replica-<i>, failover through FailoverManager; the crash tickets
    are recorded before the manager re-homes them."""
    metrics = side.M.ServingMetrics()
    kw = {} if clock is None else {"clock": clock}
    reps = []
    for i in range(n_replicas):
        tag = f"replica-{i}"
        eng = side.engine(chaos=fi, chaos_tag=tag, **(engine_kw or {}))
        reps.append(_Rep(tag, side.S.RequestScheduler(eng, metrics=metrics,
                                                      **kw)))
    pool = _Pool(side, metrics, reps, clock or (lambda: 0.0))
    fm = side.F.FailoverManager(pool, max_retries=max_retries)
    crashes = []

    def on_failure(sched, tickets, exc):
        crashes.append([(t.req.id, t.prompt.tolist(), t.remaining_new,
                         t.prng_key is not None) for t in tickets])
        fm.on_scheduler_failure(sched, tickets, exc)

    for r in reps:
        r.scheduler.on_failure = on_failure
    return pool, reps, metrics, crashes


def _drive(reps, max_iters=400):
    for _ in range(max_iters):
        busy = False
        for r in reps:
            busy = r.scheduler.pump() or busy
        if not busy:
            return
    raise AssertionError("pool did not drain")


def _crash_run(side, prompts, fuzz_seed, engine_kw=None):
    fi = side.C.FaultInjector(seed=fuzz_seed)
    step = fi.crash_replica("replica-0", between=(1, 8))
    pool, reps, metrics, crashes = _crash_pool(side, fi, engine_kw)
    reqs = [reps[0].scheduler.submit(p, deadline_s=600.0) for p in prompts]
    _drive(reps)
    assert fi.fired
    return dict(step=step, crashes=crashes,
                reqs=[(r.state.value, list(r.tokens), r.retries)
                      for r in reqs],
                failed=metrics.failed_total,
                failovers=metrics.failovers_total,
                ejections=metrics.replica_ejections,
                healthy=[r.healthy for r in reps],
                breakers=[pool.breakers[r.id].state for r in reps])


def _reference(side, prompts, engine_kw=None):
    eng = side.engine(**(engine_kw or {}))
    return [list(map(int, o)) for o in eng.generate_all(prompts)]


@pytest.mark.parametrize(
    "fuzz_seed,engine_kw",
    [(0, {}), (1, {}), (0, {"async_depth": 1}),
     (2, {"prefix_cache_rows": 4}), (3, {"spec_draft_len": 4})],
    ids=["plain-0", "plain-1", "async-0", "prefix-2", "spec-3"],
)
def test_greedy_crash_parity_equal_jax(sides, fuzz_seed, engine_kw):
    prompts = _prompts((5, 9, 3, 7), seed=fuzz_seed + 1)
    j, t = both(sides, _crash_run, prompts, fuzz_seed, engine_kw)
    assert t == j
    ref_kw = {k: v for k, v in engine_kw.items() if k != "async_depth"}
    want = _reference(sides[1], prompts, ref_kw)
    assert [tok for _, tok, _ in t["reqs"]] == want
    assert all(state == "done" for state, _, _ in t["reqs"])
    assert t["failed"] == 0 and t["failovers"] >= 1
    assert t["ejections"] == 1 and t["healthy"] == [False, True]
    assert t["breakers"][0] == tfo.OPEN
    # one crash; each ticket's replay prompt is its request's prompt
    # plus the tokens it had emitted, and its budget the rest
    assert len(t["crashes"]) == 1 and t["crashes"][0]
    for rid, replay, remaining, _ in t["crashes"][0]:
        emitted = len(replay) - len(prompts[rid])
        assert replay[:len(prompts[rid])] == prompts[rid]
        assert replay[len(prompts[rid]):] == want[rid][:emitted]
        assert remaining == 8 - emitted


@pytest.mark.parametrize("fuzz_seed", [1, 2])
def test_int8_kv_crash_replay_against_the_ports_own_runs(sides, fuzz_seed):
    """int8 KV, held to the port's own runs only. A replay prefills the
    emitted tokens with exact K/V where the uncrashed decode attended
    their dequantized cells (as in JAX), so a request caught mid-decode
    resumes as the replay defines it: its emitted tokens, then a fresh
    int8-KV engine's continuation of prompt + emitted. A request the
    crash caught with nothing emitted equals the uncrashed run."""
    port = sides[1]
    kw = {"kv_quant": True}
    prompts = _prompts((5, 9, 3, 7), seed=fuzz_seed)
    got = _crash_run(port, prompts, fuzz_seed, kw)
    assert got["failed"] == 0 and got["failovers"] >= 1
    assert all(state == "done" for state, _, _ in got["reqs"])
    uncrashed = _reference(port, prompts, kw)
    caught = {rid: (replay, remaining)
              for rid, replay, remaining, _ in got["crashes"][0]}
    for rid, (_, tokens, _) in enumerate(got["reqs"]):
        if rid not in caught or len(caught[rid][0]) == len(prompts[rid]):
            assert tokens == uncrashed[rid]
            continue
        replay, remaining = caught[rid]
        emitted = replay[len(prompts[rid]):]
        eng = port.engine(**kw)
        eng.submit(replay, max_new=remaining)
        cont = [int(x) for x in eng.generate_all([])[0]]
        assert tokens == emitted + cont


def test_sampled_resume_continues_the_journaled_state(sides):
    """The crashed request resumes on an engine with ANOTHER seed from
    its journaled generator state: its stream equals an uncrashed run
    on the victim's seed, tokens from both replicas."""
    port = sides[1]
    prompt = _prompts((6,), seed=2)[0]
    sample = dict(temperature=0.9, top_k=20)
    want = _reference(port, [prompt], dict(n_slots=1, seed=7, **sample))[0]
    fi = tchaos.FaultInjector()
    fi.crash_replica("replica-0", at_step=2)
    metrics = tmetrics.ServingMetrics()
    reps = []
    for i, seed in enumerate((7, 99)):
        eng = port.engine(n_slots=1, seed=seed, chaos=fi,
                          chaos_tag=f"replica-{i}", **sample)
        reps.append(_Rep(f"replica-{i}",
                         tsched.RequestScheduler(eng, metrics=metrics)))
    pool = _Pool(port, metrics, reps, lambda: 0.0)
    fm = tfo.FailoverManager(pool)
    for r in reps:
        r.scheduler.on_failure = fm.on_scheduler_failure
    req = reps[0].scheduler.submit(prompt, deadline_s=600.0)
    _drive(reps)
    assert req.state is tsched.RequestState.DONE
    assert 0 < req.retries and metrics.failovers_total == 1
    assert req.tokens == want
    # a fresh run on the rescuer's own seed draws other tokens
    other = _reference(port, [prompt], dict(n_slots=1, seed=99, **sample))[0]
    assert other != want


def _retry_budget(side):
    fi = side.C.FaultInjector()
    fi.crash_replica("replica-0", at_step=1)
    fi.crash_replica("replica-1", at_step=1)
    _, reps, metrics, crashes = _crash_pool(side, fi, max_retries=1)
    req = reps[0].scheduler.submit(_prompts((5,), seed=3)[0],
                                   deadline_s=600.0)
    _drive(reps)
    return (req.state.value, req.retries, metrics.failed_total, crashes)


def _no_callback(side):
    fi = side.C.FaultInjector()
    fi.crash_replica("solo", at_step=1)
    metrics = side.M.ServingMetrics()
    s = side.S.RequestScheduler(side.engine(chaos=fi, chaos_tag="solo"),
                                metrics=metrics)
    req = s.submit(_prompts((5,), seed=3)[0], deadline_s=600.0)
    while s.pump():
        pass
    try:
        s.submit(_prompts((4,), seed=4)[0])
        after = "ok"
    except side.S.AdmissionError as e:
        after = e.reason
    out = (s.crashed, req.state.value, metrics.failed_total, after)
    # restart: the engine is rebuilt and serves again, as in the pool's
    # probation cycle
    fi.revive("solo")
    s.restart()
    again = s.submit(_prompts((5,), seed=3)[0], deadline_s=600.0)
    while s.pump():
        pass
    return out + (s.crashed, again.state.value, list(again.tokens))


def _readmit_expired(side):
    t = [0.0]
    fi = side.C.FaultInjector()
    fi.crash_replica("replica-0", at_step=1)
    _, reps, metrics, _ = _crash_pool(side, fi, clock=lambda: t[0])
    req = reps[0].scheduler.submit(_prompts((5,), seed=5)[0],
                                   deadline_s=10.0)
    reps[0].scheduler.pump()
    t[0] = 11.0
    reps[0].scheduler.pump()
    return (req.state.value, metrics.shed_total, metrics.failovers_total)


def _chip_lost(side):
    fi = side.C.FaultInjector()
    fi.lose_chip("solo", at_step=1)
    metrics = side.M.ServingMetrics()
    s = side.S.RequestScheduler(side.engine(chaos=fi, chaos_tag="solo"),
                                metrics=metrics)
    req = s.submit(_prompts((5,), seed=6)[0], deadline_s=600.0)
    while s.pump():
        pass
    return (s.crashed, req.state.value, metrics.failed_total,
            s.engine.surviving_chips())


@pytest.mark.parametrize(
    "scenario", [_retry_budget, _no_callback, _readmit_expired, _chip_lost],
    ids=["retry_budget", "no_callback_restart", "readmit_expired",
         "chip_lost_at_tp1"],
)
def test_crash_outcomes_equal_jax(sides, scenario):
    j, t = both(sides, scenario)
    assert t == j
    if scenario is _retry_budget:
        assert t[0] == "failed" and t[2] == 1
    elif scenario is _no_callback:
        assert t[:4] == (True, "failed", 1, "replica crashed, pending "
                         "restart")
        assert t[4:6] == (False, "done") and len(t[6]) == 8
    elif scenario is _readmit_expired:
        assert t == ("shed", 1, 0)


# ---- engine lifecycle (TestEngineLifecycle) -------------------------------


def _lifecycle(side):
    eng = side.engine(n_slots=1, prefix_cache_rows=4)
    prompts = _prompts((20, 5), seed=7)
    a = eng.submit(prompts[0])
    b = eng.submit(prompts[1])
    eng.step()
    active = eng.active_count()
    eng.cancel(a)
    eng.cancel(b)
    freed = (eng.active_count(), eng.has_work(), eng._slot_row[0])
    c = eng.submit(prompts[1])
    while eng.has_work():
        eng.step()
    served = list(map(int, eng.retire(c)))
    eng2 = side.engine(prefix_cache_rows=4)
    ps = _prompts((5, 9), seed=8)
    eng2.submit(ps[0])
    eng2.step()
    eng2.reset()
    reset = (eng2.has_work(), eng2.active_count())
    got = [list(map(int, o)) for o in eng2.generate_all(ps)]
    want = _reference(side, ps, {"prefix_cache_rows": 4})
    return dict(active=active, freed=freed, served=served, reset=reset,
                got=got, want=want)


def test_engine_lifecycle_equal_jax(sides):
    j, t = both(sides, _lifecycle)
    assert t == j
    assert t["active"] == 1 and t["freed"] == (0, False, None)
    assert len(t["served"]) > 0
    assert t["reset"] == (False, 0) and t["got"] == t["want"]


def test_handoff_carries_a_journaled_state(sides):
    """A request submitted with a journaled generator state (a resumed
    sampled request) and prefilled on a prefill-role engine ships that
    state in its package: the decode engine continues the same stream a
    colocated engine submitted with the state draws."""
    from dlrover_tpu_torch.serving import handoff as thandoff

    port = sides[1]
    sample = dict(temperature=0.9, top_k=20, kv_layout="paged")
    state = torch.Generator().manual_seed(1234).get_state()
    prompt = _prompts((7,), seed=9)[0]
    colo = port.engine(seed=1, **sample)
    colo.submit(prompt, max_new=6, prng_key=state)
    want = [int(t) for t in colo.generate_all([])[0]]
    pre = port.engine(seed=2, replica_role="prefill", **sample)
    dec = port.engine(seed=3, replica_role="decode", **sample)
    pre.submit(prompt, max_new=6, prng_key=state)
    pre.step()
    (req,) = pre.take_prefilled()
    pkg = thandoff.export_run(pre, req.idx)
    pre.retire(req.idx)
    assert torch.equal(pkg.prng_key, state)
    dec.submit_adopted(pkg)
    assert [int(t) for t in dec.generate_all([])[0]] == want


# ---- the crash through the real replica pool ------------------------------


def _real_pool_crash(side, prompts, fuzz_seed):
    """replica-0 crashes at a fuzzed step under everything submitted to
    it; the ReplicaPool's own FailoverManager re-homes the tickets on
    replica-1, and the next health round ejects the victim."""
    R = {jsched: jrep, tsched: trep}[side.S]
    fi = side.C.FaultInjector(seed=fuzz_seed)
    step = fi.crash_replica("replica-0", between=(1, 8))
    metrics = side.M.ServingMetrics()
    pool = R.ReplicaPool(metrics=metrics, clock=lambda: 0.0, max_strikes=1)
    reps = []
    for i in range(2):
        tag = f"replica-{i}"
        sched = side.S.RequestScheduler(
            side.engine(chaos=fi, chaos_tag=tag), metrics=metrics,
            clock=lambda: 0.0)
        rep = R.InferenceReplica(tag, sched, chaos=fi)
        pool.add(rep)
        reps.append(rep)
    wired = [r.scheduler.on_failure == pool.manager.on_scheduler_failure
             for r in reps]
    reqs = [reps[0].scheduler.submit(p, deadline_s=600.0) for p in prompts]
    _drive(reps)
    pool.check_replicas()
    out = dict(step=step, fired=bool(fi.fired), wired=wired,
               reqs=[(r.state.value, list(r.tokens), r.retries)
                     for r in reqs],
               failed=metrics.failed_total, failovers=metrics.failovers_total,
               ejections=metrics.replica_ejections,
               healthy=[r.healthy for r in reps],
               breakers=[pool.breakers[r.id].state for r in reps],
               routable=[r.id for r in pool.ranked_replicas()])
    pool.stop()
    return out


@pytest.mark.parametrize("fuzz_seed", [0, 3])
def test_crash_through_the_replica_pool_equal_jax(sides, fuzz_seed):
    prompts = _prompts((5, 9, 3, 7), seed=fuzz_seed + 1)
    j, t = both(sides, _real_pool_crash, prompts, fuzz_seed)
    assert t == j
    assert t["fired"] and t["wired"] == [True, True]
    assert [tok for _, tok, _ in t["reqs"]] == _reference(sides[1], prompts)
    assert all(state == "done" for state, _, _ in t["reqs"])
    assert t["failed"] == 0 and t["failovers"] >= 1
    assert t["healthy"] == [False, True] and t["routable"] == ["replica-1"]
    assert t["breakers"] == [tfo.OPEN, tfo.CLOSED]
