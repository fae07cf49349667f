"""The replica pool over real engines (dlrover_tpu_torch/serving/
replica.py, handoff.py's HandoffCoordinator) against the JAX package,
on the tiny f32 Llama on the CPU.

Each scenario builds the same fleet in both packages — engines under
RequestSchedulers under InferenceReplicas in a ReplicaPool, driven by
round-robin pumps from the test thread, every clock injected — and
returns plain values: token streams, request states, routing choices,
counters, heartbeat documents.

- Routing: affinity-routed greedy streams and routes equal JAX's, and
  equal a lone engine's (routing changes where a request runs, never
  what it emits).
- Failover through the pool's FailoverManager: a greedy crash at a
  chaos step equals JAX's streams; a sampled crash continues the
  journaled generator state (the port's undisturbed run is the oracle;
  the draws are torch's); an int8-KV crash equals its replay oracle.
- Probation (breaker open, backoff, revive, restart, readmission) and
  probe isolation under an injected clock; heartbeats through a flaky
  KV; the registration document's keys and values (ts aside).
- Disaggregated serving through HandoffCoordinator: a prefill and a
  decode replica give the colocated streams (greedy also equal to
  JAX's), every decode admission is an adoption; a corrupted package is
  quarantined at the coordinator's ingress and replays; a crash at a
  fuzzed handoff step costs nothing.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.master import kv_store as jkv
from dlrover_tpu.models import llama as jllama
from dlrover_tpu.serving import chaos as jchaos
from dlrover_tpu.serving import engine as jeng
from dlrover_tpu.serving import failover as jfo
from dlrover_tpu.serving import handoff as jhandoff
from dlrover_tpu.serving import metrics as jmetrics
from dlrover_tpu.serving import replica as jrep
from dlrover_tpu.serving import scheduler as jsched
from dlrover_tpu_torch.master import kv_store as tkv
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.serving import chaos as tchaos
from dlrover_tpu_torch.serving import engine as teng
from dlrover_tpu_torch.serving import failover as tfo
from dlrover_tpu_torch.serving import handoff as thandoff
from dlrover_tpu_torch.serving import metrics as tmetrics
from dlrover_tpu_torch.serving import replica as trep
from dlrover_tpu_torch.serving import scheduler as tsched

ENGINE = dict(n_slots=2, max_len=64, max_new_tokens=8, chunk=2, pad_id=-1)


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
    make: object
    R: object
    S: object
    M: object
    F: object
    C: object
    KV: object
    H: object

    def engine(self, **kw):
        return self.make(**{**ENGINE, **kw})


@pytest.fixture(scope="module")
def sides(model):
    jcfg, jparams, tcfg, tparams = model
    return (
        Side(lambda **kw: jeng.ContinuousBatcher(jcfg, jparams, **kw),
             jrep, jsched, jmetrics, jfo, jchaos, jkv, jhandoff),
        Side(lambda **kw: teng.ContinuousBatcher(tcfg, tparams, device="cpu",
                                                 **kw),
             trep, tsched, tmetrics, tfo, tchaos, tkv, thandoff),
    )


def both(sides, scenario, *args):
    return tuple(scenario(side, *args) for side in sides)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=int(n)).tolist() for n in lengths]


def _fleet(side, tags, fi=None, engine_kw=None, per_engine=None,
           sched_kw=None, clock=None, **pool_kw):
    """A ReplicaPool over one engine per tag, schedulers not started
    (the test pumps them), every clock `clock` (default: frozen at 0)."""
    clock = clock or (lambda: 0.0)
    metrics = side.M.ServingMetrics()
    pool = side.R.ReplicaPool(metrics=metrics, clock=clock, **pool_kw)
    reps = []
    for tag in tags:
        kw = dict(engine_kw or {}, **(per_engine or {}).get(tag, {}))
        if fi is not None:
            kw.update(chaos=fi, chaos_tag=tag)
        sched = side.S.RequestScheduler(
            side.engine(**kw), side.S.SloConfig(default_deadline_s=600.0),
            metrics=metrics, clock=clock, **(sched_kw or {}))
        rep = side.R.InferenceReplica(tag, sched, chaos=fi)
        pool.add(rep)
        reps.append(rep)
    return pool, reps, metrics


def _drive(reps, max_iters=2000):
    for _ in range(max_iters):
        busy = False
        for r in reps:
            busy = r.scheduler.pump() or busy
        if not busy:
            return
    raise AssertionError("pool did not drain")


def _owner(reps, req):
    return next(r.id for r in reps if r.scheduler is req.scheduler)


def _lone(side, prompts, max_new, **kw):
    eng = side.engine(**kw)
    for p in prompts:
        eng.submit(p, max_new=max_new)
    return [[int(t) for t in o] for o in eng.generate_all([])]


# ---- routing ----------------------------------------------------------------


def _tenant_prompts(seed, n_tenants=2, per_tenant=3):
    """Each tenant shares a 12-token system prompt; tails stay shorter
    than the digest block (4), so the published prefix is the shared
    prompt (JAX tests/test_serving_affinity.py's shape)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_tenants):
        shared = rng.integers(1, 250, size=12).tolist()
        out.append([shared + rng.integers(1, 250, size=2).tolist()
                    for _ in range(per_tenant)])
    return out


def _routed(side, seed):
    """Wave 1: each tenant's first request; the health round advertises
    the published prefixes; wave 2: the tenants' repeat traffic."""
    kw = dict(prefix_cache_rows=4, prefix_block=4)
    pool, reps, metrics = _fleet(side, ["replica-0", "replica-1"],
                                 engine_kw=kw)
    tenants = _tenant_prompts(seed)
    waves = [[t[0] for t in tenants], [p for t in tenants for p in t[1:]]]
    reqs, routes = [], []
    for wave in waves:
        for p in wave:
            req = pool.submit(p, max_new=6)
            reqs.append((p, req))
            routes.append(_owner(reps, req))
        _drive(reps)
        pool.check_replicas()
    pool.stop()
    return dict(
        tokens=[list(map(int, r.tokens)) for _, r in reqs],
        prompts=[p for p, _ in reqs],
        states=[r.state.value for _, r in reqs], routes=routes,
        matched=metrics.affinity_matched,
        hits=[r.scheduler.engine.prefix_cache.hits for r in reps],
        map_stats=pool.routing_stats())


def test_routed_streams_and_routes_equal_jax(sides):
    j, t = both(sides, _routed, 5)
    assert t == j
    assert all(s == "done" for s in t["states"])
    # affinity concentrated the repeat traffic on the warm replicas
    assert t["matched"] == 4 and sum(t["hits"]) >= 4
    assert t["tokens"] == _lone(sides[1], t["prompts"], 6,
                                prefix_cache_rows=4, prefix_block=4)


# ---- failover through the pool ------------------------------------------------


def _crash(side, prompts, fuzz_seed, engine_kw, seeds=(7, 99),
           at_step=None):
    fi = side.C.FaultInjector(seed=fuzz_seed)
    if at_step is None:
        step = fi.crash_replica("replica-0", between=(1, 6))
    else:
        step = fi.crash_replica("replica-0", at_step=at_step)
    crashes = []
    pool, reps, metrics = _fleet(
        side, ["replica-0", "replica-1"], fi=fi, engine_kw=engine_kw,
        per_engine={"replica-0": {"seed": seeds[0]},
                    "replica-1": {"seed": seeds[1]}})
    manager = reps[0].scheduler.on_failure

    def record(sched, tickets, exc):
        crashes.extend((t.req.id, list(map(int, t.prompt)), t.remaining_new)
                       for t in tickets)
        manager(sched, tickets, exc)

    reps[0].scheduler.on_failure = record
    reqs = [reps[0].scheduler.submit(p, deadline_s=600.0) for p in prompts]
    _drive(reps)
    pool.check_replicas()  # the victim's probes fail: breaker opens
    assert fi.fired
    out = dict(step=step, crashes=crashes,
               reqs=[(r.state.value, list(map(int, r.tokens)), r.retries)
                     for r in reqs],
               failed=metrics.failed_total, failovers=metrics.failovers_total,
               healthy=[r.healthy for r in reps],
               breaker=pool.breakers["replica-0"].state)
    pool.stop()
    return out


@pytest.mark.parametrize("case", ["greedy", "sampled", "int8_kv"])
def test_crash_failover_through_the_pool(sides, case):
    prompts = _prompts((5, 9, 3, 7), seed=4)
    kw = {"greedy": {}, "sampled": dict(temperature=0.9, top_k=20,
                                        n_slots=1),
          "int8_kv": dict(kv_quant=True)}[case]
    port = sides[1]
    if case == "sampled":
        # one request, caught mid-decode: its journaled generator state
        # is all that can give the victim's stream on the survivor
        prompts = prompts[:1]
        t = _crash(port, prompts, 1, kw, at_step=2)
    else:
        t = _crash(port, prompts, 1, kw)
    assert all(state == "done" for state, _, _ in t["reqs"])
    assert t["failed"] == 0 and t["failovers"] >= 1
    assert t["healthy"] == [False, True] and t["breaker"] == tfo.OPEN
    tokens = [tok for _, tok, _ in t["reqs"]]
    if case == "greedy":
        assert t == _crash(sides[0], prompts, 1, kw)
        assert tokens == _lone(port, prompts, 8)
    elif case == "sampled":
        # every request continues the victim's streams from its
        # journaled generator state on the other-seeded survivor
        assert tokens == _lone(port, prompts, 8, seed=7, **kw)
        assert tokens != _lone(port, prompts, 8, seed=99, **kw)
    else:
        uncrashed = _lone(port, prompts, 8, **kw)
        caught = {rid: (replay, rem) for rid, replay, rem in t["crashes"]}
        for rid, got in enumerate(tokens):
            replay, rem = caught.get(rid, (prompts[rid], None))
            if len(replay) == len(prompts[rid]):
                assert got == uncrashed[rid]
                continue
            emitted = replay[len(prompts[rid]):]
            assert got == emitted + _lone(port, [replay], rem, **kw)[0]


def _probation(side):
    t = [0.0]
    fi = side.C.FaultInjector()
    fi.crash_replica("replica-0", at_step=2)
    pool, reps, metrics = _fleet(side, ["replica-0", "replica-1"], fi=fi,
                                 clock=lambda: t[0])
    prompts = _prompts((5, 9), seed=6)
    reqs = [reps[0].scheduler.submit(p, deadline_s=600.0) for p in prompts]
    _drive(reps)
    out = [[list(map(int, r.tokens)) for r in reqs], reps[0].healthy,
           pool.breakers["replica-0"].state]
    pool.check_replicas()         # probation probe fails: backoff grows
    t[0] += 0.01
    pool.check_replicas()         # inside the backoff: no probe
    out += [reps[0].healthy, pool.breakers["replica-0"].state]
    fi.revive("replica-0")
    t[0] += 60.0
    pool.check_replicas()         # clean probe: restart, readmit
    out += [reps[0].healthy, reps[0].scheduler.crashed,
            metrics.replica_readmissions]
    req = reps[0].scheduler.submit(prompts[0], deadline_s=600.0)
    while reps[0].scheduler.pump():
        pass
    out.append(list(map(int, req.tokens)))
    pool.stop()
    return out


def _probe_isolation(side):
    pool, reps, _ = _fleet(side, ["replica-0", "replica-1"],
                           fi=side.C.FaultInjector())
    store = side.KV.KVStoreService()
    reps[1].kv = store
    boom = {"n": 0}

    def bad_probe():
        boom["n"] += 1
        raise RuntimeError("probe exploded")

    reps[0].probe = bad_probe
    pool.check_replicas()
    out = [json.loads(store.get(reps[1].kv_key))["id"], reps[0].healthy]
    pool.check_replicas()
    out += [boom["n"], reps[0].healthy, reps[1].healthy]
    pool.stop()
    return out


def test_probation_cycle_equal_jax(sides):
    j, t = both(sides, _probation)
    assert t == j
    want = _lone(sides[1], _prompts((5, 9), seed=6), 8)
    assert t[0] == want and t[1:3] == [False, tfo.OPEN]
    assert t[3:5] == [False, tfo.OPEN]
    assert t[5:8] == [True, False, 1] and t[8] == want[0]


def test_probe_isolation_equal_jax(sides):
    j, t = both(sides, _probe_isolation)
    assert t == j == ["replica-1", True, 2, False, True]


def _registration(side):
    kv = side.KV.KVStoreService()
    pool, reps, _ = _fleet(side, ["replica-0"], kv=kv,
                           engine_kw=dict(prefix_cache_rows=4,
                                          prefix_block=4))
    first = json.loads(kv.get(side.R.REPLICA_KEY_PREFIX + "replica-0"))
    reps[0].scheduler.submit(_prompts((13,), seed=2)[0], max_new=3)
    _drive(reps)
    pool.check_replicas()
    beat = json.loads(kv.get(reps[0].kv_key))
    # a flaky master: retried through, then exhausted and swallowed
    fi = side.C.FaultInjector()
    store = side.KV.KVStoreService()
    rep = side.R.InferenceReplica(
        "rep", reps[0].scheduler, kv=side.C.ChaosKV(store, fi, tag="kv"),
        kv_retries=3, kv_backoff_s=0.0)
    fi.flaky_kv("kv", fail_next=2)
    rep.heartbeat()
    flaky = json.loads(store.get(rep.kv_key))["id"]
    store.delete(rep.kv_key)
    fi.flaky_kv("kv", fail_next=50)
    rep.heartbeat()
    pool.stop()
    # wall-clock values: the heartbeat's ts and the step-latency EWMA
    masked = [{k: (v > 0 if k == "step_latency_s" else v)
               for k, v in d.items() if k != "ts"} for d in (first, beat)]
    return masked, flaky, store.get(rep.kv_key)


def test_registration_and_heartbeat_equal_jax(sides):
    j, t = both(sides, _registration)
    assert t == j
    (first, beat), flaky, swallowed = t
    assert first["prefix_digests"] == [] and len(beat["prefix_digests"]) == 1
    assert first["step_latency_s"] is False and beat["step_latency_s"] is True
    assert beat["mesh_shape"] == {"tp": 1} and beat["role"] == "colocated"
    assert flaky == "rep" and swallowed == b""


# ---- disaggregated serving through the coordinator ---------------------------


def _disagg(side, prompts, kw, transport, disagg, fi=None,
            monkeypatch=None):
    """A colocated pool, or a prefill + decode pair (the decode engine
    seeded 99 against the prefill's 7: sampled parity then shows the
    request's generator rides the package)."""
    tags = ["prefill", "decode"] if disagg else ["colocated"]
    per = {tag: dict(replica_role=tag, seed=99 if tag == "decode" else 7)
           for tag in tags}
    engine_kw = dict(kw, n_slots=3)
    if fi is not None:
        engine_kw["kv_checksums"] = 1
        for tag in tags:
            per[tag].update(chaos=fi, chaos_tag=f"ho-{tag}")
    pool, reps, metrics = _fleet(side, tags, engine_kw=engine_kw,
                                 per_engine=per,
                                 sched_kw={"handoff_transport": transport})
    adoptions = []
    if monkeypatch is not None and disagg:
        real = side.H.adopt_into_slot

        def counted(engine, slot, pkg):
            adoptions.append(engine.replica_role)
            return real(engine, slot, pkg)

        monkeypatch.setattr(side.H, "adopt_into_slot", counted)
    reqs = [pool.submit(p, max_new=6) for p in prompts]
    _drive(reps)
    out = dict(tokens=[list(map(int, r.tokens)) for r in reqs],
               states=[r.state.value for r in reqs],
               handoffs=dict(metrics.handoff_total),
               health=[r.scheduler.engine.health_stats() for r in reps],
               admissions=[getattr(r.scheduler.engine, "admissions", None)
                           for r in reps],
               adoptions=adoptions)
    if kw.get("kv_layout") == "paged":
        for r in reps:
            r.scheduler.engine.allocator.check()
        out["used_pages"] = [r.scheduler.engine.allocator.used_pages
                             for r in reps]
        out["adopted"] = [r.scheduler.engine.allocator.pages_adopted
                          for r in reps]
    pool.stop()
    return out


DISAGG = {
    "dense-greedy-device": (dict(), "device", False),
    "paged-greedy-device": (dict(kv_layout="paged"), "device", True),
    "paged-sampled-host-checksums": (
        dict(kv_layout="paged", temperature=0.9, top_k=20, kv_checksums=1),
        "host", False),
}


@pytest.mark.parametrize("case", sorted(DISAGG))
def test_disaggregated_through_the_coordinator(sides, monkeypatch, case):
    kw, transport, vs_jax = DISAGG[case]
    prompts = _prompts((4, 9, 15, 6), seed=3)
    port = sides[1]
    colo = _disagg(port, prompts, kw, transport, False)
    dis = _disagg(port, prompts, kw, transport, True,
                  monkeypatch=monkeypatch)
    assert all(s == "done" for s in colo["states"] + dis["states"])
    assert dis["tokens"] == colo["tokens"]
    assert dis["handoffs"][transport] == len(prompts)
    # the decode engine admitted nothing but adoptions
    assert dis["adoptions"] == ["decode"] * len(prompts)
    assert dis["admissions"][1] == len(prompts)
    if kw.get("kv_checksums"):
        assert dis["health"][1]["integrity_checks"] == len(prompts)
    if kw.get("kv_layout") == "paged":
        assert dis["used_pages"] == [0, 0] and dis["adopted"][1] > 0
    if vs_jax:
        j = _disagg(sides[0], prompts, kw, transport, True)
        assert dis["tokens"] == j["tokens"]
        assert (dis["states"], dis["handoffs"]) == (j["states"], j["handoffs"])
        if "adopted" in j:
            assert dis["adopted"] == j["adopted"]


@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "sampled"])
def test_corrupt_package_quarantined_then_replayed(sides, temperature):
    prompts = _prompts((7, 11, 5, 9), seed=3)
    kw = dict(kv_layout="paged", temperature=temperature, top_k=20)

    def run(side, corrupt):
        fi = side.C.FaultInjector(seed=0)
        if corrupt:
            fi.corrupt_kv("ho-prefill", where="handoff", at_step=0)
        out = _disagg(side, prompts, kw, "host", True, fi=fi)
        out["fired"] = [f[0] for f in fi.fired]
        return out

    port = sides[1]
    clean, bad = run(port, False), run(port, True)
    assert bad["states"] == ["done"] * 4 and bad["tokens"] == clean["tokens"]
    pre, dec = bad["health"]
    assert pre["integrity_quarantines"] == 1 and "corrupt" in bad["fired"]
    # the corrupted package never reached the decode engine
    assert dec["integrity_quarantines"] == 0 and dec["integrity_checks"] == 4
    assert bad["used_pages"] == [0, 0]
    if temperature == 0.0:
        j = run(sides[0], True)
        assert bad["tokens"] == j["tokens"] and bad["health"] == j["health"]


def _handoff_chaos(side, chaos_seed):
    fi = side.C.FaultInjector(seed=chaos_seed)
    step = fi.fail_engine_step("handoff", between=(0, 4))
    pool, reps, _ = _fleet(
        side, ["prefill", "decode"], engine_kw=dict(kv_layout="paged",
                                                    n_slots=3),
        per_engine={"prefill": {"replica_role": "prefill"},
                    "decode": {"replica_role": "decode"}})
    pool.handoff.chaos = fi
    fuzz = np.random.default_rng(chaos_seed)
    prompts = _prompts(fuzz.integers(3, 20, size=5), seed=100 + chaos_seed)
    reqs = [pool.submit(p, max_new=6) for p in prompts]
    _drive(reps)
    for r in reps:
        r.scheduler.engine.allocator.check()
    out = dict(step=step, fired=bool(fi.fired),
               states=[r.state.value for r in reqs],
               tokens=[list(map(int, r.tokens)) for r in reqs],
               retries=[r.retries for r in reqs],
               used=[r.scheduler.engine.allocator.used_pages for r in reps])
    pool.stop()
    return out, prompts


@pytest.mark.parametrize("chaos_seed", [0, 2])
def test_crash_at_fuzzed_handoff_step_equal_jax(sides, chaos_seed):
    (j, prompts), (t, _) = both(sides, _handoff_chaos, chaos_seed)
    assert t == j
    assert t["fired"] and t["states"] == ["done"] * len(prompts)
    assert sum(t["retries"]) == 1 and t["used"] == [0, 0]
    assert t["tokens"] == _lone(sides[1], prompts, 6, kv_layout="paged",
                                n_slots=3)
