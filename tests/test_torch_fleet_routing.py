"""The fleet's host half — serving/affinity.py's digest map and affinity
order, master/kv_store.py, the replica pool's routing, health rounds and
scale hints, and the brain's serving forecast — in the port against the
JAX package, with no model.

Both packages run the same scenario on the same inputs (fake schedulers
copied from JAX tests/test_serving_affinity.py, seeded with numpy) and
return plain values — routing choices, digest-map views, breaker
delays, hints — that must be equal. Hints are compared without their
wall-clock `ts`. The JAX tests' own expectations are asserted on the
port's side as well (TestFleetDigestMap, TestAffinityOrder,
TestPrefixDirectory, TestKVRetry, TestRankedReplicas,
TestRoutingPrecedence, TestFuzzedRoutingMatrix, TestHeartbeatDigestFlow,
TestStragglerFencingRegression, TestBackoffJitter, TestServingForecast).
"""

import json
import types
import zlib

import numpy as np
import pytest

from dlrover_tpu.brain import algorithms as jalgo
from dlrover_tpu.brain import datastore as jstore
from dlrover_tpu.master import kv_store as jkv
from dlrover_tpu.serving import affinity as jaff
from dlrover_tpu.serving import chaos as jchaos
from dlrover_tpu.serving import failover as jfo
from dlrover_tpu.serving import metrics as jmetrics
from dlrover_tpu.serving import prefix_cache as jpc
from dlrover_tpu.serving import replica as jrep
from dlrover_tpu.serving import scheduler as jsched
from dlrover_tpu_torch.brain import algorithms as talgo
from dlrover_tpu_torch.brain import datastore as tstore
from dlrover_tpu_torch.master import kv_store as tkv
from dlrover_tpu_torch.serving import affinity as taff
from dlrover_tpu_torch.serving import chaos as tchaos
from dlrover_tpu_torch.serving import failover as tfo
from dlrover_tpu_torch.serving import metrics as tmetrics
from dlrover_tpu_torch.serving import prefix_cache as tpc
from dlrover_tpu_torch.serving import replica as trep
from dlrover_tpu_torch.serving import scheduler as tsched

SIDES = (
    types.SimpleNamespace(A=jaff, KV=jkv, C=jchaos, F=jfo, M=jmetrics,
                          PC=jpc, R=jrep, S=jsched, ALGO=jalgo, ST=jstore),
    types.SimpleNamespace(A=taff, KV=tkv, C=tchaos, F=tfo, M=tmetrics,
                          PC=tpc, R=trep, S=tsched, ALGO=talgo, ST=tstore),
)


def both(scenario, *args):
    """(JAX's outcome, the port's) of one scenario."""
    return tuple(scenario(side, *args) for side in SIDES)


def _no_ts(hint):
    return None if hint is None else {k: v for k, v in hint.items()
                                      if k != "ts"}


# ---- the digest map and the affinity order --------------------------------


def _map_replace(side):
    m = side.A.FleetDigestMap()
    m.update("r1", ["a", "b"])
    m.update("r1", ["b", "c"])  # heartbeat refresh drops "a"
    return (m.match_depths(["a"]), m.match_depths(["c"]), m.stats())


def _map_longest(side):
    m = side.A.FleetDigestMap()
    m.update("shallow", ["d0"])
    m.update("deep", ["d0", "d1", "d2"])
    return m.match_depths(["d0", "d1", "d2"])


def _map_drop(side):
    m = side.A.FleetDigestMap()
    m.update("r1", ["a", "b"])
    m.update("r2", ["b"])
    m.drop("r1")
    mid = (m.replicas(), m.match_depths(["a", "b"]))
    m.drop("r2")
    return mid + (m.size(), m.replicas())


def _map_empty_update(side):
    m = side.A.FleetDigestMap()
    m.update("r1", ["a"])
    m.update("r1", [])
    return (m.size(), m.replicas())


def _map_host_tier(side):
    m = side.A.FleetDigestMap()
    m.update("dev", ["d0"], host_digests=())
    m.update("host", ["d0"], host_digests=["d1", "d2"])
    m.update("both", ["d0", "d1"], host_digests=["d1"])
    out = [m.match_depths(["d0", "d1", "d2"]), m.stats()]
    m.update("host", [], host_digests=["d2"])
    out += [m.match_depths(["d0", "d1", "d2"]), m.stats()]
    return out


MAP_CASES = {
    "replace": (_map_replace, ({}, {"r1": 1},
                               {"digests": 2, "replicas": 1,
                                "host_digests": 0})),
    "longest": (_map_longest, {"shallow": 1, "deep": 3}),
    "drop": (_map_drop, (["r2"], {"r2": 2}, 0, [])),
    "empty_update": (_map_empty_update, (0, [])),
    "host_tier": (_map_host_tier, None),
}


@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_fleet_digest_map_equal_jax(case):
    scenario, want = MAP_CASES[case]
    j, t = both(scenario)
    assert t == j
    if want is not None:
        assert t == want
    if case == "host_tier":
        # a host hit at depth i scores i + 0.5: past a shallower device
        # match, behind a device match at the same depth
        assert t[0] == {"dev": 1, "host": 2.5, "both": 2}


class _Cand:
    def __init__(self, rid, load):
        self.id = rid
        self._load = load

    def load(self):
        return self._load


def _order(side, loads, depths, cap):
    cands = [_Cand(rid, load) for rid, load in loads]
    capped = []
    out = side.A.affinity_order(cands, depths, lambda r: r.load(), cap,
                                capped)
    return [r.id for r in out], [r.id for r in capped]


@pytest.mark.parametrize("loads,depths,cap,want", [
    ([("a", 0.1), ("b", 0.2), ("c", 0.3)], {}, 0.5, ["a", "b", "c"]),
    ([("a", 0.1), ("b", 0.2), ("c", 0.3)], {"b": 1, "c": 2}, 9.0,
     ["c", "b", "a"]),
    ([("a", 0.1), ("b", 0.2), ("c", 0.3)], {"b": 2, "c": 2}, 9.0,
     ["b", "c", "a"]),
    ([("cool", 0.1), ("hot", 0.9)], {"hot": 3}, 0.5, ["cool", "hot"]),
    ([("cool", 0.1), ("hot", 0.9)], {"hot": 3}, 1.0, ["hot", "cool"]),
    ([("a", 0.1), ("b", 0.2)], {"a": 1, "b": 1.5}, 0.5, ["b", "a"]),
], ids=["no_match", "deeper_first", "equal_depth_load", "cap_voids",
        "cap_widened", "host_half_block"])
def test_affinity_order_equal_jax(loads, depths, cap, want):
    j, t = both(_order, loads, depths, cap)
    assert t == j
    assert t[0] == want
    if want == ["cool", "hot"]:
        assert t[1] == ["hot"]


# ---- the KV store, its retry wrapper and the prefix directory ---------------


def _directory_roundtrip(side):
    d = side.KV.PrefixDirectory(side.KV.KVStoreService())
    out = []
    d.publish("r1", ["b", "a"])
    d.publish("r2", ["c"])
    out.append(d.snapshot())
    d.publish("r1", ["z"])
    out.append(d.snapshot()["r1"])
    d.drop("r1")
    out.append(d.snapshot())
    d.publish("r2", [])
    out.append(d.snapshot())
    return out


def _directory_shared(side):
    kv = side.KV.KVStoreService()
    writer, reader = side.KV.PrefixDirectory(kv), side.KV.PrefixDirectory(kv)
    writer.publish("r1", ["a"])
    return reader.snapshot(), kv.get(side.KV.PrefixDirectory.KEY)


def _directory_malformed(side):
    kv = side.KV.KVStoreService()
    kv.set(side.KV.PrefixDirectory.KEY, b"not json{")
    d = side.KV.PrefixDirectory(kv)
    before = d.snapshot()
    d.publish("r1", ["a"])
    return before, d.snapshot()


def _kv_verbs(side):
    kv = side.KV.KVStoreService()
    out = [kv.get("k"), kv.add("n", 3), kv.add("n", -1)]
    kv.set("k", b"v")
    out += [kv.wait("k", timeout=0.0), kv.delete("k"), kv.delete("k")]
    try:
        kv.wait("absent", timeout=0.0)
    except TimeoutError as e:
        out.append(str(e))
    kv.clear()
    out.append(kv.get("n"))
    return out


DIRECTORY_CASES = {
    "roundtrip": (_directory_roundtrip,
                  [{"r1": ["a", "b"], "r2": ["c"]}, ["z"], {"r2": ["c"]},
                   {}]),
    "two_gateways_one_view": (_directory_shared, None),
    "malformed_reads_empty": (_directory_malformed, ({}, {"r1": ["a"]})),
    "kv_verbs": (_kv_verbs, None),
}


@pytest.mark.parametrize("case", sorted(DIRECTORY_CASES))
def test_kv_store_and_directory_equal_jax(case):
    scenario, want = DIRECTORY_CASES[case]
    j, t = both(scenario)
    assert t == j
    if want is not None:
        assert t == want


def _retry_flaky(side, fail_next, retries, seed):
    fi = side.C.FaultInjector()
    store = side.KV.KVStoreService()
    fi.flaky_kv("kv", fail_next=fail_next)
    kv = side.C.ChaosKV(store, fi, tag="kv")
    naps = []
    rkv = side.KV.RetryingKV(kv, retries=retries, sleep=naps.append,
                             jitter_seed=seed)
    try:
        rkv.set("k", b"v")
        raised = None
    except ConnectionError as e:
        raised = type(e).__name__
    return naps, store.get("k"), raised


def _retry_non_transient(side):
    class Bad:
        def set(self, key, value):
            raise ValueError("bug, not weather")

    naps = []
    rkv = side.KV.RetryingKV(Bad(), retries=3, sleep=naps.append)
    try:
        rkv.set("k", b"v")
    except ValueError:
        return naps, "ValueError"
    return naps, None


@pytest.mark.parametrize("fail_next,retries,seed", [
    (2, 3, None), (10, 2, None), (3, 3, 5), (3, 3, 6), (0, 3, 5),
], ids=["through_flakes", "exhausted", "jitter5", "jitter6", "no_fault"])
def test_retrying_kv_equal_jax(fail_next, retries, seed):
    j, t = both(_retry_flaky, fail_next, retries, seed)
    assert t == j
    naps, stored, raised = t
    if seed is None and fail_next == 2:
        assert naps == [0.05, 0.1] and stored == b"v" and raised is None
    if fail_next == 10:
        assert raised == "KVFlake" and stored == b""
    if seed is not None and fail_next:
        # full jitter: uniform(0, delay) under the legacy envelope
        assert naps != [0.05, 0.1, 0.2]
        assert all(0.0 <= a <= b for a, b in zip(naps, [0.05, 0.1, 0.2]))


def test_retrying_kv_non_transient_passes_through_equal_jax():
    j, t = both(_retry_non_transient)
    assert t == j == ([], "ValueError")


# ---- the pool over fake schedulers ------------------------------------------


class _FakeEngine:
    def __init__(self, role="colocated", resident=(), n_chips=1):
        self.n_slots = 4
        self.n_chips = n_chips
        self.replica_role = role
        self._resident = list(resident)

    def adapter_residency(self):
        return list(self._resident)


class _FakeSlo:
    max_queue_depth = 16
    pressure_high = 0.8
    pressure_low = 0.1


class _FakeScheduler:
    """Just enough scheduler for routing: settable pressure (== load,
    active_count stays 0), per-tier waiting depths and a submission
    log; `full` raises the package's AdmissionError."""

    def __init__(self, side, engine, pressure=0.0, tier_depths=None):
        self.side = side
        self.engine = engine
        self.load_value = pressure
        self.tier_depths = dict(tier_depths or {})
        self.crashed = False
        self.full = False
        self.on_failure = None
        self.on_handoff = None
        self.slo = _FakeSlo()
        self._thread = None
        self._step_lat_ewma = 0.0
        self.submitted = []

    def submit(self, prompt, max_new=None, deadline_s=None, adapter_id=None,
               tier=None):
        if self.full:
            raise self.side.S.AdmissionError("full")
        self.submitted.append((list(prompt), adapter_id, tier))
        return ("req", len(self.submitted))

    def tier_queue_depths(self):
        return dict(self.tier_depths)

    def queue_depth(self):
        return int(sum(self.tier_depths.values()))

    def active_count(self):
        return 0

    def pressure(self):
        return self.load_value

    def telemetry(self):
        return {"queue_depth": self.queue_depth(),
                "n_chips": self.engine.n_chips,
                "prefix_hits": 3, "prefix_misses": 1}


def _fake_pool(side, specs, block=4, **pool_kw):
    """specs: (replica_id, load, role, resident_adapters[, tier_depths])."""
    pool_kw.setdefault("prefix_block", block)
    pool = side.R.ReplicaPool(failover=False, **pool_kw)
    reps = {}
    for spec in specs:
        rid, load, role, resident = spec[:4]
        sched = _FakeScheduler(side, _FakeEngine(role=role, resident=resident),
                               pressure=load,
                               tier_depths=spec[4] if len(spec) > 4 else None)
        rep = side.R.InferenceReplica(rid, sched)
        pool.add(rep)
        reps[rid] = rep
    return pool, reps


def _routed_to(pool, reps, prompt, adapter_id=None, tier=None):
    before = {rid: len(r.scheduler.submitted) for rid, r in reps.items()}
    pool.submit(prompt, adapter_id=adapter_id, tier=tier)
    hit = [rid for rid, r in reps.items()
           if len(r.scheduler.submitted) > before[rid]]
    assert len(hit) == 1
    return hit[0]


def _chain_tail(prompt, block=4):
    return [taff.prefix_digest_chain(prompt, block)[-1]]


def _ranked_oracle(side):
    rng = np.random.default_rng(3)
    specs = [(f"r{i}", float(rng.uniform(0, 2)), "colocated", ())
             for i in range(6)]
    pool, reps = _fake_pool(side, specs)
    oracle = sorted(reps.values(), key=lambda r: r.load())
    return [r.id for r in pool.ranked_replicas()], [r.id for r in oracle]


def _ranked_cached(side):
    pool, reps = _fake_pool(side, [("a", 0.1, "colocated", ()),
                                   ("b", 0.5, "colocated", ())])
    out = [[r.id for r in pool.ranked_replicas()]]
    reps["a"].scheduler.load_value = 2.0
    out.append([r.id for r in pool.ranked_replicas()])  # cached
    pool.mark_rank_dirty()
    out.append([r.id for r in pool.ranked_replicas()])
    return out


def _ranked_health_round(side):
    pool, reps = _fake_pool(side, [("a", 0.1, "colocated", ()),
                                   ("b", 0.5, "colocated", ())])
    pool.ranked_replicas()
    reps["a"].scheduler.load_value = 2.0
    pool.check_replicas()  # the heartbeat pass marks dirty
    return [r.id for r in pool.ranked_replicas()]


def _ranked_unhealthy(side):
    pool, reps = _fake_pool(side, [("a", 0.1, "colocated", ()),
                                   ("b", 0.5, "colocated", ())])
    pool.ranked_replicas()
    reps["a"].healthy = False
    return [r.id for r in pool.ranked_replicas()]


RANKED_CASES = {
    "sorted_oracle": (_ranked_oracle, None),
    "cached_until_dirty": (_ranked_cached,
                           [["a", "b"], ["a", "b"], ["b", "a"]]),
    "health_round_refresh": (_ranked_health_round, ["b", "a"]),
    "unhealthy_filtered": (_ranked_unhealthy, ["b"]),
}


@pytest.mark.parametrize("case", sorted(RANKED_CASES))
def test_ranked_replicas_equal_jax(case):
    scenario, want = RANKED_CASES[case]
    j, t = both(scenario)
    assert t == j
    if want is not None:
        assert t == want
    else:
        assert t[0] == t[1]


PROMPT = list(range(8))

# (specs, pool kwargs, digests {rid: prompt whose chain tail it holds},
#  prompt, adapter, tier, the JAX test's answer)
PRECEDENCE = {
    "least_loaded": ([("hot", 1.0, "colocated", ()),
                      ("cool", 0.1, "colocated", ())], {}, {}, PROMPT,
                     None, None, "cool"),
    "affinity_beats_load": ([("warm", 0.3, "colocated", ()),
                             ("cool", 0.1, "colocated", ())],
                            {"affinity_max_imbalance": 0.5},
                            {"warm": PROMPT}, PROMPT, None, None, "warm"),
    "cap_spills_to_coolest": ([("warm", 0.9, "colocated", ()),
                               ("cool", 0.1, "colocated", ())],
                              {"affinity_max_imbalance": 0.5},
                              {"warm": PROMPT}, PROMPT, None, None, "cool"),
    "affinity_beats_adapter": ([("cached", 0.2, "colocated", ()),
                                ("resident", 0.1, "colocated", ("lora-a",))],
                               {}, {"cached": PROMPT}, PROMPT, "lora-a",
                               None, "cached"),
    "adapter_breaks_ties": ([("plain", 0.1, "colocated", ()),
                             ("resident", 0.2, "colocated", ("lora-a",))],
                            {}, {"plain": PROMPT, "resident": PROMPT},
                            PROMPT, "lora-a", None, "resident"),
    "phase_beats_affinity": ([("pf", 0.5, "prefill", ()),
                              ("co", 0.0, "colocated", ())], {},
                             {"co": PROMPT}, PROMPT, None, None, "pf"),
    "decode_is_last_resort": ([("dec", 0.0, "decode", ()),
                               ("co", 0.9, "colocated", ())], {}, {},
                              PROMPT, None, None, "co"),
    "short_prompt_least_loaded": ([("a", 0.5, "colocated", ()),
                                   ("b", 0.1, "colocated", ())], {},
                                  {}, [1, 2], None, None, "b"),
    "affinity_off": ([("warm", 0.3, "colocated", ()),
                      ("cool", 0.1, "colocated", ())],
                     {"affinity_routing": False}, {"warm": PROMPT}, PROMPT,
                     None, None, "cool"),
    "tier_spread": ([("busy", 0.1, "colocated", (), {"latency": 3}),
                     ("idle", 0.2, "colocated", (), {"latency": 0})], {},
                    {}, PROMPT, None, "latency", "idle"),
}


def _precedence(side, case):
    specs, kw, digests, prompt, adapter, tier, _ = PRECEDENCE[case]
    m = side.M.ServingMetrics()
    pool, reps = _fake_pool(side, specs, metrics=m, **kw)
    for rid, p in digests.items():
        pool.digest_map.update(rid, _chain_tail(p))
    got = _routed_to(pool, reps, prompt, adapter, tier)
    return got, m.affinity_matched, m.affinity_unmatched, pool.routing_stats()


@pytest.mark.parametrize("case", sorted(PRECEDENCE))
def test_routing_precedence_equal_jax(case):
    j, t = both(_precedence, case)
    assert t == j
    assert t[0] == PRECEDENCE[case][-1]
    assert t[3]["affinity_routing"] is PRECEDENCE[case][1].get(
        "affinity_routing", True)


def _fuzz_case(side, seed):
    """One draw of role x adapter x prefix (device and host tier) x
    tier depth x load x health x straggler fence; -> the routed id (or
    the error), the affinity counters and the scale hint."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 250, size=12).tolist()
    chain = taff.prefix_digest_chain(shared, 4)
    n = int(rng.integers(2, 6))
    roles = rng.choice(["colocated", "prefill", "decode"], size=n,
                       p=[0.6, 0.25, 0.15])
    specs = []
    for i in range(n):
        resident = ("lora-a",) if rng.random() < 0.4 else ()
        load = round(float(rng.choice([0.0, 0.1, 0.3, 0.5, 1.0]))
                     + float(rng.random()) / 20, 4)
        depths = {t: int(rng.integers(0, 3))
                  for t in ("latency", "standard", "batch")}
        specs.append((f"r{i}", load, str(roles[i]), resident, depths))
    m = side.M.ServingMetrics()
    fence = rng.random() < 0.3
    pool, reps = _fake_pool(
        side, specs, metrics=m,
        affinity_max_imbalance=float(rng.choice([0.1, 0.5, 2.0])),
        straggler_ratio=3.0 if fence else 0.0)
    for rid, rep in reps.items():
        if rng.random() < 0.15:
            rep.healthy = False
        if rng.random() < 0.5:
            depth = int(rng.integers(1, 4))
            host = ([chain[int(rng.integers(0, 3))]]
                    if rng.random() < 0.3 else [])
            pool.digest_map.update(rid, [chain[depth - 1]],
                                   host_digests=host)
        if rng.random() < 0.1:
            rep.scheduler.full = True
    if fence:
        pool._straggler_fenced = frozenset(
            rid for rid in reps if rng.random() < 0.4)
    tail = rng.integers(1, 250, size=4).tolist()
    prompt = (shared + tail if rng.random() < 0.7
              else rng.integers(1, 250, size=6).tolist())
    adapter = "lora-a" if rng.random() < 0.5 else None
    tier = (str(rng.choice(["latency", "standard", "batch"]))
            if rng.random() < 0.5 else None)
    try:
        got = _routed_to(pool, reps, prompt, adapter, tier)
    except side.S.AdmissionError as e:
        got = (type(e).__name__, e.reason)
    return (got, m.affinity_matched, m.affinity_unmatched,
            m.affinity_capped, _no_ts(pool.scale_hint(force=True)))


def test_fuzzed_routing_matrix_equal_jax():
    """Both pools pick the same replica on every one of 300 seeded
    draws, and count the same affinity outcomes."""
    outcomes = set()
    for seed in range(300):
        j, t = both(_fuzz_case, seed)
        assert t == j, f"seed {seed}: port {t}, JAX {j}"
        outcomes.add(t[0] if isinstance(t[0], str) else t[0][0])
    # the draws reach every outcome kind: a replica of each index, a
    # full fleet and an empty one
    assert {"r0", "r1", "AdmissionError",
            "NoHealthyReplicasError"} <= outcomes


def _full_fleet_fallback(side):
    pool, reps = _fake_pool(side, [("warm", 0.2, "colocated", ()),
                                   ("next", 0.3, "colocated", ()),
                                   ("last", 0.5, "colocated", ())])
    pool.digest_map.update("warm", _chain_tail(PROMPT))
    reps["warm"].scheduler.full = True
    first = _routed_to(pool, reps, PROMPT)
    for r in reps.values():
        r.scheduler.full = True
    try:
        pool.submit(PROMPT)
    except side.S.AdmissionError as e:
        return first, type(e).__name__, e.reason
    return first, None, None


def test_full_fleet_fallback_equal_jax():
    j, t = both(_full_fleet_fallback)
    assert t == j == ("next", "AdmissionError", "full")


def _heartbeat_flow(side):
    kv = side.KV.KVStoreService()
    pool, reps = _fake_pool(side, [("warm", 0.1, "colocated", ()),
                                   ("cold", 0.2, "colocated", ())],
                            kv=kv, max_strikes=1)
    cache = side.PC.RadixPrefixCache(4, block=4)
    cache.insert(PROMPT)
    reps["warm"].scheduler.engine.prefix_cache = cache
    pool.check_replicas()
    d = taff.prefix_digest_chain(PROMPT, 4)[-1]
    out = [pool.digest_map.match_depths([d]),
           side.KV.PrefixDirectory(kv).snapshot(),
           json.loads(kv.get(side.R.REPLICA_KEY_PREFIX + "warm"))[
               "prefix_digests"]]

    def _raise():
        raise RuntimeError("probe down")

    reps["warm"].scheduler.queue_depth = _raise
    pool.check_replicas()
    out += [reps["warm"].healthy, pool.digest_map.match_depths([d]),
            side.KV.PrefixDirectory(kv).snapshot()]
    pool.remove("cold")
    out.append((pool.digest_map.size(), [r.id for r in pool.replicas()]))
    return out, d


def test_heartbeat_digest_flow_equal_jax():
    (j, d), (t, _) = both(_heartbeat_flow)
    assert t == j
    assert t[0] == {"warm": 1} and t[1]["warm"] == [d] and t[2] == [d]
    # ejection drops both views at once
    assert t[3] is False and t[4] == {} and "warm" not in t[5]
    assert t[6] == (0, ["warm"])


# ---- straggler fencing under an injected clock ------------------------------

PATIENCE = 2


def _straggler_arm(side, ratio):
    t = [0.0]
    m = side.M.ServingMetrics()
    pool, reps = _fake_pool(
        side, [(f"hp-{i}", 0.0, "colocated", ()) for i in range(3)],
        metrics=m, clock=lambda: t[0], straggler_ratio=ratio,
        straggler_patience=PATIENCE)
    slow, fast_a, fast_b = reps.values()
    slow.scheduler._step_lat_ewma = 0.5
    fast_a.scheduler._step_lat_ewma = 0.01
    fast_b.scheduler._step_lat_ewma = 0.011
    for _ in range(PATIENCE):
        pool.check_replicas()
        t[0] += 1.0
    routed = [_routed_to(pool, reps, p)
              for p in ([1, 2, 3], [4, 5, 6, 7], [8, 9])]
    return routed, pool.health_stats(), slow.healthy


def _straggler_eject_rejoin(side):
    t = [0.0]
    pool, reps = _fake_pool(
        side, [(f"hp-{i}", 0.0, "colocated", ()) for i in range(3)],
        metrics=side.M.ServingMetrics(), clock=lambda: t[0],
        straggler_ratio=3.0, straggler_patience=PATIENCE)
    slow, fast_a, fast_b = reps.values()
    slow.scheduler._step_lat_ewma = 0.5
    fast_a.scheduler._step_lat_ewma = 0.01
    fast_b.scheduler._step_lat_ewma = 0.011
    for _ in range(2 * PATIENCE):
        pool.check_replicas()
        t[0] += 1.0
    out = [slow.healthy, pool.health_stats(),
           pool.breakers[slow.id].state]
    slow.scheduler._step_lat_ewma = 0.012
    pool.check_replicas()
    out.append(slow.healthy)
    pool.check_replicas()
    out.append(pool.health_stats()["straggler_fenced"])
    return out


def test_straggler_fenced_within_patience_equal_jax():
    j, t = both(_straggler_arm, 3.0)
    assert t == j
    routed, hs, healthy = t
    assert "hp-0" not in routed, "a fenced straggler still took routes"
    assert hs["straggler_fenced"] == ["hp-0"]
    assert hs["stragglers_flagged"] == 1.0 and healthy
    # control arm: detection off, the slow replica keeps taking routes
    j, t = both(_straggler_arm, 0.0)
    assert t == j and "hp-0" in t[0]


def test_persistent_straggler_ejects_then_rejoins_equal_jax():
    j, t = both(_straggler_eject_rejoin)
    assert t == j
    assert t[0] is False and t[1]["straggler_ejections_total"] == 1.0
    assert t[1]["straggler_fenced"] == [] and t[2] == tfo.OPEN
    assert t[3] is True and t[4] == []


# ---- breaker and retry jitter -----------------------------------------------


def _breaker_delays(side, seed):
    t = [0.0]
    br = side.F.CircuitBreaker(max_strikes=1, backoff_base_s=0.5,
                               backoff_max_s=30.0, clock=lambda: t[0],
                               jitter_seed=seed)
    delays = []
    for _ in range(5):
        br.trip()
        delays.append(br._retry_at - t[0])
    return delays


def _pool_breakers(side, seed):
    pool = side.R.ReplicaPool(breaker_jitter_seed=seed)
    seq = []
    for rid in ("rep-a", "rep-b", "rep-a"):
        br = pool._new_breaker(rid)
        t = [0.0]
        br._clock = lambda: t[0]
        d = []
        for _ in range(4):
            br.trip()
            d.append(br._retry_at)
        seq.append(d)
    return seq


@pytest.mark.parametrize("seed", [None, 7, 8])
def test_breaker_jitter_equal_jax(seed):
    j, t = both(_breaker_delays, seed)
    assert t == j
    if seed is None:
        assert t == [0.0, 0.5, 1.0, 2.0, 4.0]
    else:
        assert t[0] == 0.0 and t != [0.0, 0.5, 1.0, 2.0, 4.0]


def test_pool_decorrelates_replica_breakers_equal_jax():
    j, t = both(_pool_breakers, 123)
    assert t == j
    assert t[0] == t[2] and t[0] != t[1]
    rep = trep.InferenceReplica("r", types.SimpleNamespace(),
                                kv_jitter_seed=9)
    assert rep.kv_jitter_seed == 9


# ---- scale hints, telemetry and the forecast --------------------------------


def _scale_hints(side, loads, n_chips):
    kv = side.KV.KVStoreService()
    advised = []
    pool = side.R.ReplicaPool(kv=kv, failover=False, advisor=advised.append,
                              hint_cooldown_s=1e9)
    for i, load in enumerate(loads):
        sched = _FakeScheduler(side, _FakeEngine(n_chips=n_chips),
                               pressure=load)
        pool.add(side.R.InferenceReplica(f"r{i}", sched))
    first = _no_ts(pool.scale_hint(force=True))
    cooled = pool.scale_hint()  # inside the cooldown: nothing
    stored = _no_ts(json.loads(kv.get(side.R.SCALE_HINT_KEY)))
    for rep in pool.replicas():
        rep.healthy = False
    try:
        pool.submit(PROMPT)
    except side.R.NoHealthyReplicasError as e:
        empty = (e.reason, _no_ts(json.loads(kv.get(side.R.SCALE_HINT_KEY))))
    return (first, cooled, stored, [_no_ts(h) for h in advised], empty,
            pool.aggregate_pressure())


@pytest.mark.parametrize("loads,n_chips,direction", [
    ([0.9, 1.2], 1, "up"), ([0.05, 0.0], 2, "down"), ([0.4, 0.5], 1, "hold"),
    ([0.5], 4, "hold"),
], ids=["up", "down", "hold", "single"])
def test_scale_hint_equal_jax(loads, n_chips, direction):
    j, t = both(_scale_hints, loads, n_chips)
    assert t == j
    first, cooled, stored, advised, empty, pressure = t
    assert first["direction"] == direction and cooled is None
    assert stored == first and first["chips_per_replica"] == n_chips
    assert advised == ([] if direction == "hold" else [first]) + [empty[1]]
    assert empty[1]["direction"] == "up" and empty[1]["replicas"] == 1
    assert pressure == 1.0


def _seed_forecast(side, pressures, uuid="fleet", chips=4):
    store = side.ST.JobMetricsStore()
    store.upsert_job(side.ST.JobMeta(job_uuid=uuid, job_name="serve"))
    for i, pr in enumerate(pressures):
        store.add_sample(side.ST.RuntimeSample(
            job_uuid=uuid, role="serving", num_nodes=chips,
            cpu_percent=pr * 100.0, ts=float(10 * i),
            queue_depth=int(pr * 10), cache_hit_rate=0.5))
    return store


def _forecast_algorithm(side, pressures, n):
    store = _seed_forecast(side, pressures)
    d = side.ALGO.run_algorithm(
        "optimize_serving_replica_resource",
        side.ALGO.OptimizeContext(
            job_uuid="fleet", store=store,
            current={"serving": {"count": n, "chips_per_replica": 2}}))
    store.close()
    return (d.role, d.count, d.chips, d.reason, d.empty,
            sorted(side.ALGO.ALGORITHMS))


FORECASTS = {
    "up_before_the_spike": ([0.4, 0.55, 0.7], 2),
    "flat_holds": ([0.5, 0.5, 0.5, 0.5], 2),
    "min_window": ([0.99, 0.99], 2),
    "down_conservative": ([0.1, 0.08, 0.05], 3),
    "low_rising_holds": ([0.02, 0.05, 0.09], 3),
    "single_never_down": ([0.05, 0.03, 0.01], 1),
}


@pytest.mark.parametrize("case", sorted(FORECASTS))
def test_serving_forecast_equal_jax(case):
    j, t = both(_forecast_algorithm, *FORECASTS[case])
    assert t == j
    role, count, chips, reason, empty, names = t
    assert len(names) == 10
    if case == "up_before_the_spike":
        assert count >= 3 and chips == count * 2 and "forecast" in reason
    elif case == "down_conservative":
        assert (count, chips) == (2, 4)
    else:
        assert empty


def _pool_forecast(side, pressures, loads):
    store = _seed_forecast(side, pressures)
    kv = side.KV.KVStoreService()
    m = side.M.ServingMetrics()
    advised = []
    pool = side.R.ReplicaPool(kv=kv, failover=False, metrics=m,
                              brain_store=store, job_uuid="fleet",
                              advisor=advised.append)
    for i, load in enumerate(loads):
        sched = _FakeScheduler(side, _FakeEngine(n_chips=2), pressure=load,
                               tier_depths={"standard": i + 1})
        pool.add(side.R.InferenceReplica(f"r{i}", sched))
    sample = pool.publish_telemetry()
    sample = {k: v for k, v in vars(sample).items() if k != "ts"}
    hint = _no_ts(pool.predictive_scale())
    stored = kv.get(side.R.SCALE_HINT_KEY)
    n_samples = len(store.samples("fleet", role="serving", limit=64))
    store.close()
    return (sample, hint, _no_ts(json.loads(stored)) if stored else None,
            [_no_ts(h) for h in advised], n_samples,
            m.render().count("serving_forecast"))


@pytest.mark.parametrize("pressures,loads", [
    ([0.4, 0.55, 0.7], [0.7, 0.8]), ([0.5, 0.5, 0.5], [0.5, 0.5]),
    ([0.1, 0.08, 0.05], [0.0, 0.05, 0.01]),
], ids=["up", "hold", "down"])
def test_publish_telemetry_and_predictive_scale_equal_jax(pressures, loads):
    j, t = both(_pool_forecast, pressures, loads)
    assert t == j
    sample, hint, stored, advised, n_samples, _ = t
    assert sample["role"] == "serving" and sample["num_nodes"] == 2 * len(loads)
    assert sample["cache_hit_rate"] == 0.75 and n_samples == len(pressures) + 1
    if hint is not None:
        assert hint["source"] == "forecast" and stored == hint
        assert advised == [hint] and hint["chips"] == hint["replicas"] * 2


def test_crc32_seeding_matches():
    """The breaker seed of a replica id is the JAX pool's (zlib.crc32 of
    the id added to the pool's seed)."""
    pool = trep.ReplicaPool(breaker_jitter_seed=5)
    br = pool._new_breaker("replica-0")
    want = jfo.CircuitBreaker(
        jitter_seed=(5 + zlib.crc32(b"replica-0")) & 0xFFFFFFFF,
        max_strikes=2, backoff_base_s=0.5, backoff_max_s=30.0)
    t = [0.0]
    br._clock = want._clock = lambda: t[0]
    got = []
    for b in (br, want):
        d = []
        for _ in range(4):
            b.trip()
            d.append(b._retry_at)
        got.append(d)
    assert got[0] == got[1]
