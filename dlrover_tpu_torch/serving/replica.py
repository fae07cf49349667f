"""Inference replica pool: KV-store registration, health checks,
prefix-affinity routing, failover and phase-handoff wiring, and
queue-pressure scale hints — a copy of dlrover_tpu/serving/replica.py
over the port's scheduler and engine (host code; the pool and its
replicas add no device logic: they serve whatever engines they are
given, on the card unless the engines were built for the CPU).

This is the serving-side mirror of the training control plane
(master-coordinated node pools with health-checked members):

- each replica registers itself in the master KV store
  (master/kv_store.py) and refreshes its entry with a heartbeat
  carrying live load, its slice shape, its published prefix digests
  and its resident adapters,
- the pool health-checks replicas with the agent's node-check
  discipline (repeated rounds, a node is faulty only after consecutive
  strikes — one slow probe is weather, two is climate), through one
  circuit breaker per replica,
- aggregate queue pressure is folded into a scale hint for the
  auto-scaler, and the brain's serving forecast into a predictive one.

Where the port differs from the JAX pool:

- `InferenceReplica.run_preflight` runs the port's device self-check
  (`health.run_preflight(device)`) on the replica's own engine device;
  the JAX check takes no device.
- Journaled keys are `torch.Generator` states (or int seeds). The pool
  hands resume tickets to the failover manager and the handoff
  coordinator as they are and never casts a key.
- Comments that carried the JAX tree's lint annotations say the same
  thing in plain words.
"""

import json
import os
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.kv_store import PrefixDirectory, RetryingKV
from dlrover_tpu_torch.serving import health as _health
from dlrover_tpu_torch.serving.affinity import (
    FleetDigestMap,
    affinity_order,
    cache_digests,
    prefix_digest_chain,
)
from dlrover_tpu_torch.serving.failover import (
    OPEN,
    CircuitBreaker,
    FailoverManager,
)
from dlrover_tpu_torch.serving.handoff import HandoffCoordinator
from dlrover_tpu_torch.serving.scheduler import (
    AdmissionError,
    RequestScheduler,
    ServeRequest,
)

REPLICA_KEY_PREFIX = "serving/replicas/"
SCALE_HINT_KEY = "serving/scale_hint"


class NoHealthyReplicasError(AdmissionError):
    """Every replica in the pool is unhealthy: routing cannot place
    the request anywhere. Distinct from plain AdmissionError (a full
    queue is the client's backpressure problem, HTTP 429; an empty
    pool is the service's availability problem, HTTP 503)."""

# chaos hook, the training agent's MOCK_ERR_RANK idiom (the same
# variable name as the JAX pool's, so one setting reaches both)
MOCK_ERR_REPLICA_ENV = "DLROVER_TPU_SERVING_MOCK_ERR_REPLICA"


def _kv_set(kv, key: str, value: bytes):
    """Duck-typed store write: MasterClient.kv_set (over gRPC) or
    KVStoreService.set (in-process master)."""
    if hasattr(kv, "kv_set"):
        kv.kv_set(key, value)
    else:
        kv.set(key, value)


def _kv_get(kv, key: str) -> bytes:
    if hasattr(kv, "kv_get"):
        return kv.kv_get(key)
    return kv.get(key)


def _tier_wait_depth(rep: "InferenceReplica", tier: str) -> int:
    """QUEUED requests competing in `tier` on one replica — the
    routing key that spreads same-tier waiting across the fleet.
    Duck-typed: schedulers without per-tier heaps (test doubles)
    count as 0, and a probe failure must not fail routing."""
    fn = getattr(rep.scheduler, "tier_queue_depths", None)
    if not callable(fn):
        return 0
    try:
        return int(fn().get(tier, 0))
    # tier depth is a routing hint only; a raising scheduler is caught
    # by the health probe, not here
    except Exception:  # noqa: BLE001
        return 0


class InferenceReplica:
    """One serving replica: a scheduler over one engine, registered in
    the master KV store."""

    def __init__(
        self,
        replica_id: str,
        scheduler: RequestScheduler,
        kv=None,
        chaos=None,
        kv_retries: int = 3,
        kv_backoff_s: float = 0.05,
        preflight_check: bool = False,
        kv_jitter_seed: Optional[int] = None,
    ):
        self.id = replica_id
        self.scheduler = scheduler
        self.kv = kv
        self.chaos = chaos
        self.kv_retries = kv_retries
        self.kv_backoff_s = kv_backoff_s
        # seeded full jitter on the KV retry backoff: simultaneous
        # heartbeat failures must not re-hit the master in lockstep
        # (None keeps the exact legacy delays)
        self.kv_jitter_seed = kv_jitter_seed
        self.healthy = True
        self.strikes = 0
        # degraded = alive but serving on a shrunk mesh slice (chip
        # loss survived via serving/elastic.py). Distinct from
        # ejection: a degraded replica keeps routing weight and must
        # NOT accrue breaker strikes — the pool's probation re-probe
        # grows it back when the chips return.
        self.degraded = False
        # preflight self-check (serving/health.py): a deterministic
        # device probe at start/restart and after every elastic
        # resize. A failure fails CLOSED into `degraded`, and
        # `preflight_ok` pins the flag — the elastic pass must not
        # clear degraded while the device still computes wrong bits.
        self.preflight_check = preflight_check
        self.preflight_ok = True

    @property
    def role(self) -> str:
        """The replica's serving phase ("prefill" | "decode" |
        "colocated") — the engine's knob, surfaced for routing and
        the handoff coordinator's target selection."""
        return getattr(
            self.scheduler.engine, "replica_role", "colocated"
        )

    # ---- registration ----------------------------------------------------

    @property
    def kv_key(self) -> str:
        return REPLICA_KEY_PREFIX + self.id

    def register(self):
        """Write this replica's entry, retrying transient KV errors
        with capped exponential backoff (RetryingKV). Exhausted
        retries are logged, not raised: a master blip must not crash
        the heartbeat/pool thread — the entry just goes stale until
        the next beat (the master-side reader's dead-replica signal
        anyway)."""
        if self.kv is None:
            return
        rkv = RetryingKV(
            self.kv,
            retries=self.kv_retries,
            backoff_base_s=self.kv_backoff_s,
            jitter_seed=self.kv_jitter_seed,
        )
        try:
            rkv.set(self.kv_key, self._meta())
        except RetryingKV.TRANSIENT:
            logger.warning(
                "replica %s registration still failing after %d "
                "retries (master unreachable?)",
                self.id, self.kv_retries, exc_info=True,
            )

    def heartbeat(self):
        """Refresh the registration with live load (the master-side
        reader distinguishes a dead replica by a stale ts)."""
        self.register()

    def _meta(self) -> bytes:
        # mesh_shape/n_chips: a replica is a mesh SLICE, not a device
        # — the auto-scaler prices its hints in chips = replicas ×
        # slice size, so the heartbeat must carry the slice shape
        # (getattr keeps pre-mesh engines and test doubles valid)
        eng = self.scheduler.engine
        return json.dumps(
            {
                "id": self.id,
                # wall clock: the master-side reader's dead-replica
                # staleness check compares it across hosts
                "ts": time.time(),
                "n_slots": eng.n_slots,
                "queue_depth": self.scheduler.queue_depth(),
                "active": self.scheduler.active_count(),
                "pressure": self.scheduler.pressure(),
                "healthy": self.healthy,
                "mesh_shape": getattr(eng, "mesh_shape", {"tp": 1}),
                "n_chips": int(getattr(eng, "n_chips", 1)),
                "role": self.role,
                "degraded": self.degraded,
                "preflight_ok": self.preflight_ok,
                # step-latency EWMA (scheduler-side smoothing): the
                # fleet-relative straggler test's per-replica signal,
                # riding the heartbeat like every other health bit
                "step_latency_s": self.step_latency(),
                # LoRA adapters resident in this replica's device bank
                # (MRU-last) — the pool's routing prefers a replica
                # that already holds the request's adapter, turning
                # cache affinity into a placement signal instead of an
                # upload on every cross-replica bounce
                "adapters_resident": self.adapters_resident(),
                # blake2b digests of the block-aligned prefixes this
                # replica's radix cache has published — the fleet
                # router's affinity signal. Digests only: no token
                # data leaves the replica through the control plane.
                "prefix_digests": self.prefix_digests(),
                # digests resident in the host-DRAM KV tier — the
                # digest map's `tier` bit: one PCIe promotion from
                # device-warm, so routing half-counts them (ahead of
                # cold prefill, behind a device-warm peer)
                "kv_tier_digests": self.kv_tier_digests(),
            }
        ).encode()

    def prefix_digests(self) -> List[str]:
        """Digests of the prompt prefixes currently published in this
        replica's radix cache (newest-touched first, capped by
        affinity.MAX_PUBLISHED_DIGESTS); [] when the prefix cache is
        off or the engine predates it (test doubles)."""
        cache = getattr(self.scheduler.engine, "prefix_cache", None)
        if cache is None or not hasattr(cache, "published_blocks"):
            return []
        try:
            return cache_digests(cache)
        # the advertisement is a routing hint only; a raising engine
        # is caught by the health probe, not here
        except Exception:  # noqa: BLE001
            return []

    def kv_tier_digests(self) -> List[str]:
        """Digests of the prompt prefixes held demoted in this
        replica's host-DRAM KV tier (newest-demoted first, capped like
        prefix_digests); [] when the tier is off or the engine
        predates it (test doubles). Swap entries never advertise —
        they key exact folded sequences, useless to other requests."""
        tier = getattr(self.scheduler.engine, "kv_tier", None)
        if tier is None or not hasattr(tier, "prefix_digests"):
            return []
        try:
            return list(tier.prefix_digests())
        # the advertisement is a routing hint only; a raising engine
        # is caught by the health probe, not here
        except Exception:  # noqa: BLE001
            return []

    def adapters_resident(self) -> List[str]:
        """Adapter ids currently uploaded to this replica's device
        bank (MRU-last); [] when multi-adapter serving is off or the
        engine predates it (test doubles)."""
        res = getattr(
            self.scheduler.engine, "adapter_residency", None
        )
        if res is None:
            return []
        try:
            return list(res())
        # residency is a routing hint only; a raising engine is
        # caught by the health probe, not here
        except Exception:  # noqa: BLE001
            return []

    def step_latency(self) -> float:
        """This replica's published step-latency EWMA in seconds
        (0.0 before the first dispatch or on schedulers predating
        it — test doubles). The straggler detector's input."""
        return float(
            getattr(self.scheduler, "_step_lat_ewma", 0.0) or 0.0
        )

    # ---- health ----------------------------------------------------------

    def run_preflight(self) -> bool:
        """Run the deterministic device self-check and fail CLOSED:
        a digest mismatch (or a raising probe) marks the replica
        degraded and pins `preflight_ok` False, so the elastic pass
        cannot heal it until a later preflight passes."""
        try:
            ok = _health.run_preflight(self.scheduler.engine.device)
        except Exception:  # noqa: BLE001 — a raising probe = failed
            logger.exception(
                "replica %s preflight probe raised", self.id
            )
            ok = False
        self.preflight_ok = ok
        if not ok:
            self.degraded = True
            logger.warning(
                "replica %s failed its preflight self-check; "
                "degraded (failing closed)", self.id,
            )
        elif self.degraded:
            # the device computes right bits again — the elastic pass
            # owns the rest of the degraded decision (chip deficit)
            logger.info(
                "replica %s preflight passed again", self.id
            )
        return ok

    def probe(self) -> bool:
        """One health probe: the scheduler's pump thread is live (if
        started) and its queue answers. Chaos faults come in two
        flavors: the env knob DLROVER_TPU_SERVING_MOCK_ERR_REPLICA=<id>
        (agent/node_check.py's MOCK_ERR_RANK idiom) and a
        serving/chaos.py injector whose crash plans fail this tag's
        probes until revive(). A crashed scheduler is NOT a probe
        failure by itself — check_replicas handles it via restart()."""
        if os.environ.get(MOCK_ERR_REPLICA_ENV, "") == self.id:
            return False
        if self.chaos is not None and not self.chaos.probe_ok(
            self.chaos_tag
        ):
            return False
        t = self.scheduler._thread
        if t is not None and not t.is_alive():
            return False
        try:
            self.scheduler.queue_depth()
            return True
        except Exception:  # noqa: BLE001 — any engine error = unhealthy
            logger.exception("replica %s probe failed", self.id)
            return False

    @property
    def chaos_tag(self) -> str:
        """The tag fault plans address this replica by: the engine's
        chaos tag when the engine is chaos-wired (so ONE crash plan
        covers both the dispatch and the probe), else the replica
        id."""
        eng = self.scheduler.engine
        if getattr(eng, "chaos", None) is not None:
            return eng.chaos_tag
        return self.id

    def restart(self) -> bool:
        """Rebuild a crashed scheduler/engine and re-register. Called
        from the pool's probation path once probes pass again."""
        try:
            self.scheduler.restart()
        except Exception:  # noqa: BLE001
            logger.exception("replica %s restart failed", self.id)
            return False
        if self.preflight_check:
            # a rebuilt engine re-earns its place: same discipline as
            # the training agent's pre-join node check
            self.run_preflight()
        self.register()
        return True

    def load(self) -> float:
        """Routing weight: waiting pressure plus slot occupancy, so an
        idle replica wins over a busy one even when neither queues."""
        sched = self.scheduler
        occupancy = sched.active_count() / max(1, sched.engine.n_slots)
        return sched.pressure() + occupancy

    def start(self):
        if self.preflight_check:
            self.run_preflight()
        self.scheduler.start()
        self.register()

    def stop(self):
        self.scheduler.stop()


class ReplicaPool:
    """Routes requests across replicas; health-checks them; emits
    scale hints from aggregate queue pressure."""

    # shared between the pool's health-check thread, request threads
    # routing through submit(force-hint path), and FailoverManager —
    # access only under self._lock
    GUARDED_FIELDS = frozenset(
        {"_replicas", "breakers", "_last_hint_ts", "_ranked",
         "_rank_dirty", "_straggler_fenced"}
    )

    def __init__(
        self,
        kv=None,
        max_strikes: int = 2,
        hint_cooldown_s: float = 10.0,
        advisor: Optional[Callable[[dict], None]] = None,
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
        failover: bool = True,
        max_retries: int = 2,
        breaker_backoff_base_s: float = 0.5,
        breaker_backoff_max_s: float = 30.0,
        elastic_resize: bool = True,
        affinity_routing: bool = True,
        affinity_max_imbalance: float = 0.5,
        prefix_block: Optional[int] = None,
        directory: Optional[PrefixDirectory] = None,
        brain_store=None,
        job_uuid: str = "serving-fleet",
        forecast_algorithm: str = (
            "optimize_serving_replica_resource"
        ),
        straggler_ratio: float = 0.0,
        straggler_patience: int = 3,
        breaker_jitter_seed: Optional[int] = None,
    ):
        self.kv = kv
        # degraded-replica handling: shrink a chip-lossy replica live
        # (and grow it back when the chips return) instead of letting
        # the loss surface as breaker strikes / ejection
        self.elastic_resize = elastic_resize
        self.max_strikes = max_strikes
        self.hint_cooldown_s = hint_cooldown_s
        self.advisor = advisor
        self.metrics = metrics
        self._clock = clock
        self.breaker_backoff_base_s = breaker_backoff_base_s
        self.breaker_backoff_max_s = breaker_backoff_max_s
        # seeded full jitter on the breakers' probation backoff:
        # simultaneous ejections must not re-probe in lockstep (None
        # keeps the exact legacy delays). Each replica's breaker gets
        # a seed decorrelated by its id, deterministically.
        self.breaker_jitter_seed = breaker_jitter_seed
        # fleet-relative straggler detection (serving/health.py):
        # ratio 0 = off (the legacy pool). The sentinel consumes the
        # step-latency EWMAs heartbeats already publish; fenced
        # replicas sort behind every healthy candidate in submit()
        # and escalate to breaker-open when they stay slow.
        self._sentinel: Optional[_health.StragglerDetector] = (
            _health.StragglerDetector(
                ratio=straggler_ratio, patience=straggler_patience
            )
            if straggler_ratio > 0
            else None
        )
        self._straggler_fenced: frozenset = frozenset()
        # per-replica circuit breakers: consecutive-failure ejection,
        # exponential-backoff probation, one clean probe to re-admit
        self.breakers: Dict[str, CircuitBreaker] = {}
        # request-level failover: wired as each added scheduler's
        # on_failure so a crashing engine's in-flight requests are
        # re-admitted on healthy peers instead of failing
        self.manager: Optional[FailoverManager] = (
            FailoverManager(self, max_retries=max_retries)
            if failover
            else None
        )
        # MPMD phase split: prefill-role replicas hand finished
        # prefills to this coordinator, which places them on decode
        # targets (wired as each prefill scheduler's on_handoff)
        self.handoff = HandoffCoordinator(self)
        # fleet prefix affinity: the in-process digest→replica map
        # submit() routes with (heartbeat-refreshed, dropped eagerly
        # on death), plus the shared KV-backed directory other
        # gateways pointed at the same master read
        self.affinity_routing = affinity_routing
        self.affinity_max_imbalance = affinity_max_imbalance
        self.prefix_block = prefix_block
        self.digest_map = FleetDigestMap()
        self.directory = directory or (
            PrefixDirectory(kv) if kv is not None else None
        )
        # predictive scaling: serving telemetry flows into the brain
        # datastore each pump; the registered forecast algorithm
        # turns the sample window into a chip-denominated hint that
        # reaches the advisor BEFORE reactive pressure does
        self.brain_store = brain_store
        self.job_uuid = job_uuid
        self.forecast_algorithm = forecast_algorithm
        self._lock = threading.Lock()
        self._replicas: Dict[str, InferenceReplica] = {}
        self._last_hint_ts = 0.0
        # incrementally-maintained load order: submit() reads this
        # cached ranking in O(candidates); heartbeats, membership
        # changes, and ejections mark it dirty for re-rank
        self._ranked: List[InferenceReplica] = []
        self._rank_dirty = True
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- membership ------------------------------------------------------

    def _new_breaker(self, replica_id: str = "") -> CircuitBreaker:
        seed = None
        if self.breaker_jitter_seed is not None:
            # decorrelate per replica, deterministically: same pool
            # seed + same id = same jitter stream across runs
            seed = (
                self.breaker_jitter_seed
                + zlib.crc32(replica_id.encode())
            ) & 0xFFFFFFFF
        return CircuitBreaker(
            max_strikes=self.max_strikes,
            backoff_base_s=self.breaker_backoff_base_s,
            backoff_max_s=self.breaker_backoff_max_s,
            clock=self._clock,
            jitter_seed=seed,
        )

    def add(self, replica: InferenceReplica):
        if replica.kv is None:
            replica.kv = self.kv
        with self._lock:
            self._replicas[replica.id] = replica
            self.breakers[replica.id] = self._new_breaker(replica.id)
        sched = replica.scheduler
        if self.manager is not None and sched.on_failure is None:
            sched.on_failure = self.manager.on_scheduler_failure
        if (
            replica.role == "prefill"
            and getattr(sched, "on_handoff", None) is None
        ):
            sched.on_handoff = self.handoff.on_prefill_done
        self.mark_rank_dirty()
        replica.register()

    def remove(self, replica_id: str) -> Optional[InferenceReplica]:
        self._drop_affinity(replica_id)
        self.mark_rank_dirty()
        if self._sentinel is not None:
            self._sentinel.forget(replica_id)
        with self._lock:
            self._straggler_fenced = (
                self._straggler_fenced - {replica_id}
            )
            return self._replicas.pop(replica_id, None)

    def replicas(self) -> List[InferenceReplica]:
        with self._lock:
            return list(self._replicas.values())

    def healthy_replicas(self) -> List[InferenceReplica]:
        return [r for r in self.replicas() if r.healthy]

    # ---- routing ---------------------------------------------------------

    def mark_rank_dirty(self) -> None:
        """Invalidate the cached load ranking. Called on membership
        changes and every heartbeat/ejection/readmission pass — the
        events that actually move relative load — so the submit hot
        path never pays an O(n log n) sort per request."""
        with self._lock:
            self._rank_dirty = True

    def ranked_replicas(self) -> List[InferenceReplica]:
        """Healthy replicas in cached ascending-load order. Re-ranks
        lazily when the dirty flag is set; between re-ranks the order
        may lag live load by at most one heartbeat interval, which is
        exactly the staleness the imbalance cap and the try-each-
        candidate admission loop already absorb. The sort itself runs
        OUTSIDE the pool lock (load() takes scheduler locks)."""
        with self._lock:
            if not self._rank_dirty:
                return [r for r in self._ranked if r.healthy]
            live = [
                r for r in self._replicas.values() if r.healthy
            ]
            self._rank_dirty = False
        live.sort(key=lambda r: r.load())
        with self._lock:
            self._ranked = live
        return list(live)

    def _refresh_affinity(self, rep: InferenceReplica) -> None:
        """Heartbeat-path digest refresh: mirror the replica's
        published prefixes into the in-process map and the shared KV
        directory. Directory blips are logged, never raised — the
        fleet falls back to in-process routing."""
        if not self.affinity_routing:
            return
        digests = rep.prefix_digests()
        self.digest_map.update(
            rep.id, digests, host_digests=rep.kv_tier_digests()
        )
        if self.directory is not None:
            try:
                self.directory.publish(rep.id, digests)
            except Exception:  # noqa: BLE001 — master blip ≠ outage
                logger.warning(
                    "prefix directory publish failed for %s",
                    rep.id, exc_info=True,
                )
        if self.metrics is not None:
            setter = getattr(
                self.metrics, "set_digest_map_size", None
            )
            if setter is not None:
                setter(self.digest_map.size())

    def _drop_affinity(self, replica_id: str) -> None:
        """Eager digest eviction for a dead/removed replica: the map
        must never hold a route to a corpse (chaos invariant — no
        stale routes after a crash)."""
        self.digest_map.drop(replica_id)
        if self.directory is not None:
            try:
                self.directory.drop(replica_id)
            except Exception:  # noqa: BLE001 — master blip ≠ outage
                logger.warning(
                    "prefix directory drop failed for %s",
                    replica_id, exc_info=True,
                )

    def _prefix_block(self) -> int:
        """Digest block size: the pool knob when set, else the first
        engine's radix-cache block (all replicas share the model's
        bucketing), else the cache default."""
        if self.prefix_block:
            return self.prefix_block
        for r in self.replicas():
            cache = getattr(
                r.scheduler.engine, "prefix_cache", None
            )
            block = getattr(cache, "block", None)
            if block:
                self.prefix_block = int(block)
                return self.prefix_block
        return 16

    def routing_stats(self) -> dict:
        """Fleet-routing health block (gateway /healthz): digest-map
        occupancy plus the routing knobs in force."""
        out = dict(self.digest_map.stats())
        out["affinity_routing"] = self.affinity_routing
        out["max_imbalance"] = self.affinity_max_imbalance
        return out

    def submit(
        self,
        prompt: Sequence[int],
        max_new: Optional[int] = None,
        deadline_s: Optional[float] = None,
        adapter_id: Optional[str] = None,
        tier: Optional[str] = None,
    ) -> ServeRequest:
        """Affinity-aware routing with failover: try healthy replicas
        in preference order until one admits. Documented precedence,
        outermost first:

        0. STRAGGLER fence — a replica the health sentinel has
           flagged (step-latency EWMA over `straggler_ratio`× the
           fleet median for `straggler_patience` consecutive passes)
           sorts behind EVERY healthy candidate, whatever its
           affinity or load: its in-flight requests finish, but new
           work reaches it only when nobody else admits. Off (no
           sort) with straggler_ratio=0.
        1. PHASE tier — new requests start with a prefill, so
           prefill-role replicas take them first (decode-role
           replicas only receive work through the handoff
           coordinator); with no prefill replica, colocated ones
           serve as always, and decode-role replicas are the last
           resort (they CAN serve end-to-end — better than a 503).
        2. PREFIX AFFINITY — within the tier, the replica whose
           advertised digest map holds the longest block-aligned
           prefix of this prompt wins (a hit skips the prefill of
           the matched tokens entirely), UNLESS its load exceeds the
           coolest candidate's by more than `affinity_max_imbalance`
           — the cap that keeps a hot prefix from starving the
           fleet.
        3. SLO TIER spread — within equal affinity depth, replicas
           with the shallowest same-tier wait queue are tried first,
           so one replica never accumulates the fleet's whole
           latency (or batch) class while its peers idle; an
           affinity hit still dominates (re-hitting a warm prefix
           beats an even queue).
        4. ADAPTER residency — next, replicas whose device bank
           already holds `adapter_id` are tried first (residency
           skips the host→device upload).
        5. LOAD — final tiebreak, from the incrementally-maintained
           ranking (mark_rank_dirty/ranked_replicas), so the hot
           path is O(candidates), not O(n log n) per request.

        With no digest match anywhere (or affinity off) the order
        degrades to exactly the old adapter-then-least-loaded
        routing, and a full fleet still falls back to least-loaded
        through the try-each-candidate loop. Routing changes WHERE a
        request runs, never WHAT it emits — the engines are
        deterministic, so tokens are byte-identical to an unrouted
        oracle."""
        ranked = self.ranked_replicas()
        candidates = (
            [r for r in ranked if r.role == "prefill"]
            or [r for r in ranked if r.role == "colocated"]
            or ranked
        )
        if adapter_id is not None and len(candidates) > 1:
            candidates = sorted(
                candidates,
                key=lambda r: adapter_id not in r.adapters_resident(),
            )  # stable: load order preserved within each half
        if tier is not None and len(candidates) > 1:
            # stable over the adapter+load order: same-tier waiting
            # depth decides, earlier keys break its ties (duck-typed
            # — schedulers without tier heaps count as depth 0)
            candidates = sorted(
                candidates,
                key=lambda r: _tier_wait_depth(r, tier),
            )
        depths: Dict[str, int] = {}
        capped: List[InferenceReplica] = []
        if self.affinity_routing and len(candidates) > 1:
            chain = prefix_digest_chain(
                prompt, self._prefix_block()
            )
            if chain:
                depths = self.digest_map.match_depths(chain)
            if depths:
                # stable over the adapter+load order, so affinity
                # dominates and the earlier keys break its ties
                candidates = affinity_order(
                    candidates,
                    depths,
                    lambda r: r.load(),
                    self.affinity_max_imbalance,
                    capped,
                )
        if self._sentinel is not None and len(candidates) > 1:
            with self._lock:
                fenced = self._straggler_fenced
            if fenced:
                # the LAST stable sort = the outermost precedence:
                # a fenced straggler loses to every healthy
                # candidate, affinity and load included
                candidates = sorted(
                    candidates, key=lambda r: r.id in fenced
                )
        if not candidates:
            # nothing can serve: record a scale-up hint (force bypasses
            # the cooldown — an empty pool is exactly the emergency the
            # rate limit must not suppress) before failing the request
            self.scale_hint(force=True)
            raise NoHealthyReplicasError("no healthy replicas")
        kw = {} if adapter_id is None else {"adapter_id": adapter_id}
        if tier is not None:
            kw["tier"] = tier
        last_err: Optional[AdmissionError] = None
        for rep in candidates:
            try:
                req = rep.scheduler.submit(
                    prompt, max_new=max_new, deadline_s=deadline_s,
                    **kw,
                )
            except AdmissionError as e:
                last_err = e
                continue
            if self.metrics is not None and self.affinity_routing:
                routed = getattr(
                    self.metrics, "affinity_routed", None
                )
                if routed is not None:
                    routed(
                        matched=depths.get(rep.id, 0) > 0
                        and rep not in capped,
                        capped=rep in capped,
                    )
            return req
        raise last_err

    # ---- health + scaling ------------------------------------------------

    def check_replicas(self):
        """One health round, per-replica isolated: a replica whose
        probe (or heartbeat) RAISES must not abort the rest of the
        pass or the background loop — the exception counts as that
        replica's failed probe and the round continues."""
        for rep in self.replicas():
            try:
                self._check_one(rep)
            except Exception:  # noqa: BLE001 — isolate per replica
                logger.exception(
                    "health check failed for replica %s", rep.id
                )
        if self._sentinel is not None:
            try:
                self._straggler_pass()
            except Exception:  # noqa: BLE001 — keep the round alive
                logger.exception("straggler pass failed")
        if self.metrics is not None:
            spf = getattr(self.metrics, "set_preflight_failed", None)
            if spf is not None:
                spf(
                    sum(
                        1
                        for r in self.replicas()
                        if not getattr(r, "preflight_ok", True)
                    )
                )

    def _check_one(self, rep: InferenceReplica):
        """Breaker-driven health step for one replica.

        CLOSED: probe normally; `max_strikes` consecutive failures
        trip the breaker (ejection from routing). OPEN: skip probing
        entirely until the exponential-backoff deadline — a dead
        replica must not eat a probe (and a heartbeat write) every
        pass. Past the deadline, HALF_OPEN: one probation probe. A
        clean probe re-admits the replica — restarting its scheduler
        first if it crashed (engine reset, empty queue). A failed
        probation re-trips with doubled backoff."""
        with self._lock:
            breaker = self.breakers.get(rep.id)
            if breaker is None:  # replica added behind the pool's back
                breaker = self.breakers[rep.id] = self._new_breaker(
                    rep.id
                )
        if not breaker.should_probe():
            return
        try:
            ok = rep.probe()
        except Exception:  # noqa: BLE001 — a raising probe = failed
            logger.exception("replica %s probe raised", rep.id)
            ok = False
        if ok and rep.scheduler.crashed:
            # probes pass again (fault cleared) but the engine died
            # mid-serve: probation includes the rebuild
            ok = rep.restart()
        if ok:
            # degraded-but-alive is NOT a breaker matter: a shrunk
            # replica still serves, so it must not accrue strikes (in
            # HALF_OPEN a single record_failure would re-trip). The
            # elastic check shrinks/grows it under the scheduler lock.
            self._elastic_check(rep)
            breaker.record_success()
            rep.strikes = 0
            if not rep.healthy:
                logger.info("replica %s recovered", rep.id)
                rep.healthy = True
                if self.metrics is not None:
                    self.metrics.replica_readmitted()
            rep.heartbeat()
            # heartbeat moment = the load/digest refresh moment: the
            # cached ranking re-sorts lazily and the affinity map
            # mirrors the cache's current published set
            self._refresh_affinity(rep)
            self.mark_rank_dirty()
        else:
            breaker.record_failure()
            rep.strikes = breaker.strikes
            if breaker.state == OPEN and rep.healthy:
                rep.healthy = False
                if self.metrics is not None:
                    self.metrics.replica_ejected()
                # a dead replica's digests leave the map NOW, not at
                # the next heartbeat — no request may be steered at
                # a corpse by its pre-crash advertisement
                self._drop_affinity(rep.id)
                self.mark_rank_dirty()
                logger.warning(
                    "replica %s ejected (breaker open, retry in "
                    "%.2fs)", rep.id, breaker.retry_in_s,
                )

    def _straggler_pass(self) -> None:
        """One fleet-relative straggler round (serving/health.py):
        feed every healthy replica's published step-latency EWMA to
        the sentinel, evaluate the outlier test, and apply the graded
        escalation — suspect replicas just logged (their probe
        already ran this round), fenced replicas deprioritized in
        submit(), persistent stragglers breaker-opened so probation
        owns the rejoin. Recovery is automatic: back under the fence
        the strikes reset, the flag drops, and routing resumes."""
        det = self._sentinel
        for rep in self.healthy_replicas():
            det.observe(rep.id, rep.step_latency())
        det.evaluate()
        fenced = set()
        for rep in self.replicas():
            if not rep.healthy:
                continue
            lvl = det.level(rep.id)
            if lvl >= _health.LEVEL_EJECT:
                # terminal escalation: open the breaker — the same
                # ejection path a crashed replica takes, probation
                # re-probe included. The sentinel forgets it so a
                # frozen EWMA cannot re-flag the corpse.
                with self._lock:
                    breaker = self.breakers.get(rep.id)
                if breaker is not None:
                    breaker.trip()
                rep.healthy = False
                self._drop_affinity(rep.id)
                det.forget(rep.id)
                self.mark_rank_dirty()
                if self.metrics is not None:
                    self.metrics.replica_ejected()
                logger.warning(
                    "replica %s ejected as a persistent straggler "
                    "(%.1fms EWMA)", rep.id,
                    rep.step_latency() * 1000.0,
                )
            elif lvl >= _health.LEVEL_FENCED:
                fenced.add(rep.id)
                logger.warning(
                    "replica %s fenced as a straggler (%.1fms EWMA, "
                    "ratio %.1fx over fleet median for %d+ passes)",
                    rep.id, rep.step_latency() * 1000.0,
                    det.ratio, det.patience,
                )
            elif lvl >= _health.LEVEL_SUSPECT:
                logger.info(
                    "replica %s is a straggler suspect (%.1fms EWMA)",
                    rep.id, rep.step_latency() * 1000.0,
                )
        with self._lock:
            changed = fenced != set(self._straggler_fenced)
            self._straggler_fenced = frozenset(fenced)
        if changed:
            self.mark_rank_dirty()
        if self.metrics is not None:
            upd = getattr(self.metrics, "update_straggler", None)
            if upd is not None:
                upd(det.stats())

    def health_stats(self) -> dict:
        """Sentinel health block (gateway /healthz): preflight
        outcomes plus the straggler detector's live view. Cheap —
        flags and counters only, no probes run here."""
        reps = self.replicas()
        out: dict = {
            "preflight_enabled": sum(
                1
                for r in reps
                if getattr(r, "preflight_check", False)
            ),
            "preflight_failed": sum(
                1
                for r in reps
                if not getattr(r, "preflight_ok", True)
            ),
        }
        if self._sentinel is not None:
            out.update(self._sentinel.stats())
            with self._lock:
                out["straggler_fenced"] = sorted(
                    self._straggler_fenced
                )
        return out

    def _elastic_check(self, rep: InferenceReplica) -> None:
        """Degraded-state step for one HEALTHY replica: consult the
        engine's device health and re-form its mesh live when the
        slice changed — shrink while chips are missing, grow back
        toward the constructed slice on the probation re-probe once
        they return. Runs through the scheduler's lock-held
        resize_engine so it never races a dispatch. The chip-
        denominated scale hint reprices automatically: it live-reads
        engine.n_chips, which a resize mutates."""
        if not self.elastic_resize:
            return
        eng = rep.scheduler.engine
        health_fn = getattr(eng, "device_health", None)
        resize = getattr(rep.scheduler, "resize_engine", None)
        if health_fn is None or resize is None:
            return
        health = health_fn()
        lost = int(health.get("chips_lost", 0))
        if lost > 0 and not rep.degraded:
            rep.degraded = True
            logger.warning(
                "replica %s degraded: %d of %d chip(s) lost",
                rep.id, lost, int(health.get("chips_total", 0)),
            )
            if self.metrics is not None:
                degr = getattr(self.metrics, "replica_degraded", None)
                if degr is not None:
                    degr()
        try:
            # resize toward whatever the surviving slice supports —
            # a no-op (reported, not rebuilt) when the engine already
            # runs at the right tp, so steady-state probes are cheap
            report = resize(None)
        except Exception:  # noqa: BLE001 — resize failure ≠ probe failure
            logger.exception(
                "elastic resize of replica %s failed", rep.id
            )
            return
        if report is not None and report.direction != "noop":
            logger.warning(
                "replica %s resized tp=%d -> tp=%d (%s), %d "
                "request(s) replaying",
                rep.id, report.old_tp, report.new_tp,
                report.direction, report.replayed,
            )
            # re-certify the re-formed mesh before trusting it with
            # traffic — an elastic resize is exactly the moment a
            # gray chip sneaks back in. Failing closed: a bad probe
            # re-degrades the replica below.
            if rep.preflight_check:
                rep.run_preflight()
        if (
            lost == 0
            and rep.degraded
            and getattr(rep, "preflight_ok", True)
        ):
            rep.degraded = False
            logger.info(
                "replica %s restored to its full slice", rep.id
            )

    def aggregate_pressure(self) -> float:
        reps = self.healthy_replicas()
        if not reps:
            return 1.0
        return sum(r.scheduler.pressure() for r in reps) / len(reps)

    def scale_hint(self, force: bool = False) -> Optional[dict]:
        """Fold queue pressure into an up/down/hold hint, write it to
        the master KV store, and hand it to the advisor. Rate-limited
        by `hint_cooldown_s` so a pressure spike cannot flap the
        scaler (force=True bypasses, for tests)."""
        now = time.monotonic()
        # atomic check-and-stamp: the pool thread and a submit(force)
        # on a request thread race here — without the lock both could
        # pass the cooldown and double-write the hint
        with self._lock:
            if (
                not force
                and now - self._last_hint_ts < self.hint_cooldown_s
            ):
                return None
            self._last_hint_ts = now
        reps = self.healthy_replicas()
        n = len(reps)
        pressure = self.aggregate_pressure()
        if not reps:
            direction, target = "up", 1
        else:
            slo = reps[0].scheduler.slo
            if pressure > slo.pressure_high:
                direction, target = "up", n + 1
            elif pressure < slo.pressure_low and n > 1:
                direction, target = "down", n - 1
            else:
                direction, target = "hold", n
        # chip denomination: the advisor reasons in chips (= replicas
        # × mesh slice size), so the hint carries the pool's slice
        # width alongside the replica counts. Heterogeneous pools take
        # the widest slice — over-asking by a partial slice beats
        # under-provisioning a replica that cannot be placed.
        cpr = max(
            (
                int(getattr(r.scheduler.engine, "n_chips", 1))
                for r in reps
            ),
            default=1,
        )
        hint = {
            "direction": direction,
            "replicas": target,
            "current": n,
            "pressure": round(pressure, 4),
            # wall clock: the auto-scaler's staleness check compares
            # it across hosts
            "ts": time.time(),
            "chips_per_replica": cpr,
            "chips": target * cpr,
            "current_chips": n * cpr,
        }
        if self.kv is not None:
            try:
                _kv_set(
                    self.kv, SCALE_HINT_KEY, json.dumps(hint).encode()
                )
            except Exception:  # noqa: BLE001 — master blip ≠ serving outage
                logger.warning(
                    "scale hint write failed (master unreachable?)",
                    exc_info=True,
                )
        if self.advisor is not None and direction != "hold":
            try:
                self.advisor(hint)
            except Exception:  # noqa: BLE001
                logger.exception("scale advisor failed on %s", hint)
        return hint

    # ---- predictive scaling (L4 -> L7 -> L6) -----------------------------

    def _chips_per_replica(self) -> int:
        """Widest healthy mesh slice (same rule as scale_hint):
        over-asking by a partial slice beats under-provisioning a
        replica that cannot be placed."""
        return max(
            (
                int(getattr(r.scheduler.engine, "n_chips", 1))
                for r in self.healthy_replicas()
            ),
            default=1,
        )

    def publish_telemetry(self):
        """One fleet-level RuntimeSample into the brain datastore:
        total queue depth, aggregate pressure, warm-TTFT p50, prefix
        hit rate, and the chip denomination (num_nodes = healthy
        chips). The forecast algorithm reads this series newest-first
        — the L4→L7 leg of the paper's telemetry loop. No-op without
        a configured store."""
        if self.brain_store is None:
            return None
        # local import: serving stays importable (and the routing hot
        # path stays brain-free) when the brain layer isn't deployed
        from dlrover_tpu_torch.brain.datastore import RuntimeSample

        reps = self.healthy_replicas()
        queue_depth = 0
        chips = 0
        hits = 0
        misses = 0
        for r in reps:
            tele_fn = getattr(r.scheduler, "telemetry", None)
            if callable(tele_fn):
                tele = tele_fn()
            else:  # test doubles predating telemetry()
                tele = {"queue_depth": r.scheduler.queue_depth()}
            queue_depth += int(tele.get("queue_depth", 0))
            chips += int(tele.get("n_chips", 1))
            hits += int(tele.get("prefix_hits", 0))
            misses += int(tele.get("prefix_misses", 0))
        hit_rate = hits / (hits + misses) if hits + misses else 0.0
        ttft_p50 = 0.0
        tokens_per_sec = 0.0
        m = self.metrics
        if m is not None:
            quant = getattr(m, "ttft_quantiles", None)
            if quant is not None:
                ttft_p50 = float(quant().get(0.5, 0.0))
            tokens_per_sec = m.tokens_per_sec()
        sample = RuntimeSample(
            job_uuid=self.job_uuid,
            role="serving",
            num_nodes=chips,
            cpu_percent=round(self.aggregate_pressure() * 100, 2),
            samples_per_sec=tokens_per_sec,
            queue_depth=queue_depth,
            ttft_ms=ttft_p50,
            cache_hit_rate=round(hit_rate, 4),
        )
        try:
            self.brain_store.add_sample(sample)
        except Exception:  # noqa: BLE001 — telemetry blip ≠ outage
            logger.warning(
                "brain telemetry write failed", exc_info=True
            )
            return None
        return sample

    def predictive_scale(self) -> Optional[dict]:
        """Run the registered demand forecast over the serving sample
        window and, when it disagrees with current capacity, emit a
        chip-denominated FORECAST hint through the same KV + advisor
        path the reactive hint takes (the advisor's hysteresis keeps
        the two sources from flapping against each other and against
        elastic shrink/grow). Returns the hint, or None when the
        forecast holds. No-op without a brain store."""
        if self.brain_store is None:
            return None
        from dlrover_tpu_torch.brain.algorithms import (
            OptimizeContext,
            run_algorithm,
        )

        n = len(self.healthy_replicas())
        cpr = self._chips_per_replica()
        ctx = OptimizeContext(
            job_uuid=self.job_uuid,
            store=self.brain_store,
            current={
                "serving": {
                    "count": n,
                    "chips_per_replica": cpr,
                }
            },
        )
        try:
            delta = run_algorithm(self.forecast_algorithm, ctx)
        except Exception:  # noqa: BLE001 — forecast blip ≠ outage
            logger.exception(
                "serving forecast %s failed", self.forecast_algorithm
            )
            return None
        if delta.empty or delta.count is None or delta.count == n:
            return None
        target = int(delta.count)
        chips = (
            int(delta.chips)
            if getattr(delta, "chips", None)
            else target * cpr
        )
        hint = {
            "direction": "up" if target > n else "down",
            "replicas": target,
            "current": n,
            "pressure": round(self.aggregate_pressure(), 4),
            # wall clock: the auto-scaler's staleness check compares
            # it across hosts
            "ts": time.time(),
            "chips_per_replica": cpr,
            "chips": chips,
            "current_chips": n * cpr,
            "source": "forecast",
            "reason": delta.reason,
        }
        if self.kv is not None:
            try:
                _kv_set(
                    self.kv, SCALE_HINT_KEY,
                    json.dumps(hint).encode(),
                )
            except Exception:  # noqa: BLE001 — master blip ≠ outage
                logger.warning(
                    "forecast hint write failed "
                    "(master unreachable?)", exc_info=True,
                )
        if self.metrics is not None:
            emitted = getattr(
                self.metrics, "forecast_emitted", None
            )
            if emitted is not None:
                emitted(hint["direction"], chips)
        if self.advisor is not None:
            try:
                self.advisor(hint)
            except Exception:  # noqa: BLE001
                logger.exception(
                    "scale advisor failed on forecast %s", hint
                )
        return hint

    # ---- background loop -------------------------------------------------

    def start(self, interval: float = 5.0):
        """Run health checks + heartbeats + scale hints periodically."""
        if self._thread is not None:
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(interval):
                try:
                    self.check_replicas()
                    self.scale_hint()
                    self.publish_telemetry()
                    self.predictive_scale()
                except Exception:  # noqa: BLE001 — keep the pool alive
                    logger.exception("replica pool iteration failed")

        self._thread = threading.Thread(
            target=_loop, name="replica-pool", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            self._thread = None
        for rep in self.replicas():
            rep.stop()
