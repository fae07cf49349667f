"""SLO-aware request scheduling over the generation engine's slot bank
— a copy of dlrover_tpu/serving/scheduler.py over the port's engine.

The engine (serving/engine.py) is a pure batching machine: it decodes
whatever occupies its slots. This module is the policy layer in front
of it — the piece vLLM calls the scheduler and DLRover's master calls
admission:

- admission control: a bounded wait queue (`max_queue_depth`) and a
  per-request token budget (`max_new_tokens`) reject work the replica
  cannot promise to serve, at submit time, with a typed error the
  gateway maps to HTTP 429 — instead of queueing unboundedly and
  missing every deadline at once.
- priority tiers: every request carries an SLO class in TIERS
  ("latency" | "standard" | "batch"). Each tier is its own EDF heap;
  dispatch is strict priority across tiers (admit from the highest
  non-empty heap), EDF within a tier. An aging escalator promotes a
  waiting request one tier per `tier_aging_s` waited, so batch work
  is starvation-free by construction: after at most
  (len(TIERS)-1) * tier_aging_s it competes in the latency heap,
  where its fixed deadline eventually beats every later-submitted
  arrival under EDF.
- admission preemption: when the next waiter is latency-tier and no
  slot (or paged-KV headroom) is free, the scheduler evicts the
  coldest running batch-tier request — snapshot its resume ticket
  (journaled PRNG key + emitted tokens), cancel its slot, and requeue
  it at the back of the batch heap. Resume is the failover
  replay-prefill path: greedy byte-identical, sampled continuing the
  journaled key stream. This is the Podracer move — batch fills the
  spare capacity, latency traffic reclaims it on demand. Admission
  preemption lives HERE (and the page machinery in paged_kv.py),
  never in the engine or pool; the engine's own
  _preempt_slot remains the orthogonal memory-pressure swap.
- EDF dispatch: waiting requests are admitted earliest-deadline-first
  into freed slots (a deadline is an SLO, so the queue is a deadline
  heap, not FIFO).
- deadline shedding: a request whose deadline passes while it still
  waits is shed — it would burn slot time to miss its SLO anyway, and
  shedding it early keeps the queue honest for the requests behind it.
  Requests already decoding are never shed (their tokens are sunk
  cost about to pay off). Sheds are attributed to the request's tier.

Tokens stream out per engine chunk through each request's stream
queue; the gateway forwards them as they land, so TTFT is one chunk
away from admission, not one full generation away.
"""

import dataclasses
import enum
import heapq
import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.serving import handoff as handoff_mod
from dlrover_tpu_torch.serving.adapters import AdapterCacheFull
from dlrover_tpu_torch.serving.chaos import ChipLost
from dlrover_tpu_torch.serving.engine import ContinuousBatcher
from dlrover_tpu_torch.serving.failover import (
    RequestJournal,
    ResumeTicket,
    pin_key,
)
from dlrover_tpu_torch.serving.metrics import ServingMetrics

# SLO classes, highest priority first. Index order IS dispatch order:
# the pump admits from the first non-empty tier heap. The last tier
# ("batch") is the only preemptible one — Podracer's fill-the-gaps
# work, evicted when a latency request would otherwise miss admission.
TIERS = ("latency", "standard", "batch")
TIER_RANK = {t: i for i, t in enumerate(TIERS)}


class AdmissionError(RuntimeError):
    """Request rejected at admission (queue full / budget exceeded);
    the gateway maps this to HTTP 429."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    SHED = "shed"
    FAILED = "failed"        # crashed and exhausted its retry budget
    CANCELLED = "cancelled"  # client went away mid-stream


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """Admission + shedding policy knobs."""

    max_queue_depth: int = 64        # waiting requests before 429
    max_new_tokens: int = 512        # per-request token budget cap
    default_deadline_s: float = 60.0
    # queue-pressure thresholds driving replica scale hints
    pressure_high: float = 0.75
    pressure_low: float = 0.25
    # per-tenant admission quota: live (waiting + running) requests
    # one adapter id may hold before a 429 (0 = unlimited). Keeps a
    # single chatty tenant from pinning every engine slot while other
    # adapters starve in the queue.
    max_active_per_adapter: int = 0
    # per-tier admission quota: live (waiting + running) requests one
    # SLO class may hold before a 429 (absent / 0 = unlimited). The
    # tier analog of max_active_per_adapter — caps how much of the
    # replica batch traffic may occupy, so the spare-capacity filler
    # can never crowd out interactive admission in the first place.
    tier_budgets: Optional[Mapping[str, int]] = None
    # aging escalator: seconds a request waits per one-tier promotion
    # (0 disables). A batch request becomes standard after one period
    # and latency-eligible after two — the bounded-delay guarantee
    # behind "strict priority without starvation".
    tier_aging_s: float = 30.0


class ServeRequest:
    """One in-flight request: identity, SLO, and the token stream the
    gateway reads."""

    def __init__(
        self,
        req_id: int,
        prompt: np.ndarray,
        max_new: int,
        deadline: float,
        submit_ts: float,
        adapter_id: Optional[str] = None,
        tier: str = "standard",
    ):
        self.id = req_id
        self.prompt = prompt
        self.max_new = max_new
        self.deadline = deadline
        self.submit_ts = submit_ts
        # LoRA adapter this request decodes through (None = base
        # model). Carried across failover/readmit: replay must hit the
        # same adapter weights to stay byte-identical.
        self.adapter_id = adapter_id
        # SLO class: `tier` is the immutable label the client asked
        # for (budgets, metrics, and shed attribution key off it);
        # `effective_tier` is where the request currently competes —
        # the aging escalator promotes it toward "latency" while the
        # request waits, and it names the heap the entry lives in.
        self.tier = tier
        self.effective_tier = tier
        # admission preemptions survived (scheduler-level evictions
        # in favour of a latency-tier arrival; excludes the engine's
        # memory-pressure swaps, which are invisible up here)
        self.preemptions = 0
        self.state = RequestState.QUEUED
        self.tokens: List[int] = []
        self.first_token_ts: Optional[float] = None
        self.finish_ts: Optional[float] = None
        # failover state: the scheduler currently hosting the request
        # (re-pointed on re-admission), crash count, and the PRNG key
        # the next admission must continue from (None = engine draws)
        self.scheduler: Optional["RequestScheduler"] = None
        self.retries = 0
        self.prng_key: Optional[np.ndarray] = None
        # phase handoff: a KVHandoff package pinned by adopt() — the
        # next admission installs it instead of prefilling (single-use;
        # cleared at admission so later replays re-prefill plainly)
        self.handoff_pkg = None
        # chunks of newly emitted tokens; None terminates the stream
        self.stream: "queue.Queue[Optional[List[int]]]" = queue.Queue()
        self._finished = threading.Event()

    def engine_spec(self):
        """(prompt, max_new) for the next engine admission. After a
        crash the already-emitted tokens become part of the prompt —
        resume is a replay-prefill, not a re-generate — and the
        budget shrinks by what already shipped."""
        if not self.tokens:
            return self.prompt, self.max_new
        return (
            np.concatenate(
                [self.prompt, np.asarray(self.tokens, np.int32)]
            ),
            self.max_new - len(self.tokens),
        )

    def iter_stream(
        self, timeout: Optional[float] = None
    ) -> Iterator[List[int]]:
        """Yield token chunks until the stream ends (done or shed)."""
        while True:
            chunk = self.stream.get(timeout=timeout)
            if chunk is None:
                return
            yield chunk

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request finished (done or shed)."""
        return self._finished.wait(timeout)

    def _end(self, state: RequestState, ts: float):
        if self.finish_ts is not None:  # idempotent across failover
            return
        self.state = state
        self.finish_ts = ts
        self.stream.put(None)
        self._finished.set()

    def _end_done(self):
        """FailoverManager path: the crash landed after the request's
        last token — it is complete, not failed."""
        self._end(RequestState.DONE, _req_clock(self))

    def _end_failed(self):
        self._end(RequestState.FAILED, _req_clock(self))


def _req_clock(req: ServeRequest) -> float:
    sched = req.scheduler
    return sched._clock() if sched is not None else time.monotonic()


class RequestScheduler:
    """SLO-aware queue feeding one generation engine.

    Drive it either with the background thread (`start()`/`stop()` —
    the gateway path) or by calling `pump()` / `run_to_completion()`
    directly (tests, benches: deterministic, no thread)."""

    # cross-thread state shared by submit (request threads), pump
    # (driver thread), and the failover paths — every access must hold
    # self._lock/self._cond
    GUARDED_FIELDS = frozenset(
        {
            "_waiting",
            "_running",
            "_seq",
            "_next_id",
            "_adapter_rank",
            "crashed",
            "journal",
        }
    )

    def __init__(
        self,
        engine: ContinuousBatcher,
        slo: Optional[SloConfig] = None,
        metrics: Optional[ServingMetrics] = None,
        clock=time.monotonic,
        on_failure=None,
        on_handoff=None,
        handoff_transport: str = "device",
        max_handoff_retries: int = 2,
        elastic_resize: bool = True,
    ):
        self.engine = engine
        # chip loss mid-pump resizes the engine live (elastic.py)
        # instead of crashing the replica; off => ChipLost takes the
        # plain crash/failover path like any other engine failure
        self.elastic_resize = elastic_resize
        self.slo = slo or SloConfig()
        self.metrics = metrics or ServingMetrics()
        self._clock = clock
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        # one EDF heap PER TIER of (deadline, prompt_len, adapter_rank,
        # seq, request); dispatch walks TIERS in order (strict
        # priority) and pops EDF within the first non-empty heap. An
        # entry always lives in the heap named by its request's
        # effective_tier — the aging escalator moves entries between
        # heaps as they wait. First tiebreak is shortest-prompt-first:
        # among equal deadlines a long prefill must not convoy short
        # ones behind it (the prefill-phase analog of SJF). Second is
        # the adapter's first-seen ordinal — see _adapter_rank_of.
        # Final tiebreak is a scheduler-local sequence, NOT req.id: a
        # failover-readmitted request carries its id from ANOTHER
        # scheduler, and a collision would fall through to comparing
        # ServeRequests.
        self._waiting: Dict[str, List[Any]] = {t: [] for t in TIERS}
        self._seq = 0
        self._running: Dict[int, ServeRequest] = {}  # engine idx -> req
        self._next_id = 0
        # adapter-aware EDF tiebreak: a stable first-seen ordinal per
        # adapter id (base traffic = 0) slotted between prompt_len and
        # seq, so among equal deadlines same-adapter requests admit
        # adjacently — they share bank slots and cache pins, and
        # co-scheduling them keeps the device adapter cache from
        # ping-ponging under oversubscription.
        self._adapter_rank: Dict[str, int] = {}
        # crash handling: the journal holds per-request resume keys;
        # `on_failure(scheduler, tickets, exc)` — wired to the pool's
        # FailoverManager — re-homes in-flight work when the engine
        # raises. Without a callback, affected requests end FAILED.
        self.journal = RequestJournal()
        self.on_failure = on_failure
        # phase handoff (MPMD split): `on_handoff(scheduler, ticket,
        # package)` — wired to the pool's HandoffCoordinator — moves a
        # prefill-role engine's finished prefills to decode replicas.
        # Returning False (or raising) falls back to resume-by-replay.
        self.on_handoff = on_handoff
        self.handoff_transport = handoff_transport
        self.max_handoff_retries = max_handoff_retries
        self.crashed = False
        # per-replica step-latency EWMA (serving/health.py straggler
        # detection): wall time of engine.step() dispatches, smoothed
        # here and published through telemetry()/heartbeats so the
        # pool's fleet-relative outlier test never needs a new RPC.
        # Wall clock on purpose (not self._clock): a straggler is slow
        # in real time, and injected slowness (chaos.slow_replica)
        # sleeps in real time too.
        self._step_lat_ewma = 0.0
        self._step_lat_alpha = 0.25
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- admission -------------------------------------------------------

    def _adapter_rank_of_locked(self, adapter_id: Optional[str]) -> int:
        """First-seen ordinal for the EDF tiebreak (caller holds the
        lock). Base traffic sorts first (0) so adapterless requests
        never wait behind adapter-bank churn."""
        if adapter_id is None:
            return 0
        return self._adapter_rank.setdefault(
            adapter_id, len(self._adapter_rank) + 1
        )

    def _waiting_total_locked(self) -> int:
        """QUEUED entries across every tier heap (lazy-cancelled
        entries excluded). Caller holds the lock."""
        return sum(
            1
            for heap_ in self._waiting.values()
            for _, _, _, _, r in heap_
            if r.state is RequestState.QUEUED
        )

    def _push_waiting_locked(
        self, req: ServeRequest, prompt_len: int
    ) -> None:
        """Push one entry into the heap of the request's effective
        tier. Caller holds the lock."""
        heapq.heappush(
            self._waiting[req.effective_tier],
            (
                req.deadline,
                int(prompt_len),
                self._adapter_rank_of_locked(req.adapter_id),
                self._seq,
                req,
            ),
        )
        self._seq += 1

    def _adapter_load_locked(self, adapter_id: str) -> int:
        """Live (queued + running) requests held by one adapter id.
        Caller holds the lock."""
        n = sum(
            1
            for heap_ in self._waiting.values()
            for _, _, _, _, r in heap_
            if (
                r.state is RequestState.QUEUED
                and r.adapter_id == adapter_id
            )
        )
        return n + sum(
            1
            for r in self._running.values()
            if r.adapter_id == adapter_id
        )

    def _tier_load_locked(self, tier: str) -> int:
        """Live (queued + running) requests labelled with one tier —
        counted by the immutable label, not the escalated heap, so a
        tenant cannot dodge its budget by waiting out the aging
        escalator. Caller holds the lock."""
        n = sum(
            1
            for heap_ in self._waiting.values()
            for _, _, _, _, r in heap_
            if r.state is RequestState.QUEUED and r.tier == tier
        )
        return n + sum(
            1 for r in self._running.values() if r.tier == tier
        )

    def submit(
        self,
        prompt: Sequence[int],
        max_new: Optional[int] = None,
        deadline_s: Optional[float] = None,
        adapter_id: Optional[str] = None,
        tier: Optional[str] = None,
        prng_key: Optional[np.ndarray] = None,
    ) -> ServeRequest:
        """Admit one request or raise AdmissionError. Returns the
        handle whose `stream` yields token chunks as they decode.
        `prng_key` pins the sampling key the first engine admission
        uses (deterministic replay / parity tests); None lets the
        engine draw one."""
        arr = np.asarray(prompt, np.int32)
        slo = self.slo
        want = max_new or min(self.engine.max_new, slo.max_new_tokens)
        tier = tier or "standard"
        if tier not in TIERS:
            self.metrics.request_rejected()
            raise AdmissionError(
                f"unknown tier {tier!r} (expected one of {TIERS})"
            )
        with self._cond:
            if self.crashed:
                self.metrics.request_rejected()
                raise AdmissionError("replica crashed, pending restart")
            if self._waiting_total_locked() >= slo.max_queue_depth:
                self.metrics.request_rejected()
                raise AdmissionError(
                    f"queue full ({slo.max_queue_depth} waiting)"
                )
            if want > slo.max_new_tokens:
                self.metrics.request_rejected()
                raise AdmissionError(
                    f"token budget: max_new {want} > "
                    f"{slo.max_new_tokens}"
                )
            if arr.ndim != 1 or arr.size == 0:
                self.metrics.request_rejected()
                raise AdmissionError("prompt must be non-empty 1-D")
            # mirrors engine.submit()'s room-to-generate check — and
            # stays correct with the prefix cache on: even a fully
            # cached prompt still needs one cell past the prompt
            # (limit >= p+1), and the engine clamps a matched depth
            # until the SUFFIX bucket fits max_len, so no prompt the
            # engine accepts cold becomes inadmissible warm (pinned by
            # tests/test_serving_prefix_cache.py::test_admission_checks_agree)
            if arr.size + 1 > self.engine.max_len:
                self.metrics.request_rejected()
                raise AdmissionError(
                    f"prompt length {arr.size} leaves no room to "
                    f"generate (max_len {self.engine.max_len})"
                )
            if adapter_id is not None:
                reg = getattr(self.engine, "adapter_registry", None)
                if reg is None or adapter_id not in reg:
                    self.metrics.request_rejected()
                    raise AdmissionError(
                        f"unknown adapter {adapter_id!r}"
                    )
                quota = slo.max_active_per_adapter
                if (
                    quota > 0
                    and self._adapter_load_locked(adapter_id) >= quota
                ):
                    self.metrics.request_rejected()
                    raise AdmissionError(
                        f"adapter {adapter_id!r} at its per-tenant "
                        f"quota ({quota} active)"
                    )
            budget = int((slo.tier_budgets or {}).get(tier, 0))
            if budget > 0 and self._tier_load_locked(tier) >= budget:
                self.metrics.request_rejected()
                raise AdmissionError(
                    f"tier {tier!r} at its admission budget "
                    f"({budget} active)"
                )
            now = self._clock()
            req = ServeRequest(
                req_id=self._next_id,
                prompt=arr,
                max_new=want,
                deadline=now + (deadline_s or slo.default_deadline_s),
                submit_ts=now,
                adapter_id=adapter_id,
                tier=tier,
            )
            self._next_id += 1
            req.scheduler = self
            if prng_key is not None:
                req.prng_key = pin_key(prng_key)
            self._push_waiting_locked(req, arr.size)
            self.metrics.request_submitted()
            self.metrics.tier_admitted(tier)
            self.metrics.set_queue_depth(self._waiting_total_locked())
            self._cond.notify_all()
            return req

    # ---- queries ---------------------------------------------------------

    def queue_depth(self) -> int:
        with self._lock:
            return self._waiting_total_locked()

    def tier_queue_depths(self) -> Dict[str, int]:
        """QUEUED entries per tier heap (by effective tier — where
        they currently compete). The pool's tier-aware routing sort
        reads this to spread same-tier waiting across replicas."""
        with self._lock:
            return {
                t: sum(
                    1
                    for _, _, _, _, r in heap_
                    if r.state is RequestState.QUEUED
                )
                for t, heap_ in self._waiting.items()
            }

    def active_count(self) -> int:
        with self._lock:
            return len(self._running)

    def pressure(self) -> float:
        """Waiting load relative to the admission bound, in [0, 1+]."""
        with self._lock:
            return self._waiting_total_locked() / max(
                1, self.slo.max_queue_depth
            )

    def telemetry(self) -> Dict[str, float]:
        """One replica-level observation for the fleet telemetry
        publisher (ReplicaPool.publish_telemetry): waiting/active
        load plus the engine's prefix-cache traffic read from the
        radix cache itself — summable across replicas, unlike the
        shared exposition's max()-guarded copies. Zeros when the
        cache is off."""
        cache = getattr(self.engine, "prefix_cache", None)
        with self._lock:
            waiting = self._waiting_total_locked()
            running = len(self._running)
        return {
            "queue_depth": waiting,
            "active": running,
            "pressure": waiting / max(1, self.slo.max_queue_depth),
            "prefix_hits": int(getattr(cache, "hits", 0)),
            "prefix_misses": int(getattr(cache, "misses", 0)),
            "n_chips": int(getattr(self.engine, "n_chips", 1)),
            "step_latency_s": float(self._step_lat_ewma),
        }

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._running) or any(
                self._waiting[t] for t in TIERS
            )

    # ---- the loop --------------------------------------------------------

    def _shed_expired_locked(self, now: float):
        """Shed every WAITING request whose deadline already passed
        (each tier heap is deadline-ordered, so within a tier they
        sit at the front). The shed is attributed to the request's
        OWN tier — the class that missed its SLO — not a global
        count. Cancelled entries linger in the heaps until they
        surface here or at admission (lazy removal) — just drop
        them. Caller holds self._cond (the _locked convention)."""
        for heap_ in self._waiting.values():
            while heap_:
                deadline, _, _, _, req = heap_[0]
                if req.state is not RequestState.QUEUED:
                    heapq.heappop(heap_)
                    continue
                if deadline > now:
                    break
                heapq.heappop(heap_)
                req._end(RequestState.SHED, now)
                self.journal.close(req)
                self.metrics.request_shed(req.tier)
                logger.info(
                    "shed request %d (tier %s): deadline passed "
                    "%.3fs ago in queue",
                    req.id, req.tier, now - req.deadline,
                )

    def _escalate_aged_locked(self, now: float):
        """Aging escalator: promote waiting requests one tier per
        `tier_aging_s` waited since submission (computed from the
        IMMUTABLE base tier, so repeated scans are idempotent and a
        preempted-then-requeued batch request keeps its seniority).
        The heap entry moves with the request — its deadline key is
        unchanged, so per-tier EDF order and front-shedding stay
        intact. Caller holds the lock."""
        aging = self.slo.tier_aging_s
        if aging <= 0:
            return
        for ti in range(1, len(TIERS)):
            heap_ = self._waiting[TIERS[ti]]
            if not heap_:
                continue
            keep, moved = [], []
            for entry in heap_:
                req = entry[-1]
                if req.state is not RequestState.QUEUED:
                    continue  # lazy-drop cancelled entries
                target = max(
                    0,
                    TIER_RANK[req.tier]
                    - int((now - req.submit_ts) / aging),
                )
                if target < ti:
                    moved.append((entry, target))
                else:
                    keep.append(entry)
            if not moved:
                continue
            heapq.heapify(keep)
            self._waiting[TIERS[ti]] = keep
            for entry, target in moved:
                req = entry[-1]
                req.effective_tier = TIERS[target]
                heapq.heappush(self._waiting[TIERS[target]], entry)
                self.metrics.tier_escalated(req.tier)
                logger.info(
                    "escalated request %d: tier %s -> %s after "
                    "%.1fs waiting",
                    req.id, req.tier, req.effective_tier,
                    now - req.submit_ts,
                )

    def _peek_next_locked(self):
        """(tier, request) at the front of the highest-priority
        non-empty heap, dropping lazily-cancelled entries on the way;
        (None, None) when nothing waits. Caller holds the lock."""
        for tier in TIERS:
            heap_ = self._waiting[tier]
            while heap_ and heap_[0][-1].state is not RequestState.QUEUED:
                heapq.heappop(heap_)
            if heap_:
                return tier, heap_[0][-1]
        return None, None

    def _preempt_for_admission_locked(self) -> bool:
        """Evict the coldest RUNNING batch-tier request so a
        latency-tier arrival can admit: snapshot its resume ticket
        (emitted tokens fold into the replay prompt; the journaled
        key continues the sampling stream), cancel its engine slot
        (which frees the slot, its pages, and any prefix/adapter
        pins), and requeue it in the batch heap. Resume is the
        failover replay path, so the preempted request's final bytes
        are identical to an undisturbed run. "Coldest" is the
        engine's own footprint measure (request_progress — same
        quantity its memory-pressure swap orders by); a victim still
        in the engine queue has no footprint at all and is preferred.
        Returns True if a slot was freed. Caller holds the lock.

        This is the ONLY admission-preemption site in the serving
        stack: the engine and pool never evict
        for admission on their own."""
        progress = getattr(self.engine, "request_progress", None)
        victim_idx = None
        victim_key = None
        for idx, r in self._running.items():
            if r.effective_tier != TIERS[-1]:
                continue
            prog = progress(idx) if progress is not None else None
            # three coldness classes, coldest first: engine-queued
            # (no footprint at all), mid-prefill (the engine reports
            # NEGATIVE progress — prompt consumed, zero tokens
            # emitted: replay regenerates nothing), then decoding
            # ranked by resident KV cells. The old None->-1 sentinel
            # cannot survive real negative progress: a deeply
            # mid-prefill slot (say -40) would rank COLDER than an
            # engine-queued request (-1) that has no footprint at
            # all, and the sentinel would alias a slot one cell shy
            # of its prompt end.
            if prog is None:
                key = (0, 0, idx)
            elif prog < 0:
                key = (1, prog, idx)
            else:
                key = (2, prog, idx)
            if victim_key is None or key < victim_key:
                victim_key, victim_idx = key, idx
        if victim_idx is None:
            return False
        victim = self._running.pop(victim_idx)
        ticket = self.journal.snapshot(victim)
        # swap-to-host when the engine has a tier: the victim's live
        # page run demotes to host DRAM under its resume-prompt digest
        # so readmission promotes the bytes back instead of replaying
        # the prefill. Falls back to plain cancel (replay resume) on
        # engines without a tier — same resume contract either way.
        swap_out = getattr(self.engine, "swap_out", None)
        if swap_out is not None:
            swap_out(victim_idx)
        else:
            self.engine.cancel(victim_idx)
        if ticket.prng_key is not None:
            victim.prng_key = pin_key(ticket.prng_key)
        victim.state = RequestState.QUEUED
        victim.preemptions += 1
        self._push_waiting_locked(
            victim, len(victim.prompt) + len(victim.tokens)
        )
        self.metrics.tier_preempted(victim.tier)
        logger.info(
            "preempted request %d (tier %s, %d tokens emitted) for "
            "latency-tier admission",
            victim.id, victim.tier, len(victim.tokens),
        )
        return True

    def pump(self) -> bool:
        """One scheduling iteration: shed expired, escalate aged,
        admit strict-priority EDF into free slots (preempting batch
        work for blocked latency arrivals), decode one chunk, stream
        the emitted tokens. Returns True while work remains.

        If the engine raises (injected fault or real failure), the
        scheduler marks itself crashed, snapshots every in-flight
        request into resume tickets, and hands them to `on_failure`
        OUTSIDE its own lock (the failover manager re-admits them on
        peer schedulers, which take their locks)."""
        failure = None
        with self._cond:
            if self.crashed:
                return False
            now = self._clock()
            self._shed_expired_locked(now)
            self._escalate_aged_locked(now)
            try:
                # admit only up to the engine's free slots so
                # tier-then-EDF order, not engine-internal FIFO,
                # decides dispatch
                headroom_ok = getattr(
                    self.engine, "admission_headroom_ok", None
                )
                while True:
                    tier, req = self._peek_next_locked()
                    if req is None:
                        break
                    room = (
                        self.engine.queue_len()
                        < self.engine.free_slots()
                    )
                    # memory-aware gate (paged KV): when the page pool
                    # cannot back a worst-case admission and the engine
                    # already has work, wait for it to drain rather
                    # than force the engine into preempt-and-swap
                    # thrash. With the engine empty we admit anyway —
                    # it reclaims inline, so progress is guaranteed
                    # either way.
                    blocked = (
                        headroom_ok is not None
                        and not headroom_ok()
                        and (
                            self.engine.active_count() > 0
                            or self.engine.queue_len() > 0
                        )
                    )
                    if not room or blocked:
                        # a latency-tier waiter blocked on capacity
                        # reclaims it from batch work: evict one
                        # victim (slot + pages free immediately) and
                        # re-evaluate. No victim => genuinely full.
                        if (
                            req.effective_tier == TIERS[0]
                            and self._preempt_for_admission_locked()
                        ):
                            continue
                        break
                    heapq.heappop(self._waiting[tier])
                    pkg, req.handoff_pkg = req.handoff_pkg, None
                    if pkg is not None and not req.tokens:
                        # adopted prefill: install the shipped KV
                        # instead of replaying the prompt. A package
                        # outlived by emitted tokens (decode-side
                        # crash after adoption) is stale — replay.
                        idx = self.engine.submit_adopted(pkg)
                    else:
                        prompt, remaining = req.engine_spec()
                        kw = {}
                        if req.adapter_id is not None:
                            kw["adapter_id"] = req.adapter_id
                        try:
                            idx = self.engine.submit(
                                prompt,
                                max_new=remaining,
                                prng_key=req.prng_key,
                                **kw,
                            )
                        except AdapterCacheFull:
                            # every bank slot is pinned by requests
                            # already decoding: put the request back
                            # and stop admitting — a retire this chunk
                            # releases a pin and the next pump retries
                            self._push_waiting_locked(req, prompt.size)
                            break
                        except KeyError:
                            # unregistered between admission and
                            # dispatch: fail this request, keep the
                            # replica alive
                            req._end(RequestState.FAILED, now)
                            self.metrics.request_failed()
                            self.journal.close(req)
                            continue
                    req.state = RequestState.RUNNING
                    self._running[idx] = req
                    self.journal.open(req)
                if self.engine.has_work():
                    t_step = time.perf_counter()
                    events = self.engine.step()
                    dt = time.perf_counter() - t_step
                    self._step_lat_ewma = (
                        dt
                        if self._step_lat_ewma == 0.0
                        else self._step_lat_alpha * dt
                        + (1.0 - self._step_lat_alpha)
                        * self._step_lat_ewma
                    )
                else:
                    events = []
            except ChipLost as exc:
                # the replica is ALIVE but its slice shrank: resize
                # live at the surviving tp instead of crashing the
                # whole replica. In-flight requests are
                # preempted to the engine queue and replayed
                # byte-identically (serving/elastic.py); the
                # scheduler's _running map keeps its entries — the
                # engine re-admits the same indices after the resize.
                events = []
                handled = False
                if self.elastic_resize:
                    try:
                        report = self.engine.resize(
                            self.engine.surviving_chips()
                        )
                        logger.warning(
                            "chip loss (%d gone): resized tp=%d -> "
                            "tp=%d, %d request(s) replaying, "
                            "%.1fms downtime",
                            exc.n_chips, report.old_tp, report.new_tp,
                            report.replayed, report.downtime_ms,
                        )
                        handled = True
                    # a resize failure is logged and falls back to the
                    # crash/failover path below
                    except Exception:
                        logger.exception(
                            "live resize after chip loss failed; "
                            "crashing replica"
                        )
                if not handled:
                    failure = (self._crash_locked(), exc)
            # the failure is logged and dispatched outside the lock
            # by _dispatch_failure below
            except Exception as exc:
                failure = (self._crash_locked(), exc)
                events = []
        if failure is not None:
            self._dispatch_failure(failure[0], failure[1])
            return False
        with self._cond:
            now = self._clock()
            for idx, new_toks, finished in events:
                req = self._running.get(idx)
                if req is None:
                    continue
                if new_toks:
                    if req.first_token_ts is None:
                        req.first_token_ts = now
                        self.metrics.observe_ttft(
                            (now - req.submit_ts) * 1000.0,
                            tier=req.tier,
                        )
                    req.tokens.extend(new_toks)
                    req.stream.put(new_toks)
                    self.metrics.observe_tokens(len(new_toks), now)
                if finished:
                    self.engine.retire(idx)
                    del self._running[idx]
                    self.journal.close(req)
                    if (
                        req.first_token_ts is not None
                        and len(req.tokens) > 1
                    ):
                        self.metrics.observe_tpot(
                            (now - req.first_token_ts)
                            * 1000.0
                            / (len(req.tokens) - 1),
                            tier=req.tier,
                        )
                    req._end(RequestState.DONE, now)
                    self.metrics.request_completed()
            # journal the post-dispatch per-slot keys: this is the
            # PRNG state a failover re-admission must continue from
            for idx, key in self.engine.live_request_keys().items():
                live = self._running.get(idx)
                if live is not None:
                    self.journal.record_key(live, key)
            # phase split: a prefill-role engine's admissions are
            # complete the moment they land (admission IS the
            # prefill) — export them for migration, release their
            # slots, and dispatch to the coordinator OUTSIDE the lock
            # (it takes the target scheduler's lock)
            migrations = self._drain_prefilled_locked()
            depth = self._waiting_total_locked()
            self.metrics.set_queue_depth(depth)
            self.metrics.set_role_queue_depth(
                getattr(self.engine, "replica_role", "colocated"),
                depth,
            )
            self.metrics.set_active_requests(len(self._running))
            pc = getattr(self.engine, "prefix_cache", None)
            if pc is not None:
                self.metrics.update_prefix_cache(
                    pc.hits, pc.misses, pc.evictions, pc.tokens_reused
                )
            spec = getattr(self.engine, "spec", None)
            if spec is not None:
                self.metrics.update_speculative(
                    spec.proposed, spec.accepted,
                    spec.rounds, spec.emitted,
                )
            step_stats = getattr(self.engine, "step_stats", None)
            if step_stats is not None:
                st = step_stats()
                self.metrics.update_step_timing(
                    st["host_ms"], st["device_wait_ms"],
                    int(st["dispatches"]), st["overlap_ratio"],
                )
                kp = getattr(self.engine, "kernel_path", None)
                if kp is not None:
                    self.metrics.update_kernel_path(
                        kp, int(st["dispatches"])
                    )
            paged_stats = getattr(self.engine, "paged_stats", None)
            if paged_stats is not None:
                ps = paged_stats()
                if ps:
                    self.metrics.update_paged(ps)
            tier_stats = getattr(self.engine, "kv_tier_stats", None)
            if tier_stats is not None:
                ts = tier_stats()
                if ts:
                    self.metrics.update_kv_tier(ts)
            mesh_shape = getattr(self.engine, "mesh_shape", None)
            if mesh_shape is not None:
                self.metrics.set_mesh(
                    int(mesh_shape.get("tp", 1)),
                    int(getattr(self.engine, "n_chips", 1)),
                )
            es = getattr(self.engine, "elastic_stats", None)
            if es is not None:
                self.metrics.update_elastic(es())
            astats = getattr(self.engine, "adapter_stats", None)
            if astats is not None:
                a = astats()
                if a:
                    self.metrics.update_adapters(a)
            pfstats = getattr(self.engine, "prefill_stats", None)
            if pfstats is not None:
                self.metrics.update_prefill(pfstats())
            hstats = getattr(self.engine, "health_stats", None)
            if hstats is not None:
                h = hstats()
                if h:
                    self.metrics.update_kv_integrity(h)
            wqstats = getattr(self.engine, "weight_quant_stats", None)
            if wqstats is not None:
                wq = wqstats()
                if wq:
                    self.metrics.update_weight_quant(
                        wq,
                        getattr(
                            self.engine, "weight_quant_path", "none"
                        ),
                    )
            busy = bool(self._running) or any(
                self._waiting[t] for t in TIERS
            )
        for req, ticket, pkg in migrations:
            self._dispatch_handoff(req, ticket, pkg)
        return busy or bool(migrations)

    # ---- phase handoff ---------------------------------------------------

    def _drain_prefilled_locked(self):
        """Under the lock: turn every finished prefill into a
        (request, ticket, package) migration — export the KV run,
        snapshot the resume ticket, and release the slot. Only
        prefill-role engines ever have finished prefills. The ticket
        is snapshotted BEFORE retire so a failed handoff replays from
        exactly the exported state."""
        if (
            getattr(self.engine, "replica_role", "colocated")
            != "prefill"
        ):
            return []
        take = getattr(self.engine, "take_prefilled", None)
        if take is None:
            return []
        migrations = []
        for ereq in take():
            req = self._running.get(ereq.idx)
            if req is None:
                continue  # cancelled between admission and drain
            pkg = None
            try:
                pkg = handoff_mod.export_run(
                    self.engine,
                    ereq.idx,
                    transport=self.handoff_transport,
                )
            # an export failure is logged and the request falls back
            # to resume-by-replay via its ticket
            except Exception:
                logger.exception(
                    "KV export of request %d failed; falling back "
                    "to replay", req.id,
                )
            ticket = self.journal.snapshot(req)
            if ticket.prng_key is None and pkg is not None:
                ticket.prng_key = pkg.prng_key
            self.engine.retire(ereq.idx)
            del self._running[ereq.idx]
            self.journal.close(req)
            migrations.append((req, ticket, pkg))
        return migrations

    def _dispatch_handoff(self, req, ticket, pkg) -> None:
        """Outside the lock: hand one migration to the coordinator;
        on any failure (no coordinator, no target, injected crash
        mid-handoff) fall back to resume-by-replay — re-admit from
        the ticket, re-prefill, re-export. Retries are bounded by
        max_handoff_retries, after which the request fails loudly."""
        handled = False
        t0 = time.perf_counter()
        if pkg is not None and self.on_handoff is not None:
            try:
                handled = bool(self.on_handoff(self, ticket, pkg))
            # a mid-handoff crash is logged and recovered via the
            # resume-by-replay fallback below
            except Exception:
                logger.exception(
                    "handoff of request %d failed mid-flight", req.id
                )
        if handled:
            self.metrics.observe_handoff(
                pkg.transport, (time.perf_counter() - t0) * 1000.0
            )
            return
        req.retries += 1
        if req.retries > self.max_handoff_retries:
            req._end_failed()
            self.metrics.request_failed()
            return
        try:
            self.readmit(req, ticket)
        except AdmissionError:
            req._end_failed()
            self.metrics.request_failed()

    # ---- failover --------------------------------------------------------

    def _crash_locked(self) -> List[ResumeTicket]:
        """Under the lock: mark crashed and snapshot every in-flight
        request (running AND still-queued) into resume tickets. The
        engine's device state is not trusted after this — restart()
        rebuilds it."""
        self.crashed = True
        # abandon any async-dispatched-but-unharvested step FIRST:
        # journal and req.tokens then describe the same (last
        # harvested) dispatch, and replay regenerates the rest.
        # step() already drops its own in-flight record when it
        # raises; this guards the paths that crash between steps.
        drain = getattr(self.engine, "drain_inflight", None)
        if drain is not None:
            drain()
        tickets = []
        for req in self._running.values():
            tickets.append(self.journal.snapshot(req))
        self._running.clear()
        for heap_ in self._waiting.values():
            while heap_:
                _, _, _, _, req = heapq.heappop(heap_)
                if req.state is RequestState.QUEUED:
                    tickets.append(self.journal.snapshot(req))
        self.journal = RequestJournal()
        self.metrics.set_queue_depth(0)
        self.metrics.set_active_requests(0)
        return tickets

    def _dispatch_failure(
        self, tickets: List[ResumeTicket], exc: BaseException
    ):
        logger.error(
            "engine failure with %d in-flight request(s): %r",
            len(tickets), exc,
        )
        if self.on_failure is not None:
            try:
                self.on_failure(self, tickets, exc)
                return
            except Exception:
                logger.exception("failover callback failed")
        now = self._clock()
        for t in tickets:
            if t.req.finish_ts is None:
                t.req._end(RequestState.FAILED, now)
                self.metrics.request_failed()

    def readmit(self, req: ServeRequest, ticket: ResumeTicket) -> bool:
        """Accept a request evacuated from a crashed peer. Bypasses
        the queue-depth bound — failing over admitted work beats
        429ing it — but still honours the deadline: an already-late
        request is shed here (returns False), never decoded. The
        journaled key is pinned so the resumed slot continues the
        exact sampling stream. The request keeps its effective tier
        — aging seniority survives the move."""
        with self._cond:
            if self.crashed:
                raise AdmissionError("replica crashed, pending restart")
            now = self._clock()
            if req.deadline <= now:
                req._end(RequestState.SHED, now)
                self.metrics.request_shed(
                    getattr(req, "tier", "standard")
                )
                return False
            if ticket.prng_key is not None:
                req.prng_key = pin_key(ticket.prng_key)
            req.scheduler = self
            req.state = RequestState.QUEUED
            self._push_waiting_locked(
                req, len(req.prompt) + len(req.tokens)
            )
            self.metrics.set_queue_depth(self._waiting_total_locked())
            self._cond.notify_all()
            return True

    def adopt(
        self,
        req: ServeRequest,
        ticket: ResumeTicket,
        package,
    ) -> bool:
        """Accept a request prefilled on another replica: the
        KVHandoff package is pinned and installed at the next
        admission — the copy-free decode-side half of the MPMD phase
        split. Same contract as readmit(): bypasses the queue-depth
        bound, honours the deadline (an already-late arrival is shed,
        returns False), pins the journaled key. Raises (ValueError /
        AdmissionError) when this engine cannot host the package —
        the coordinator's cue to try the next target."""
        handoff_mod.check_compatible(self.engine, package)
        with self._cond:
            if self.crashed:
                raise AdmissionError("replica crashed, pending restart")
            now = self._clock()
            if req.deadline <= now:
                req._end(RequestState.SHED, now)
                self.metrics.request_shed(
                    getattr(req, "tier", "standard")
                )
                return False
            if ticket.prng_key is not None:
                req.prng_key = pin_key(ticket.prng_key)
            req.handoff_pkg = package
            req.scheduler = self
            req.state = RequestState.QUEUED
            self._push_waiting_locked(req, len(req.prompt))
            self.metrics.set_queue_depth(self._waiting_total_locked())
            self._cond.notify_all()
            return True

    def cancel(self, req: ServeRequest) -> bool:
        """Abort a request (client disconnected): frees its slot and
        any prefix-cache pin immediately instead of decoding tokens
        nobody reads. Queued entries are removed lazily from the
        heap. Returns False if the request already ended."""
        with self._cond:
            if req.state is RequestState.RUNNING:
                for idx, r in list(self._running.items()):
                    if r is req:
                        self.engine.cancel(idx)
                        del self._running[idx]
                        break
            elif req.state is not RequestState.QUEUED:
                return False
            self.journal.close(req)
            req._end(RequestState.CANCELLED, self._clock())
            self.metrics.request_cancelled()
            return True

    # ---- elastic ---------------------------------------------------------

    def resize_engine(self, n_chips: Optional[int] = None):
        """Resize the engine's mesh under the scheduler lock (the
        pool's probe thread drives shrink-on-probe and grow-back from
        here). pump() holds the same lock through engine.step(), so
        the resize lands at a dispatch boundary, never mid-step.
        Returns the ResizeReport, or None on a crashed scheduler."""
        with self._cond:
            if self.crashed:
                return None
            report = self.engine.resize(n_chips)
            self._cond.notify_all()
            return report

    def refresh_weights(self, params, mode: Optional[str] = None):
        """Version-tagged, drain-free weight refresh under the
        scheduler lock: dispatches serialize on the same lock, so the
        swap (or its staging, under the defer fence) can never land
        mid-step — no request is ever served by a mixed-version
        dispatch. `mode` overrides the engine's weight_refresh_mode
        knob for this call."""
        with self._cond:
            self.engine.update_params(params, mode=mode)
            self._cond.notify_all()

    def restart(self) -> None:
        """Bring a crashed scheduler back: rebuild the engine's
        device state from scratch and clear the crashed flag. The
        background thread (if any) stays up throughout — it idles
        while crashed and resumes pumping here."""
        with self._cond:
            self.engine.reset()
            for heap_ in self._waiting.values():
                heap_.clear()
            self._running.clear()
            self.journal = RequestJournal()
            self.crashed = False
            self._cond.notify_all()

    def run_to_completion(self):
        """Drain everything submitted so far (tests/bench path)."""
        while self.pump():
            pass

    # ---- background driver ----------------------------------------------

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="serve-scheduler", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            self._thread = None

    def _loop(self):
        while not self._stop.is_set():
            try:
                busy = self.pump()
            except Exception:  # keep the serving thread alive
                logger.exception("scheduler pump failed")
                busy = False
            if not busy:
                with self._cond:
                    # wake on submit or shortly before the nearest
                    # deadline (a queued-only request must still shed
                    # on time even with no decode traffic)
                    self._cond.wait(timeout=0.02)
