"""Request-level failover: journal, circuit breaker, re-admission — a
copy of dlrover_tpu/serving/failover.py. One mechanism differs: the
port's per-request key is a torch.Generator state (what the engine's
`live_request_keys` reports and `submit(prng_key=...)` continues), not
a JAX key, so the journal copies and pins keys through `copy_key` and
`pin_key` instead of casting them to uint32 words.

The reference DLRover survives node loss mid-job because the master
owns enough state to rebuild any worker (PAPER.md L4/L6). The serving
equivalent is far cheaper than live KV-cache migration: a decode-only
request IS its token history. `RequestJournal` keeps (prompt, tokens
emitted so far, per-request PRNG key, deadline) for every active
request; when a replica dies, `FailoverManager` re-admits each
in-flight request to a healthy replica with prompt+emitted as the new
prefill and the journaled key as the sampling state. Greedy resume is
token-for-token identical to an uncrashed run; sampled resume
continues the exact key stream (the engine burns one split per
emitted token per slot, see engine.py). The prefix cache makes the
replay a warm, suffix-only prefill on the new replica.

`CircuitBreaker` is the per-replica failure detector the pool drives:
consecutive probe failures trip it OPEN (ejection), probation probes
are spaced by exponential backoff, and one healthy probation probe
closes it again. The first trip re-probes immediately — a replica
that was ejected by a transient blip re-enters the pool on the very
next health-check pass; only *failed probations* grow the backoff.
"""

import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from dlrover_tpu_torch.common.log import default_logger as logger

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# SLO-class rank for evacuation order — literal (not imported from
# scheduler.py, which imports this module) and defaulted for tickets
# whose requests predate the tier field.
_TIER_RANK = {"latency": 0, "standard": 1, "batch": 2}


def copy_key(key):
    """A journal's own copy of a request key: a generator state (a
    torch tensor) is cloned, an int seed kept, a JAX-style key's words
    copied into a numpy array."""
    if isinstance(key, torch.Tensor):
        return key.clone()
    if isinstance(key, (int, np.integer)):
        return int(key)
    return np.array(key, copy=True)


def pin_key(key):
    """A key in the form the engine's `submit(prng_key=...)` takes: a
    generator state or an int seed as it is, anything else as uint32
    words (JAX's scheduler casts every key to those)."""
    if isinstance(key, torch.Tensor) or isinstance(key, (int, np.integer)):
        return key
    return np.asarray(key, np.uint32)


class CircuitBreaker:
    """Consecutive-failure ejection -> exponential-backoff probation.

    CLOSED: healthy; `max_strikes` consecutive `record_failure` calls
    trip it. OPEN: ejected; `should_probe()` stays False until the
    backoff deadline. HALF_OPEN: one probe in flight — success closes,
    failure re-trips with doubled backoff (capped). The first trip
    uses zero delay so transient blips heal on the next check pass.
    """

    def __init__(
        self,
        max_strikes: int = 2,
        backoff_base_s: float = 0.5,
        backoff_max_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        jitter_seed: Optional[int] = None,
    ):
        self.max_strikes = max_strikes
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._clock = clock
        # full jitter on probation backoff: with a seed, each delay
        # draws uniform(0, exp_delay) so breakers tripped by the same
        # fleet-wide event don't re-probe in lockstep. None keeps the
        # exact legacy deterministic schedule.
        self._jitter_rng = (
            np.random.default_rng(jitter_seed)
            if jitter_seed is not None
            else None
        )
        self.state = CLOSED
        self.strikes = 0
        self._opens = 0  # consecutive trips since last close
        self._retry_at = 0.0

    def _trip(self) -> None:
        if self._opens == 0:
            delay = 0.0
        else:
            delay = min(
                self.backoff_base_s * (2.0 ** (self._opens - 1)),
                self.backoff_max_s,
            )
            if self._jitter_rng is not None:
                delay = float(self._jitter_rng.uniform(0.0, delay))
        self._opens += 1
        self._retry_at = self._clock() + delay
        self.state = OPEN
        self.strikes = 0

    def trip(self) -> None:
        """Force ejection (engine crash observed — don't wait for the
        probe loop to accumulate strikes)."""
        self._trip()

    def record_failure(self) -> None:
        if self.state == HALF_OPEN:
            self._trip()
            return
        if self.state == OPEN:
            return
        self.strikes += 1
        if self.strikes >= self.max_strikes:
            self._trip()

    def record_success(self) -> None:
        self.state = CLOSED
        self.strikes = 0
        self._opens = 0

    def should_probe(self) -> bool:
        """True when the replica should be probed this pass. While
        OPEN and before the backoff deadline, skip probing entirely;
        past it, move to HALF_OPEN and allow one probe."""
        if self.state == CLOSED:
            return True
        if self.state == HALF_OPEN:
            return True
        if self._clock() >= self._retry_at:
            self.state = HALF_OPEN
            return True
        return False

    @property
    def retry_in_s(self) -> float:
        return max(0.0, self._retry_at - self._clock())


class ResumeTicket:
    """Everything needed to re-admit one in-flight request elsewhere:
    replay prompt (original prompt + tokens emitted so far), remaining
    token budget, and the journaled PRNG key the resumed slot must
    continue from."""

    def __init__(
        self,
        req: Any,
        prompt: np.ndarray,
        remaining_new: int,
        prng_key: Optional[np.ndarray],
    ):
        self.req = req
        self.prompt = prompt
        self.remaining_new = remaining_new
        self.prng_key = prng_key


class RequestJournal:
    """Per-active-request resume state on the scheduler.

    The prompt and emitted tokens already live on the ServeRequest
    (the stream ledger); what the journal adds is the per-slot PRNG
    key captured after every pump, so a sampled request resumed on
    another replica draws the exact noise an uncrashed run would.

    Async dispatch (engine `async_depth=1`) changes nothing here by
    construction: keys are journaled from the engine's host mirrors,
    which only ever advance at harvest time — the same moment
    req.tokens grows — so (tokens, key) always describe the same
    last-harvested dispatch. A crash with a dispatch still in flight
    abandons that dispatch (the scheduler drains it before
    snapshotting); replay regenerates its tokens byte-identically
    from the journaled key.
    """

    def __init__(self):
        self._keys = {}  # id(req) -> np.ndarray [2] uint32

    def open(self, req: Any) -> None:
        key = getattr(req, "prng_key", None)
        if key is not None:
            self._keys[id(req)] = copy_key(key)

    def record_key(self, req: Any, key) -> None:
        self._keys[id(req)] = copy_key(key)

    def close(self, req: Any) -> None:
        self._keys.pop(id(req), None)

    def snapshot(self, req: Any) -> ResumeTicket:
        emitted = list(req.tokens)
        prompt = np.asarray(req.prompt, dtype=np.int32).reshape(-1)
        if emitted:
            prompt = np.concatenate(
                [prompt, np.asarray(emitted, dtype=np.int32)]
            )
        return ResumeTicket(
            req,
            prompt,
            int(req.max_new) - len(emitted),
            self._keys.get(id(req)),
        )


class FailoverManager:
    """Moves a dead replica's in-flight requests to healthy ones.

    Wired as each scheduler's `on_failure` callback by ReplicaPool;
    receives the resume tickets the crashing scheduler snapshotted
    and re-admits them EDF-first so failover respects the same
    deadline order admission does. A request is failed (not retried
    forever) once it exceeds `max_retries` crashes or no healthy
    replica remains.
    """

    def __init__(self, pool: Any, max_retries: int = 2):
        self.pool = pool
        self.max_retries = max_retries

    def _targets(self, source: Any) -> List[Any]:
        reps = [
            r
            for r in self.pool.replicas()
            if r.scheduler is not source
            and r.healthy
            and not r.scheduler.crashed
        ]
        reps.sort(key=lambda r: r.load())
        return reps

    def on_scheduler_failure(
        self,
        scheduler: Any,
        tickets: Sequence[ResumeTicket],
        exc: BaseException,
    ) -> None:
        metrics = self.pool.metrics
        for rep in self.pool.replicas():
            if rep.scheduler is scheduler:
                rep.healthy = False
                breaker = self.pool.breakers.get(rep.id)
                if breaker is not None:
                    breaker.trip()
                # the corpse's advertised prefixes leave the fleet
                # digest map NOW — ejection-by-engine-failure must
                # not leave a stale affinity route the way only the
                # breaker-open probe path used to
                drop = getattr(self.pool, "_drop_affinity", None)
                if drop is not None:
                    drop(rep.id)
                    self.pool.mark_rank_dirty()
                if metrics is not None:
                    metrics.replica_ejected()
                logger.warning(
                    "replica %s ejected after engine failure: %r",
                    rep.id,
                    exc,
                )
                break
        # evacuate the most urgent work first: latency-tier tickets
        # land on the (finite-capacity) survivors before batch ones,
        # EDF within a tier — the same precedence the schedulers
        # themselves dispatch with
        for ticket in sorted(
            tickets,
            key=lambda t: (
                _TIER_RANK.get(
                    getattr(t.req, "effective_tier", "standard"), 1
                ),
                t.req.deadline,
            ),
        ):
            req = ticket.req
            if ticket.remaining_new <= 0:
                # crashed after its last token: it is already done
                req._end_done()
                if metrics is not None:
                    metrics.request_completed()
                continue
            req.retries += 1
            if req.retries > self.max_retries:
                req._end_failed()
                if metrics is not None:
                    metrics.request_failed()
                continue
            placed = False
            for rep in self._targets(scheduler):
                try:
                    placed = rep.scheduler.readmit(req, ticket)
                except Exception:  # noqa: BLE001 — try the next peer
                    # a raising readmit (peer crashed between the
                    # _targets snapshot and here) must stay visible:
                    # silently skipping peers hides a dying pool
                    logger.exception(
                        "readmit of request %d on replica %s failed",
                        req.id, rep.id,
                    )
                    continue
                if placed:
                    if metrics is not None:
                        metrics.failover()
                    break
                # readmit() returned False: deadline already passed
                # and the scheduler shed it — do not try elsewhere
                placed = True
                break
            if not placed:
                req._end_failed()
                if metrics is not None:
                    metrics.request_failed()
