"""Seed-driven production-trace generator for the serving stack — a
copy of dlrover_tpu/serving/workload.py (pure numpy: the same config
and seed give the same events in both packages).

A single-scenario echo has one prompt
shape, one arrival pattern, one SLO class. A "millions of users"
serving claim needs the traffic that actually hits a production
fleet, and this module synthesizes it as a REPLAYABLE artifact:

- diurnal burst arrival: session starts follow an inhomogeneous
  Poisson process whose rate is a sinusoid over `period_s` (trough at
  t=0, peak mid-period), sampled by thinning. The resulting
  arrival-count series is exactly the shape a predictive-scaling
  forecast loop fits, so a trace drives the autoscaler end-to-end.
- multi-turn chat sessions: each session opens with a shared system
  prompt and runs `n_turns` turns; turn k's prompt is turn k-1's
  prompt + the model's actual reply + new user text, so prefix
  digests CHAIN across turns — every later turn re-hits the prefix
  cache and the fleet affinity router on the replica that served the
  earlier ones.
- long-context outliers: a small fraction of sessions open with a
  `long_context_tokens` first turn — the tail that stresses paged-KV
  headroom and admission.
- SLO tiers: each session is labelled "latency" | "standard" |
  "batch" (drawn per session — a chat doesn't change class
  mid-conversation) with a per-tier deadline, feeding the
  scheduler's priority heaps.

Everything is derived from ONE `numpy` Generator seeded with
`WorkloadConfig.seed`: the same seed always yields the identical
event stream (asserted in tests), and generation is wall-clock-free
— event times are virtual seconds from trace start, never read from
the system clock.

The replies are NOT part of the trace — they come from the model at
replay time. `SessionBook` owns that coupling: `prompt_for(event)`
builds the turn's prompt from the session context accumulated so
far, and `record_reply(event, tokens)` folds the served reply back
in for the next turn. Replaying the same trace against a
deterministic (greedy) engine therefore reproduces the same prompts
byte-for-byte, which is what lets serve_bench compare a tiered
replay against an untiered oracle.
"""

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

from dlrover_tpu_torch.serving.scheduler import TIERS


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """Knobs for one synthetic production trace. All times are
    virtual seconds from trace start."""

    seed: int = 0
    horizon_s: float = 300.0       # session STARTS arrive in [0, horizon)
    # diurnal arrival: rate(t) = base_rate * (1 + burst_amplitude *
    # sin(2*pi*t/period_s + phase)), sessions/sec. The default phase
    # puts the trough at t=0 and the peak at period_s/2 — one "day"
    # per period with the burst mid-trace.
    base_rate: float = 0.5
    burst_amplitude: float = 0.8   # in [0, 1): rate never reaches 0
    period_s: float = 300.0
    phase: float = -math.pi / 2.0
    # chat shape
    turns_lo: int = 1
    turns_hi: int = 4              # inclusive
    think_time_s: float = 5.0      # mean exp gap between turns
    user_tokens_lo: int = 4
    user_tokens_hi: int = 24       # inclusive
    max_new_lo: int = 8
    max_new_hi: int = 32           # inclusive, per-turn reply budget
    # long-context outliers: fraction of sessions whose FIRST user
    # turn is `long_context_tokens` long (the paged-KV stressor)
    long_context_prob: float = 0.05
    long_context_tokens: int = 192
    # shared system prompt opening every session (the cross-session
    # prefix the cache + affinity router converge on)
    system_prompt_tokens: int = 16
    vocab: int = 256               # token ids drawn from [1, vocab]
    # context clamp applied by SessionBook (keep prompts admissible;
    # prompts under the clamp never lose their shared prefix)
    max_prompt_tokens: int = 448
    # SLO tier mix (standard gets the remainder) + per-tier deadlines
    latency_frac: float = 0.5
    batch_frac: float = 0.2
    latency_deadline_s: float = 30.0
    standard_deadline_s: float = 120.0
    batch_deadline_s: float = 600.0

    def rate(self, t: float) -> float:
        """Instantaneous session-arrival rate at virtual time t."""
        return self.base_rate * (
            1.0
            + self.burst_amplitude
            * math.sin(2.0 * math.pi * t / self.period_s + self.phase)
        )

    def tier_deadline_s(self, tier: str) -> float:
        return {
            "latency": self.latency_deadline_s,
            "standard": self.standard_deadline_s,
            "batch": self.batch_deadline_s,
        }[tier]


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One chat turn arriving at virtual time `t`. The prompt is NOT
    stored — it depends on the replies served so far; SessionBook
    builds it at replay time from `user_tokens` + session context."""

    t: float                       # virtual arrival time, seconds
    session: int                   # session ordinal within the trace
    turn: int                      # 0-based turn within the session
    n_turns: int                   # total turns in this session
    user_tokens: Tuple[int, ...]   # this turn's new user text
    max_new: int                   # reply token budget
    tier: str                      # SLO class (constant per session)
    deadline_s: float              # tier deadline at submit
    long_context: bool             # long-context outlier session


@dataclasses.dataclass(frozen=True)
class Trace:
    """A replayable event stream plus the shared session opener."""

    config: WorkloadConfig
    system_prompt: Tuple[int, ...]
    events: Tuple[TraceEvent, ...]

    @property
    def n_sessions(self) -> int:
        return len({e.session for e in self.events})

    def arrival_counts(self, n_buckets: int) -> List[int]:
        """Events per equal-width virtual-time bucket over the span
        of the trace — the series the forecast loop consumes."""
        if not self.events:
            return [0] * n_buckets
        span = max(e.t for e in self.events) + 1e-9
        counts = [0] * n_buckets
        for e in self.events:
            counts[min(n_buckets - 1, int(e.t / span * n_buckets))] += 1
        return counts


def generate_trace(cfg: WorkloadConfig) -> Trace:
    """Synthesize one trace. Pure function of cfg (incl. seed): one
    rng drawn in a fixed order, no wall clock, no global state."""
    if not 0.0 <= cfg.burst_amplitude < 1.0:
        raise ValueError("burst_amplitude must be in [0, 1)")
    if not 0.0 <= cfg.latency_frac + cfg.batch_frac <= 1.0:
        raise ValueError("tier fractions must sum within [0, 1]")
    rng = np.random.default_rng(cfg.seed)
    system_prompt = tuple(
        int(x)
        for x in rng.integers(
            1, cfg.vocab + 1, size=cfg.system_prompt_tokens
        )
    )
    # session starts: inhomogeneous Poisson by thinning against the
    # peak rate — candidate arrivals at rate lam_max, each kept with
    # probability rate(t)/lam_max
    lam_max = cfg.base_rate * (1.0 + cfg.burst_amplitude)
    starts: List[float] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / lam_max))
        if t >= cfg.horizon_s:
            break
        if float(rng.random()) < cfg.rate(t) / lam_max:
            starts.append(t)
    tier_p = [
        cfg.latency_frac,
        1.0 - cfg.latency_frac - cfg.batch_frac,
        cfg.batch_frac,
    ]
    events: List[TraceEvent] = []
    for sid, t0 in enumerate(starts):
        n_turns = int(rng.integers(cfg.turns_lo, cfg.turns_hi + 1))
        tier = str(rng.choice(list(TIERS), p=tier_p))
        long_ctx = bool(rng.random() < cfg.long_context_prob)
        t_turn = t0
        for turn in range(n_turns):
            if turn > 0:
                t_turn += float(rng.exponential(cfg.think_time_s))
            n_user = (
                cfg.long_context_tokens
                if long_ctx and turn == 0
                else int(
                    rng.integers(
                        cfg.user_tokens_lo, cfg.user_tokens_hi + 1
                    )
                )
            )
            user = tuple(
                int(x)
                for x in rng.integers(1, cfg.vocab + 1, size=n_user)
            )
            max_new = int(
                rng.integers(cfg.max_new_lo, cfg.max_new_hi + 1)
            )
            events.append(
                TraceEvent(
                    t=t_turn,
                    session=sid,
                    turn=turn,
                    n_turns=n_turns,
                    user_tokens=user,
                    max_new=max_new,
                    tier=tier,
                    deadline_s=cfg.tier_deadline_s(tier),
                    long_context=long_ctx,
                )
            )
    # replay order: by arrival time; (session, turn) breaks exact
    # ties deterministically. Within a session times are strictly
    # increasing, so turn order is always preserved.
    events.sort(key=lambda e: (e.t, e.session, e.turn))
    return Trace(
        config=cfg,
        system_prompt=system_prompt,
        events=tuple(events),
    )


class SessionBook:
    """Per-session context for replaying a trace: chains each
    session's prompts through the replies actually served, so turn
    k's prompt = turn k-1's prompt + reply + new user text and the
    prefix digests chain the way a real chat's do.

    Not thread-safe; replay drivers call it from one thread."""

    def __init__(self, trace: Trace):
        self.config = trace.config
        self.system = np.asarray(trace.system_prompt, np.int32)
        # session id -> context (prompt+reply history); populated by
        # record_reply, absent until the first turn completes
        self._ctx: Dict[int, np.ndarray] = {}
        # session id -> the last prompt built, awaiting its reply
        self._pending: Dict[int, np.ndarray] = {}

    def ready(self, ev: TraceEvent) -> bool:
        """Whether this event may be submitted yet: turn 0 always;
        turn k>0 only after turn k-1's reply was recorded (a user
        cannot respond to a reply that hasn't streamed back)."""
        if ev.turn == 0:
            return True
        return (
            ev.session in self._ctx
            and ev.session not in self._pending
        )

    def prompt_for(self, ev: TraceEvent) -> np.ndarray:
        """Build this turn's prompt: session context so far + the
        turn's user tokens, clamped to max_prompt_tokens (sliding
        window from the back — only outlier sessions ever clamp)."""
        ctx = self._ctx.get(ev.session, self.system)
        prompt = np.concatenate(
            [ctx, np.asarray(ev.user_tokens, np.int32)]
        )
        limit = self.config.max_prompt_tokens
        if prompt.size > limit:
            prompt = prompt[-limit:]
        self._pending[ev.session] = prompt
        return prompt

    def record_reply(self, ev: TraceEvent, reply_tokens) -> None:
        """Fold the served reply into the session context; the next
        turn's prompt extends prompt+reply, chaining the digests."""
        base = self._pending.pop(ev.session, None)
        if base is None:
            raise ValueError(
                f"no pending prompt for session {ev.session}"
            )
        self._ctx[ev.session] = np.concatenate(
            [base, np.asarray(list(reply_tokens), np.int32)]
        )
