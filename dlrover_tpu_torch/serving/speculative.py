"""Speculative decoding, host half — counterpart of
dlrover_tpu/serving/speculative.py, which is host numpy code: this file
is a copy of it (the port imports nothing of the JAX package).

- `NgramDrafter` — prompt-lookup drafting: each slot keeps its prompt +
  emitted tokens, and a proposal is the continuation of the most recent
  earlier occurrence of the current suffix n-gram. No second model and
  no draft forward; the index is maintained incrementally (one dict
  write per n-gram size per emitted token).
- `SpecController` — per-slot rolling (EMA) acceptance rate tunes the
  draft length within [0, spec_draft_len]; k reaching 0 disables
  drafting for the slot, which re-probes with k=1 every
  `probe_interval` rounds.
- `SpeculativeDecoder` — the engine-facing bundle (drafter +
  controller + monotonic counters).

The device half — the batched verify forward and the acceptance rules
(exact match under greedy, rejection sampling under temperature /
top-k / top-p) — lives in models/decode.py.
"""

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class NgramDrafter:
    """Per-slot prompt-lookup drafter over an incremental n-gram index.

    For every slot the drafter holds the request's full token context
    (prompt + emitted) and, per n-gram size n in [ngram_min,
    ngram_max], a dict mapping each n-gram to its last two occurrence
    END positions. A proposal takes the longest suffix n-gram with an
    earlier occurrence and returns up to k tokens of that occurrence's
    continuation — the "what came after this phrase last time" guess
    that is exact whenever generation revisits seen text (retrieval
    echoes, code, templated output, repetition loops).

    Two end positions are kept because the suffix n-gram itself is
    always the most recent occurrence (registered when its last token
    arrived); the useful match is the one before it.
    """

    def __init__(
        self, n_slots: int, ngram_max: int = 3, ngram_min: int = 1
    ):
        if not 1 <= ngram_min <= ngram_max:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"[{ngram_min}, {ngram_max}]"
            )
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min
        self._ctx: List[List[int]] = [[] for _ in range(n_slots)]
        # per slot, per n: gram tuple -> (prev_end, last_end)
        self._index: List[Dict[int, Dict[Tuple[int, ...], Tuple[Optional[int], int]]]] = [
            {} for _ in range(n_slots)
        ]

    def begin(self, slot: int, prompt: Sequence[int]) -> None:
        """Reset the slot for a new request and index its prompt."""
        self._ctx[slot] = []
        self._index[slot] = {
            n: {} for n in range(self.ngram_min, self.ngram_max + 1)
        }
        self.extend(slot, prompt)

    def extend(self, slot: int, tokens: Sequence[int]) -> None:
        """Append emitted tokens and register the n-grams they close."""
        ctx = self._ctx[slot]
        index = self._index[slot]
        for t in tokens:
            ctx.append(int(t))
            end = len(ctx)
            for n in range(self.ngram_min, self.ngram_max + 1):
                if end < n:
                    continue
                gram = tuple(ctx[end - n : end])
                grams = index[n]
                prev = grams.get(gram)
                grams[gram] = (prev[1] if prev else None, end)

    def propose(self, slot: int, k: int) -> np.ndarray:
        """Up to k draft tokens for the slot's current context, or an
        empty array when no suffix n-gram has recurred (the honest
        answer — proposing noise just burns verify acceptance)."""
        ctx = self._ctx[slot]
        length = len(ctx)
        if k <= 0 or length < self.ngram_min + 1:
            return np.empty(0, np.int32)
        index = self._index[slot]
        hi = min(self.ngram_max, length)
        for n in range(hi, self.ngram_min - 1, -1):
            entry = index[n].get(tuple(ctx[length - n : length]))
            if entry is None:
                continue
            prev_end, last_end = entry
            # the suffix gram registers itself at end == length; the
            # match we can continue from is the one before it
            end = last_end if last_end < length else prev_end
            if end is None or end >= length:
                continue
            window = ctx[end:]
            if len(window) >= k:
                return np.asarray(window[:k], np.int32)
            # the match ends close to the tail — the generation is in
            # a repetition loop shorter than k, so tile the window
            # cyclically instead of proposing fewer tokens than asked
            return np.asarray(
                [window[i % len(window)] for i in range(k)], np.int32
            )
        return np.empty(0, np.int32)


@dataclasses.dataclass
class _SlotSpec:
    """Controller state for one slot."""

    k: int
    ema: float = 0.0
    seen: bool = False       # has the EMA been seeded yet
    cool: int = 0            # rounds since disabled (probe countdown)


class SpecController:
    """Per-slot adaptive draft length in [0, k_max].

    DLRover-style auto-tuning: the optimization measures itself and
    backs off where it loses. Per verify round the slot's acceptance
    fraction (accepted/proposed) updates an EMA; EMA at or above
    `threshold` grows k by one (toward k_max), below shrinks it by
    one. k reaching 0 disables drafting for the slot — it decodes on
    the plain chunk path at full speed — and every `probe_interval`
    rounds the slot re-probes with k=1: a probe whose acceptance
    clears the threshold re-enables speculation (EMA reseeded from
    the probe, shedding the stale history that disabled it)."""

    def __init__(
        self,
        n_slots: int,
        k_max: int,
        threshold: float = 0.5,
        probe_interval: int = 32,
        decay: float = 0.7,
    ):
        if k_max < 1:
            raise ValueError(f"k_max must be >= 1, got {k_max}")
        if not 0.0 < threshold <= 1.0:
            raise ValueError(
                f"threshold must be in (0, 1], got {threshold}"
            )
        if probe_interval < 1:
            raise ValueError(
                f"probe_interval must be >= 1, got {probe_interval}"
            )
        self.k_max = k_max
        self.threshold = threshold
        self.probe_interval = probe_interval
        self.decay = decay
        self._slots = [_SlotSpec(k=k_max) for _ in range(n_slots)]

    def reset(self, slot: int) -> None:
        """New request in the slot: start optimistic at k_max (fresh
        text deserves a fresh probe; the EMA re-seeds on the first
        observation)."""
        self._slots[slot] = _SlotSpec(k=self.k_max)

    def k_for(self, slot: int) -> int:
        """Draft length to use for this slot this round (0 = skip
        drafting). Called once per round per live slot: a disabled
        slot counts rounds here and returns a k=1 probe every
        `probe_interval`-th call."""
        s = self._slots[slot]
        if s.k > 0:
            return s.k
        s.cool += 1
        if s.cool >= self.probe_interval:
            s.cool = 0
            return 1
        return 0

    def observe(self, slot: int, proposed: int, accepted: int) -> None:
        """Fold one verify round's outcome into the slot's policy."""
        if proposed <= 0:
            return
        s = self._slots[slot]
        rate = accepted / proposed
        s.ema = (
            rate
            if not s.seen
            else self.decay * s.ema + (1.0 - self.decay) * rate
        )
        s.seen = True
        if s.k == 0:
            # probe outcome: revive only on a clear win, and shed the
            # stale losing history that disabled the slot
            if rate >= self.threshold:
                s.k = 1
                s.ema = rate
            return
        if s.ema >= self.threshold:
            s.k = min(s.k + 1, self.k_max)
        else:
            s.k -= 1  # 0 disables

    def current_k(self, slot: int) -> int:
        """The slot's tuned k without probe side effects (introspection
        / tests)."""
        return self._slots[slot].k


class SpeculativeDecoder:
    """Engine-facing bundle: drafter + controller + counters.

    The engine calls `begin_slot` at admission, `draft` before each
    verify dispatch, `record` with the device-confirmed outcome, and
    `extend` with every emitted token (whichever path emitted it —
    the n-gram index must see chunk-path tokens too, or a slot coming
    back from disabled would propose from a stale context).

    Counters are monotonic (Prometheus discipline, like
    RadixPrefixCache's): `rounds` counts live SLOT-rounds, so
    `tokens_per_step` = emitted/rounds is per-slot tokens per verify
    dispatch — >1.0 means speculation is beating one-token-per-step
    decoding.

    Staleness contract under async dispatch (engine `async_depth=1`):
    the engine harvests dispatch N-1 — including the `extend`/`record`
    calls for its emitted tokens — BEFORE drafting for dispatch N, so
    the drafter's context for any dispatch is exactly the full token
    history through the previous one. That is the same context the
    synchronous path sees: drafts, controller decisions, and therefore
    acceptance counters are byte-identical across depths (pinned by
    tests/test_torch_async.py). What shifts is only WHEN the
    host learns an outcome — one step() call later — never what the
    drafter conditions on. Verification makes output correctness
    independent of draft quality regardless, but this contract is what
    keeps the STATS (and the controller's adaptive k trajectory)
    deterministic too."""

    def __init__(
        self,
        n_slots: int,
        draft_len: int,
        ngram_max: int = 3,
        ngram_min: int = 1,
        threshold: float = 0.5,
        probe_interval: int = 32,
    ):
        self.draft_len = draft_len
        self.drafter = NgramDrafter(n_slots, ngram_max, ngram_min)
        self.controller = SpecController(
            n_slots, draft_len, threshold, probe_interval
        )
        self.proposed = 0
        self.accepted = 0
        self.rounds = 0
        self.emitted = 0

    def begin_slot(self, slot: int, prompt: Sequence[int]) -> None:
        self.drafter.begin(slot, prompt)
        self.controller.reset(slot)

    def draft(self, slot: int) -> np.ndarray:
        """Draft tokens for one live slot (may be empty), already
        clamped to the controller's current k."""
        k = self.controller.k_for(slot)
        if k <= 0:
            return np.empty(0, np.int32)
        return self.drafter.propose(slot, k)

    def draft_batch(self, done_mask: np.ndarray):
        """Drafts for every live slot as one padded [n_slots, k]
        batch (the engine's pre-dispatch pass). Proposal itself is
        per-slot (each drafter index is independent), but the padded
        assembly is vectorized so the engine's hot path does no
        per-slot Python bookkeeping. Padded entries hold token 0 — a
        valid embedding row; their logits and K/V are dead by the
        draft_len/position masks, but a pad_id of -1 must never reach
        the gather."""
        n_slots = len(self.controller._slots)
        k = self.draft_len
        drafts = np.zeros((n_slots, k), np.int32)
        dlens = np.zeros(n_slots, np.int32)
        live = np.flatnonzero(~np.asarray(done_mask))
        props = [self.draft(int(s)) for s in live]
        if props:
            lens = np.fromiter(
                (p.size for p in props), np.int32, len(props)
            )
            dlens[live] = lens
            if int(lens.max()) > 0:
                fill = np.arange(k)[None, :] < lens[:, None]
                buf = np.zeros((len(live), k), np.int32)
                buf[fill] = np.concatenate(
                    [p for p in props if p.size]
                )
                drafts[live] = buf
        return drafts, dlens

    def extend(self, slot: int, tokens: Sequence[int]) -> None:
        self.drafter.extend(slot, tokens)

    def record(
        self, slot: int, proposed: int, accepted: int, emitted: int
    ) -> None:
        """One live slot's verify-round outcome (device-confirmed)."""
        self.rounds += 1
        self.proposed += proposed
        self.accepted += accepted
        self.emitted += emitted
        self.controller.observe(slot, proposed, accepted)

    # ---- exposition ------------------------------------------------------

    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    def tokens_per_step(self) -> float:
        return self.emitted / self.rounds if self.rounds else 0.0

    def accepted_per_step(self) -> float:
        return self.accepted / self.rounds if self.rounds else 0.0

    def stats(self) -> Dict[str, float]:
        return {
            "proposed": self.proposed,
            "accepted": self.accepted,
            "rounds": self.rounds,
            "emitted": self.emitted,
            "acceptance_rate": self.acceptance_rate(),
            "accepted_per_step": self.accepted_per_step(),
            "tokens_per_step": self.tokens_per_step(),
            "draft_len": self.draft_len,
            "slots_drafting": sum(
                1
                for i in range(len(self.controller._slots))
                if self.controller.current_k(i) > 0
            ),
        }
