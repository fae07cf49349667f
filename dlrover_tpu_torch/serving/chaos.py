"""Deterministic fault injection for the serving stack — the port's copy
of dlrover_tpu/serving/chaos.py (host only; the port imports nothing of
the JAX package).

A `FaultInjector` holds seed-driven fault plans and the serving
components consult it through small hooks:

  - engine dispatch:  `ContinuousBatcher(chaos=..., chaos_tag=...)`
    calls `on_engine_step(tag, step)` at the top of every step(); a
    plan may raise (`ReplicaCrashed`, `ChipLost`, any exception) or
    sleep (a slow replica). The host KV tier calls it inside every
    demotion (tag "<engine tag>#kvtier").
  - KV payloads:      the KV egress sites (tier finalize, host handoff
    export) pass each host payload through `maybe_corrupt`, which may
    flip one byte.
  - coordination KV:  `ChaosKV` wraps any KV client and raises per plan.

Every plan is installed up front and fires deterministically: "crash
at step N" fires at step N, and fuzzed plans (`between=(lo, hi)`) draw
N once from the injector's own seeded RNG at install time, so two runs
with the same seed and install order inject the same faults (the JAX
package's injector draws the same numbers). The `fired` log lets tests
assert that a fault landed.
"""

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import torch

from dlrover_tpu_torch.common.log import default_logger as logger


class ChaosError(RuntimeError):
    """Base class for injected faults (so tests can catch injected
    failures without also swallowing real bugs)."""


class ReplicaCrashed(ChaosError):
    """Injected replica death: the engine raises this mid-serve, and
    the tag's probes keep failing until `revive()` — the in-process
    stand-in for a preempted TPU slice / OOM-killed pod."""


class ChipLost(ChaosError):
    """Injected chip loss: the replica is ALIVE but `n_chips` of its
    mesh slice are gone (ICI link down, single-chip ECC wreck). Unlike
    ReplicaCrashed the tag's probes keep passing — the stranded work
    is recoverable by re-forming the mesh at a smaller tp
    (serving/elastic.py), not by burying the replica. The injector
    remembers the lost-chip count per tag (`chips_lost`) so health
    probes see a degraded-but-alive device set until
    `restore_chip`/`revive`."""

    def __init__(self, msg: str, n_chips: int = 1):
        super().__init__(msg)
        self.n_chips = n_chips


class KVFlake(ConnectionError):
    """Injected coordination-KV failure. Subclasses ConnectionError so
    production retry paths treat it exactly like a real master blip."""


class _EngineFault:
    """One engine-dispatch plan: at `at_step`, raise or crash."""

    def __init__(
        self, at_step: int, exc: Exception, crash: bool,
        chips: int = 0,
    ):
        self.at_step = at_step
        self.exc = exc
        self.crash = crash  # crash => probes fail until revive()
        self.chips = chips  # >0 => record lost chips (probes stay ok)
        self.fired = False


class FaultInjector:
    """Seed-driven fault plans + the hooks that fire them.

    Thread-safe: the engine hook runs on scheduler threads, the probe
    hook on the pool thread, and plan installs on the test thread.
    """

    # cross-thread state under self._lock (LOCK-001). _rng stays out:
    # plan installation — the only consumer — runs on the test thread
    # before any hook thread exists.
    GUARDED_FIELDS = frozenset(
        {"_engine", "_slow", "_crashed", "_chips_lost", "_kv",
         "_corrupt", "_corrupt_seen", "fired"}
    )

    # KV byte-flip sites `corrupt_kv` can target: host-tier prefix
    # entries, swap-to-host page runs, and disaggregated handoff
    # packages — the three designated KV egress paths health.py's
    # checksums cover.
    CORRUPT_SITES = ("tier", "swap", "handoff")

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._engine: Dict[str, List[_EngineFault]] = {}
        # tag -> (delay_s, from_step, until_step)
        self._slow: Dict[str, Tuple[float, int, int]] = {}
        self._crashed: set = set()
        # tag -> chips currently lost (degraded-but-alive: probes
        # stay green, device_health() reports the deficit)
        self._chips_lost: Dict[str, int] = {}
        # tag -> [remaining_failures, exception factory]
        self._kv: Dict[str, List[Any]] = {}
        # (tag, where) -> sorted op indices still to corrupt;
        # (tag, where) -> ops seen so far at that site
        self._corrupt: Dict[Tuple[str, str], List[int]] = {}
        self._corrupt_seen: Dict[Tuple[str, str], int] = {}
        self.fired: List[Tuple[str, str, int]] = []  # (kind, tag, step)

    # ---- plan installation ----------------------------------------------

    def _pick_step(
        self,
        at_step: Optional[int],
        between: Optional[Tuple[int, int]],
    ) -> int:
        if at_step is not None:
            return int(at_step)
        if between is None:
            raise ValueError("need at_step or between=(lo, hi)")
        lo, hi = between
        return int(self._rng.integers(lo, hi))

    def crash_replica(
        self,
        tag: str,
        at_step: Optional[int] = None,
        between: Optional[Tuple[int, int]] = None,
    ) -> int:
        """Kill `tag` at an engine step: the dispatch raises
        ReplicaCrashed and the tag's probes fail until revive().
        Returns the (possibly seed-drawn) step so tests can log it."""
        step = self._pick_step(at_step, between)
        with self._lock:
            self._engine.setdefault(tag, []).append(
                _EngineFault(
                    step, ReplicaCrashed(f"{tag} crashed @step {step}"),
                    crash=True,
                )
            )
        return step

    def fail_engine_step(
        self,
        tag: str,
        at_step: Optional[int] = None,
        between: Optional[Tuple[int, int]] = None,
        exc: Optional[Exception] = None,
    ) -> int:
        """One transient engine-step exception at a step (the XLA
        error / host OOM shape): fires once, probes stay healthy."""
        step = self._pick_step(at_step, between)
        with self._lock:
            self._engine.setdefault(tag, []).append(
                _EngineFault(
                    step,
                    exc or ChaosError(f"{tag} step {step} failed"),
                    crash=False,
                )
            )
        return step

    def lose_chip(
        self,
        tag: str,
        n_chips: int = 1,
        at_step: Optional[int] = None,
        between: Optional[Tuple[int, int]] = None,
    ) -> int:
        """Yank `n_chips` devices out from under `tag` at an engine
        step: the dispatch raises ChipLost ONCE, probes stay green,
        and `chips_lost(tag)` reports the deficit until
        `restore_chip()`/`revive()` — the degraded-but-alive shape a
        live mesh shrink (serving/elastic.py) recovers from, as
        opposed to the whole-replica death `crash_replica` injects.
        Returns the (possibly seed-drawn) step."""
        if n_chips < 1:
            raise ValueError(f"lose_chip needs n_chips >= 1, got "
                             f"{n_chips}")
        step = self._pick_step(at_step, between)
        with self._lock:
            self._engine.setdefault(tag, []).append(
                _EngineFault(
                    step,
                    ChipLost(
                        f"{tag} lost {n_chips} chip(s) @step {step}",
                        n_chips=n_chips,
                    ),
                    crash=False,
                    chips=n_chips,
                )
            )
        return step

    def chips_lost(self, tag: str) -> int:
        """Chips currently lost for `tag` (0 = full slice). The
        device-health hook engine/pool probes consult — the CPU-host
        stand-in for querying the runtime's device set."""
        with self._lock:
            return self._chips_lost.get(tag, 0)

    def restore_chip(self, tag: str) -> None:
        """The lost chip(s) came back (relinked/replaced): clear the
        tag's deficit so health probes report a full slice again —
        the pool's probation re-probe then grows the replica back."""
        with self._lock:
            self._chips_lost.pop(tag, None)

    def slow_replica(
        self,
        tag: str,
        delay_s: float,
        from_step: int = 0,
        until_step: int = 1 << 30,
    ) -> None:
        """Stall every dispatch of `tag` in [from_step, until_step) by
        `delay_s` — the straggler/preemption-pressure shape."""
        with self._lock:
            self._slow[tag] = (float(delay_s), from_step, until_step)

    def flaky_kv(
        self, tag: str, fail_next: int, exc_type: type = KVFlake
    ) -> None:
        """Fail the next `fail_next` KV operations of `tag`."""
        with self._lock:
            self._kv[tag] = [int(fail_next), exc_type]

    def corrupt_kv(
        self,
        tag: str,
        where: str = "tier",
        at_step: Optional[int] = None,
        between: Optional[Tuple[int, int]] = None,
    ) -> int:
        """Flip one byte of a KV payload in transit at `tag`'s
        `where` site (tier | swap | handoff) — the host-memory /
        PCIe-transport bit-flip shape health.py's content checksums
        exist to catch.  `at_step` counts *operations at that site*
        (0 = the next payload through), drawn from the seeded RNG when
        `between=(lo, hi)` is given.  The flip happens AFTER the
        egress checksum is stamped, so a verifying ingress must
        quarantine the payload.  Returns the (possibly seed-drawn)
        op index."""
        if where not in self.CORRUPT_SITES:
            raise ValueError(
                f"corrupt_kv where must be one of {self.CORRUPT_SITES},"
                f" got {where!r}"
            )
        op = self._pick_step(at_step, between)
        with self._lock:
            plan = self._corrupt.setdefault((tag, where), [])
            plan.append(op)
            plan.sort()
        return op

    def revive(self, tag: str) -> None:
        """Clear the tag's crash state and any unfired engine plans —
        the replacement pod came up."""
        with self._lock:
            self._crashed.discard(tag)
            self._chips_lost.pop(tag, None)
            self._engine.pop(tag, None)
            self._slow.pop(tag, None)

    def is_crashed(self, tag: str) -> bool:
        with self._lock:
            return tag in self._crashed

    def crashed_tags(self) -> List[str]:
        """Tags currently crashed (probes failing). Chaos tests use
        this to assert the routing layer holds no stale state for a
        corpse — e.g. the fleet digest map must advertise no crashed
        tag's prefixes."""
        with self._lock:
            return sorted(self._crashed)

    # ---- hooks (called by serving components) ---------------------------

    def on_engine_step(self, tag: str, step: int) -> None:
        """Engine dispatch hook: may sleep (slow plan) or raise
        (crash / transient plan). A crashed tag keeps raising on any
        further dispatch until revive()."""
        delay = 0.0
        to_raise: Optional[Exception] = None
        with self._lock:
            if tag in self._crashed:
                to_raise = ReplicaCrashed(f"{tag} is crashed")
            else:
                slow = self._slow.get(tag)
                if slow and slow[1] <= step < slow[2]:
                    delay = slow[0]
                for fault in self._engine.get(tag, ()):
                    if not fault.fired and step >= fault.at_step:
                        fault.fired = True
                        if fault.crash:
                            self._crashed.add(tag)
                        if fault.chips:
                            self._chips_lost[tag] = (
                                self._chips_lost.get(tag, 0)
                                + fault.chips
                            )
                        self.fired.append(("engine", tag, step))
                        to_raise = fault.exc
                        break
        if delay > 0.0:
            time.sleep(delay)
        if to_raise is not None:
            logger.info("chaos: injecting %r at %s step %d",
                        to_raise, tag, step)
            raise to_raise

    def probe_ok(self, tag: str) -> bool:
        """Health-probe hook: False while the tag is crashed."""
        with self._lock:
            return tag not in self._crashed

    def on_kv_op(self, tag: str, op: str, key: str) -> None:
        """Coordination-KV hook: raise while the tag's flaky budget
        lasts."""
        with self._lock:
            plan = self._kv.get(tag)
            if plan is None or plan[0] <= 0:
                return
            plan[0] -= 1
            self.fired.append(("kv", tag, plan[0]))
            exc_type = plan[1]
        raise exc_type(f"injected {op}({key}) failure for {tag}")

    def maybe_corrupt(
        self, tag: str, where: str, data: Dict[str, Any]
    ) -> Dict[str, Any]:
        """KV-payload hook: the designated egress sites pass every
        host-side payload (dict of ndarrays or CPU tensors) through
        here AFTER
        stamping its checksum.  When a `corrupt_kv` plan matches this
        site's op index, one byte of one array is flipped (seeded
        choice of array/offset; the victim array is copied, never
        mutated in place) and ("corrupt", "tag#where", op) is logged
        to `fired`.  Returns the (possibly corrupted) payload."""
        with self._lock:
            key = (tag, where)
            op = self._corrupt_seen.get(key, 0)
            self._corrupt_seen[key] = op + 1
            plan = self._corrupt.get(key)
            if not plan or op < plan[0]:
                return data
            plan.pop(0)
            names = sorted(
                n for n, v in data.items()
                if getattr(v, "nbytes", 0) > 0
            )
            if not names:
                return data
            victim = names[int(self._rng.integers(0, len(names)))]
            src = data[victim]
            if isinstance(src, torch.Tensor):
                # a copy with the source's pinning: the flipped payload
                # must stay uploadable the way the original was
                arr = torch.empty_like(src, pin_memory=src.is_pinned())
                arr.copy_(src)
                flat = arr.view(-1).view(torch.uint8)
                off = int(self._rng.integers(0, flat.numel()))
                flat[off] ^= 0xFF
            else:
                arr = np.array(src, copy=True)
                flat = arr.view(np.uint8).reshape(-1)
                off = int(self._rng.integers(0, flat.size))
                flat[off] ^= 0xFF
            out = dict(data)
            out[victim] = arr
            self.fired.append(("corrupt", f"{tag}#{where}", op))
        logger.info("chaos: corrupted %s byte %d of %s/%s (op %d)",
                    victim, off, tag, where, op)
        return out


class ChaosKV:
    """A KV client double: delegates to `kv` (duck-typed set/get or
    kv_set/kv_get, like replica.py's `_kv_set`) after consulting the
    injector — so KV flakiness is injected at the client boundary,
    not by monkeypatching the store."""

    def __init__(self, kv, chaos: FaultInjector, tag: str = "kv"):
        self._kv = kv
        self._chaos = chaos
        self._tag = tag

    def set(self, key: str, value: bytes):
        self._chaos.on_kv_op(self._tag, "set", key)
        if hasattr(self._kv, "kv_set"):
            return self._kv.kv_set(key, value)
        return self._kv.set(key, value)

    def get(self, key: str) -> bytes:
        self._chaos.on_kv_op(self._tag, "get", key)
        if hasattr(self._kv, "kv_get"):
            return self._kv.kv_get(key)
        return self._kv.get(key)
