"""In-master KV store, its client-side retry wrapper, the fleet's
prefix directory and the named sync barriers — a copy of
dlrover_tpu/master/kv_store.py (stdlib only; the port imports nothing
of the JAX package). The serving replica pool speaks the KV verbs
(replica registration and heartbeats, the scale hint, the shared digest
directory), in process or through the master's `kv_set` / `kv_get`;
the master's servicer holds a `KVStoreService` and a `SyncService`.

Reference parity: dlrover/python/master/elastic_training/
kv_store_service.py (`KVStoreService`) and sync_service.py
(`SyncService`).
"""

import json
import random
import threading
import time
from typing import Dict, Iterable, List, Optional, Set


class KVStoreService:
    """Thread-safe bytes KV store living inside the master process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._store: Dict[str, bytes] = {}

    def set(self, key: str, value: bytes):
        with self._cond:
            self._store[key] = value
            self._cond.notify_all()

    def get(self, key: str) -> bytes:
        with self._lock:
            return self._store.get(key, b"")

    def add(self, key: str, delta: int) -> int:
        """Atomic counter add (torch Store `add` semantics)."""
        with self._cond:
            cur = int(self._store.get(key, b"0") or b"0")
            cur += delta
            self._store[key] = str(cur).encode()
            self._cond.notify_all()
            return cur

    def wait(self, key: str, timeout: float = 300.0) -> bytes:
        """Block until `key` exists (torch Store `wait` semantics)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while key not in self._store:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"kv_store wait({key!r}) timed out")
                self._cond.wait(remaining)
            return self._store[key]

    def delete(self, key: str) -> bool:
        with self._lock:
            return self._store.pop(key, None) is not None

    def clear(self):
        with self._lock:
            self._store.clear()


class RetryingKV:
    """Client-side retry wrapper over any KV store (duck-typed
    set/get or MasterClient's kv_set/kv_get): transient transport
    errors — ConnectionError/TimeoutError/OSError, the master-blip
    shapes — are retried with capped exponential backoff before they
    propagate. This is the serving heartbeat's analogue of the
    trainer's ckpt-restore fallback: a coordination-plane hiccup must
    not look like a replica failure.

    Non-transport exceptions pass straight through: a genuine bad
    call should fail loudly, not retry."""

    TRANSIENT = (ConnectionError, TimeoutError, OSError)

    def __init__(
        self,
        kv,
        retries: int = 3,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        sleep=time.sleep,
        jitter_seed: Optional[int] = None,
    ):
        self._kv = kv
        self.retries = retries
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._sleep = sleep
        # full jitter: with a seed, each sleep draws uniform(0, delay)
        # so replicas retrying through the same master blip don't
        # hammer it in lockstep. The undrawn delay still doubles, so
        # the envelope stays the legacy exponential. None = exact
        # legacy schedule.
        self._jitter_rng = (
            random.Random(jitter_seed)
            if jitter_seed is not None
            else None
        )

    def _call(self, primary: str, fallback: str, *args):
        fn = getattr(self._kv, primary, None)
        if fn is None:
            fn = getattr(self._kv, fallback)
        delay = self.backoff_base_s
        for attempt in range(self.retries + 1):
            try:
                return fn(*args)
            except self.TRANSIENT:
                if attempt >= self.retries:
                    raise
                if self._jitter_rng is not None:
                    self._sleep(self._jitter_rng.uniform(0.0, delay))
                else:
                    self._sleep(delay)
                delay = min(delay * 2.0, self.backoff_max_s)

    def set(self, key: str, value: bytes):
        return self._call("kv_set", "set", key, value)

    def get(self, key: str) -> bytes:
        return self._call("kv_get", "get", key)


class PrefixDirectory:
    """Fleet prefix→replica digest directory over any KV store.

    The replica pool's affinity router (serving/replica.py +
    serving/affinity.py) keeps an in-process digest map for the hot
    path; this directory is the SHARED view — one aggregated JSON
    document under `serving/prefix_map` that every gateway process
    pointed at the same master reads identically, the same duck-typed
    set/get (or MasterClient kv_set/kv_get) surface the heartbeat
    path already speaks. Only blake2b digests are stored: token data
    never reaches the master (serving/affinity.py's contract).

    Writes are read-modify-write per replica entry. That is safe in
    practice because exactly one pool owns a given replica id's
    entry (the pool that health-checks it) — concurrent pools touch
    disjoint keys of the document, and the pool serializes its own
    publishes on its background thread."""

    KEY = "serving/prefix_map"

    def __init__(self, kv):
        self._kv = kv

    def _read(self) -> Dict[str, List[str]]:
        if hasattr(self._kv, "kv_get"):
            raw = self._kv.kv_get(self.KEY)
        else:
            raw = self._kv.get(self.KEY)
        if not raw:
            return {}
        try:
            doc = json.loads(raw.decode())
        except (ValueError, UnicodeDecodeError):
            return {}
        return doc if isinstance(doc, dict) else {}

    def _write(self, doc: Dict[str, List[str]]) -> None:
        raw = json.dumps(doc, sort_keys=True).encode()
        if hasattr(self._kv, "kv_set"):
            self._kv.kv_set(self.KEY, raw)
        else:
            self._kv.set(self.KEY, raw)

    def publish(
        self, replica_id: str, digests: Iterable[str]
    ) -> None:
        """Replace `replica_id`'s advertised digest list (heartbeat
        refresh). An empty list removes the entry — same replace
        semantics as FleetDigestMap.update."""
        doc = self._read()
        ds = sorted(set(digests))
        if ds:
            doc[replica_id] = ds
        else:
            doc.pop(replica_id, None)
        self._write(doc)

    def drop(self, replica_id: str) -> None:
        """Remove a dead/ejected replica's entries so no gateway can
        route at a corpse (no stale routes — the chaos invariant)."""
        self.publish(replica_id, ())

    def snapshot(self) -> Dict[str, List[str]]:
        """replica id → advertised digests, fleet-wide."""
        return self._read()


class SyncService:
    """Named barriers across workers.

    Reference parity: master/elastic_training/sync_service.py:26 — workers
    `join` a named sync; once every expected worker joined, the sync is
    reached; `finish` marks it explicitly done (the reference's
    barrier/notify split).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._joined: Dict[str, Set[int]] = {}
        self._finished: Set[str] = set()
        self._expected: Optional[int] = None

    def set_expected_workers(self, n: Optional[int]):
        with self._lock:
            self._expected = n

    def join(self, sync_name: str, node_id: int) -> bool:
        """Returns True when the sync is now complete."""
        with self._lock:
            members = self._joined.setdefault(sync_name, set())
            members.add(node_id)
            if self._expected is not None and len(members) >= self._expected:
                self._finished.add(sync_name)
            return sync_name in self._finished

    def finish(self, sync_name: str):
        with self._lock:
            self._finished.add(sync_name)

    def reached(self, sync_name: str) -> bool:
        with self._lock:
            return sync_name in self._finished

    def members(self, sync_name: str) -> List[int]:
        with self._lock:
            return sorted(self._joined.get(sync_name, ()))
