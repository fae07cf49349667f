"""Fleet prefix affinity — a copy of dlrover_tpu/serving/affinity.py
(host-only hashing and bookkeeping; the port imports nothing of the JAX
package): digest chains over block-aligned prompt prefixes, and the
digest -> replica map the replica pool routes with.

- `prefix_digest_chain(tokens, block)` hashes each block-aligned prefix
  of a prompt into a chained blake2b digest: digest i covers tokens
  [0, (i+1)*block), so two prompts share digest i iff they share that
  exact aligned prefix. The alignment is `RadixPrefixCache.aligned_len`'s
  (floor to `block`), so a digest names a prefix the cache can install.
- `cache_digests(cache)` enumerates the digests of every PUBLISHED
  prefix of a radix cache, newest-touched first, capped: the set a
  replica advertises in its heartbeat. Only digests leave a replica.
- `FleetDigestMap` is the pool's view: digest -> replica ids, replaced
  wholesale per heartbeat (`update`) and dropped on death (`drop`), so
  a crashed replica never attracts a stale route. Host-tier prefixes
  (serving/kv_tier.py keys its entries by these digests) count half a
  block less than a device match at the same depth.
- `affinity_order` is the candidate ranking `ReplicaPool.submit`
  applies: longest digest match first, the incoming load order within
  equal depth, bounded by an imbalance cap so a hot prefix cannot
  starve the fleet.
"""

import hashlib
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence

DIGEST_BYTES = 8  # 64-bit hex digests: small heartbeats, ~no collisions
# advertisement cap: at most this many published prefixes (the
# newest-touched win, see cache_digests)
MAX_PUBLISHED_DIGESTS = 256


def _block_digest(prev_hex: str, block_tokens: Sequence[int]) -> str:
    h = hashlib.blake2b(digest_size=DIGEST_BYTES)
    h.update(prev_hex.encode())
    for t in block_tokens:
        h.update(int(t).to_bytes(8, "little", signed=True))
    return h.hexdigest()


def prefix_digest_chain(tokens: Sequence[int], block: int) -> List[str]:
    """Chained digests of every block-aligned prefix of `tokens`:
    element i covers tokens [0, (i+1)*block), so the chain's length is
    aligned_len(len(tokens)) // block."""
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    n = (len(tokens) // block) * block
    chain: List[str] = []
    prev = ""
    for i in range(0, n, block):
        prev = _block_digest(prev, tokens[i:i + block])
        chain.append(prev)
    return chain


def cache_digests(cache, limit: int = MAX_PUBLISHED_DIGESTS) -> List[str]:
    """Digests of the PUBLISHED prefixes of a RadixPrefixCache, one per
    node holding a pool row, by chaining the block edges from the root
    (`published_blocks`). At most `limit`, newest-touched rows first."""
    out: List[str] = []
    for path in cache.published_blocks():
        prev = ""
        for edge in path:
            prev = _block_digest(prev, edge)
        out.append(prev)
        if len(out) >= limit:
            break
    return out


class FleetDigestMap:
    """digest → replica-id index over every replica's advertised
    prefixes. Heartbeat-refreshed (replace semantics per replica) and
    eagerly dropped on death so routing can never chase a stale
    entry. Thread-safe: heartbeats land on the pool thread while
    submit() reads on request threads."""

    # all four indexes mutate together, under _lock
    GUARDED_FIELDS = frozenset(
        {"_by_digest", "_by_replica", "_host_by_digest",
         "_host_by_replica"}
    )

    def __init__(self):
        self._lock = threading.Lock()
        # digest -> set of replica ids advertising it
        self._by_digest: Dict[str, set] = {}
        # replica id -> the digests it currently advertises
        self._by_replica: Dict[str, frozenset] = {}
        # the HOST-TIER mirror of the two indexes above: prefixes a
        # replica holds demoted in host DRAM (serving/kv_tier.py), one
        # PCIe promotion away from device-warm. Routing half-counts
        # them — a host hit beats a cold prefill, a device hit beats
        # both — which is the digest map's `tier` bit.
        self._host_by_digest: Dict[str, set] = {}
        self._host_by_replica: Dict[str, frozenset] = {}

    def update(
        self,
        replica_id: str,
        digests: Iterable[str],
        host_digests: Iterable[str] = (),
    ) -> None:
        """Replace `replica_id`'s advertised sets (heartbeat refresh).
        Digests the replica no longer publishes (evicted rows, evicted
        host entries) drop out — the map mirrors the caches, it never
        accretes. `host_digests` are the replica's host-DRAM tier
        prefixes; replicas without a tier just advertise ()."""
        new = frozenset(digests)
        new_host = frozenset(host_digests)
        with self._lock:
            for by_digest, by_replica, fresh in (
                (self._by_digest, self._by_replica, new),
                (self._host_by_digest, self._host_by_replica, new_host),
            ):
                old = by_replica.get(replica_id, frozenset())
                for d in old - fresh:
                    members = by_digest.get(d)
                    if members is not None:
                        members.discard(replica_id)
                        if not members:
                            del by_digest[d]
                for d in fresh - old:
                    by_digest.setdefault(d, set()).add(replica_id)
                if fresh:
                    by_replica[replica_id] = fresh
                else:
                    by_replica.pop(replica_id, None)

    def drop(self, replica_id: str) -> None:
        """Remove every entry for a dead/ejected replica — called the
        moment the pool stops routing to it, so no request can be
        steered at a corpse by a digest published before it died."""
        self.update(replica_id, (), ())

    def match_depths(
        self, chain: Sequence[str]
    ) -> Dict[str, float]:
        """replica id → longest matched prefix depth, in BLOCKS
        (chain index + 1). A replica advertising chain[i] holds the
        aligned prefix of (i+1)*block tokens. A HOST-TIER match at
        chain[i] scores i + 0.5 — deeper than any shallower device
        match (PCIe promotion beats recomputing the extra blocks) but
        shallower than a device match at the same depth (promotion is
        not free) — so values are ints for pure device fleets and
        floats only when a tier entry wins. Replicas matching nothing
        are absent."""
        depths: Dict[str, float] = {}
        with self._lock:
            for i, digest in enumerate(chain):
                for rid in self._by_digest.get(digest, ()):
                    depths[rid] = i + 1
            for i, digest in enumerate(chain):
                for rid in self._host_by_digest.get(digest, ()):
                    if i + 0.5 > depths.get(rid, 0):
                        depths[rid] = i + 0.5
        return depths

    def replicas(self) -> List[str]:
        with self._lock:
            return sorted(self._by_replica)

    def size(self) -> int:
        """Distinct digests currently mapped (gauge)."""
        with self._lock:
            return len(self._by_digest)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "digests": len(self._by_digest),
                "replicas": len(self._by_replica),
                "host_digests": len(self._host_by_digest),
            }


def affinity_order(
    candidates: List,
    depths: Dict[str, float],
    load_of: Callable[[object], float],
    max_imbalance: float,
    capped: Optional[List] = None,
) -> List:
    """Re-rank `candidates` (already in load order) by prefix
    affinity: longest digest match first, load order within equal
    depth, bounded by the imbalance cap — a matched replica whose
    load exceeds min(load) + `max_imbalance` is treated as unmatched,
    so a hot prefix spills to the coolest replicas instead of
    starving the fleet behind one cache-warm peer. Stable: replicas
    without a match keep their incoming (load) order, which is what
    makes the full-fleet fallback exactly least-loaded routing.

    `capped`, when given, collects the replicas whose match was
    voided by the imbalance cap (telemetry for the affinity-capped
    counter)."""
    if not depths or len(candidates) <= 1:
        return candidates
    floor = min(load_of(r) for r in candidates)
    cutoff = floor + max_imbalance

    def effective_depth(rep) -> float:
        d = depths.get(rep.id, 0)
        if d > 0 and load_of(rep) > cutoff:
            if capped is not None:
                capped.append(rep)
            return 0
        return d

    # stable sort: equal effective depths preserve load order
    return sorted(candidates, key=lambda r: -effective_depth(r))
