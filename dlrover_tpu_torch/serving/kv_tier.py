"""Host-DRAM KV tier behind the prefix cache and the paged page pool —
the port's counterpart of dlrover_tpu/serving/kv_tier.py.

- DEMOTION: when the radix cache evicts a published prefix row, or a
  live page run is preempted under pressure, the K/V bytes are gathered
  into a fresh device tensor on the engine's stream and a non-blocking
  copy into a PAGE-LOCKED host tensor starts on a side stream, which
  first waits on an event recorded after the gather. The copy records
  its own event; the device staging tensor stays alive (in the entry)
  until that event has completed. `_fetch` is the one place that waits,
  and it runs from `drain()` at the top of the next step(), after the
  copies have had a whole dispatch to land. Nothing here synchronizes
  the device or the engine's stream.
- PROMOTION: a radix miss that the tier holds uploads the stored bytes
  from page-locked memory with non_blocking copies on the engine's
  stream, ahead of the dispatch that reads them, and installs them
  through the engine's own primitives: a fresh prefix-pool row, and
  (paged) `PageAllocator.promote()` pages filled by
  `models/decode.paged_install_row`, the quantize-on-install publish
  used, so promoted page bytes equal the bytes first published.
- SWAP: a preempted victim's live page run demotes instead of being
  dropped (`put_swap`); its readmission promotes it back and resumes
  from its folded position. Replay stays the fallback whenever the tier
  is full, the entry was evicted or a fault struck mid-demotion.

Entries are keyed by the chained blake2b digests of
`affinity.prefix_digest_chain`. With kv_tier_bytes=0 (the default) the
engine builds no HostKVTier and none of this runs.

On a tensor-parallel slice the device pools are sharded by KV head
(models/decode.py); a demotion gathers the shards into the one-device
layout ([L, rows, cells, KV, hd]) and a promotion cuts the stored bytes
back by head, so an entry's bytes, its checksum and `kv_tier_stats()`
are tp=1's, and entries outlive an elastic resize.
"""

import logging
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dlrover_tpu_torch._device import upload
from dlrover_tpu_torch.models.decode import (
    kv_read,
    kv_shards,
    kv_write,
    paged_install_row,
)
from dlrover_tpu_torch.serving.affinity import (
    MAX_PUBLISHED_DIGESTS,
    prefix_digest_chain,
)
from dlrover_tpu_torch.serving.health import kv_checksum, verify_checksum
from dlrover_tpu_torch.serving.paged_kv import TRASH_PAGE

logger = logging.getLogger(__name__)


def _bucket(n: int, lo: int = 4) -> int:
    """Next power of two >= max(n, lo): page-id vectors are padded to a
    bucket, as in the JAX tier (whose programs compile per bucket), so
    an entry stores the same bytes in both packages."""
    b = lo
    while b < n:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# Transfers


# one side stream per card for the demotion copies
_COPY_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    idx = device.index if device.index is not None else (
        torch.cuda.current_device())
    if idx not in _COPY_STREAMS:
        _COPY_STREAMS[idx] = torch.cuda.Stream(device=idx)
    return _COPY_STREAMS[idx]


class _HostCopy:
    """A device staging tensor whose copy into page-locked host memory
    is in flight on the side stream. `event` completes with the copy;
    `dev` is held until then so its memory cannot be reused under it."""

    __slots__ = ("dev", "host", "event")

    def __init__(self, dev: torch.Tensor):
        stream = _copy_stream(dev.device)
        ready = torch.cuda.Event()
        ready.record()  # on the engine's stream, after the gather
        self.host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            self.host.copy_(dev, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(stream)
        # the allocator must not hand `dev` to the engine's stream before
        # the side stream's read, even if the entry is dropped early
        dev.record_stream(stream)
        self.dev = dev

    @property
    def nbytes(self) -> int:
        return int(self.host.nbytes)


def _start_host_copy(piece: torch.Tensor):
    """Start the D2H copy of a freshly gathered device tensor; on the
    CPU the gather is already the host copy."""
    if piece.device.type != "cuda":
        return piece
    return _HostCopy(piece)


def _fetch(x) -> torch.Tensor:
    """THE tier's one waiting site: complete a copy started at demotion
    (a wait on its event, not on the device or a stream) and return the
    page-locked host tensor."""
    if isinstance(x, _HostCopy):
        x.event.synchronize()
        return x.host
    return x


def _to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """H2D of a stored host tensor: non-blocking from page-locked memory
    on the engine's stream (the host allocator keeps the block until the
    copy's event completes). The CPU engine reads the host tensor as it
    is."""
    if device.type != "cuda":
        return host
    return host.to(device, non_blocking=True)


def snapshot_row(pool, row: int, w: int) -> Dict[str, Any]:
    """D2H start of a prefix demotion: gather pool row `row`'s leading
    `w` cells ([L, 1, w, ...]) into fresh device tensors and start their
    host copies."""
    staged = kv_read(pool, lambda arr: arr[:, row:row + 1, :w].clone())
    return {name: _start_host_copy(t) for name, t in staged.items()}


def snapshot_pages(page_pool, ids: Sequence[int]) -> Dict[str, Any]:
    """D2H start of a swap-out demotion: gather the run's pages (ids
    padded to a bucket with TRASH_PAGE) and start their host copies."""
    m = _bucket(len(ids))
    padded = np.full(m, TRASH_PAGE, np.int64)
    padded[:len(ids)] = ids
    first = next(iter(kv_shards(page_pool)[0].values()))
    ids_dev = upload(padded, first.device)
    staged = kv_read(page_pool, lambda arr: arr[:, ids_dev.to(arr.device)])
    return {name: _start_host_copy(t) for name, t in staged.items()}


def upload_row(pool, ent: "TierEntry", row: int) -> Dict[str, torch.Tensor]:
    """H2D of a prefix promotion: upload the stored exact-dtype row and
    write it into pool row `row`. Returns the uploaded device row, which
    a paged engine installs into pages without a second PCIe trip."""
    home = next(iter(kv_shards(pool)[0].values())).device
    dev = {name: _to_device(host, home) for name, host in ent.data.items()}

    def put(arr, src):
        arr[:, row:row + 1, :src.shape[2]] = src.to(arr.dtype)

    kv_write(pool, dev, put)
    return dev


def install_row_pages(page_pool, dev_row, table_row: torch.Tensor, w: int):
    """Install an uploaded exact row into a promoted page run through
    `paged_install_row` (quantizing on the way in for an int8 pool).
    `table_row` is the trash-padded page-id row; cells past the real
    depth land on the trash page."""
    return paged_install_row(page_pool, dev_row, table_row, 0, w)


def upload_pages(page_pool, ent: "TierEntry", ids: Sequence[int]):
    """H2D of a swap-in: upload the stored page bytes and scatter them
    onto freshly promoted page ids (padded to the stored bucket with
    TRASH_PAGE: what lands on the trash page is garbage by contract)."""
    m = next(iter(ent.data.values())).shape[1]
    padded = np.full(m, TRASH_PAGE, np.int64)
    padded[:len(ids)] = ids
    first = next(iter(kv_shards(page_pool)[0].values()))
    ids_dev = upload(padded, first.device)
    data = {name: _to_device(host, first.device)
            for name, host in ent.data.items()}

    def put(arr, src):
        arr[:, ids_dev.to(arr.device)] = src.to(arr.dtype)

    kv_write(page_pool, data, put)
    return page_pool


# ---------------------------------------------------------------------------


def swap_digest(tokens: Sequence[int], salt: str = "") -> str:
    """One digest over the WHOLE folded token sequence, the swap entry's
    key (the prefix chain's hash with block = len(tokens)). `salt` (the
    adapter id) keeps adapted K/V from aliasing the base model's under
    equal tokens."""
    digest = prefix_digest_chain(tokens, max(len(tokens), 1))[0]
    return f"{digest}/{salt}" if salt else digest


@dataclass
class TierEntry:
    """One demoted K/V unit. `data` holds per-name tensors: copies in
    flight right after demotion, page-locked host tensors once
    finalized. `depth` is the number of VALID leading cells (a swap
    entry's last cell is the write frontier, rewritten by the first
    resumed decode step, as in replay)."""

    kind: str                     # "prefix" | "swap"
    digest: str
    tokens: Tuple[int, ...]
    depth: int
    data: Dict[str, Any]
    nbytes: int
    n_pages: int = 0              # swap: real pages stored (data is bucket-padded)
    page_size: int = 0
    final: bool = False           # data fully on the host
    checksum: str = ""            # content digest stamped at finalize


class HostKVTier:
    """Ref-counted, capacity-bounded (bytes), LRU host-DRAM tier.

    Every index touch holds _lock: the engine mutates entries while a
    heartbeat thread may read `prefix_digests()`."""

    GUARDED_FIELDS = frozenset({
        "_entries", "_refs", "bytes_used",
        "demotions", "promotions", "swap_outs", "swap_ins",
        "evictions", "rejects", "demote_failures",
        "promote_hits", "promote_misses",
        "quarantines", "integrity_checks",
    })

    def __init__(
        self,
        capacity_bytes: int,
        block: int = 16,
        chaos=None,
        chaos_tag: str = "kv_tier",
        checksums: bool = False,
    ):
        if capacity_bytes <= 0:
            raise ValueError(
                f"capacity_bytes must be > 0, got {capacity_bytes} "
                "(use kv_tier_bytes=0 on the engine to disable the tier)"
            )
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.capacity_bytes = int(capacity_bytes)
        self.block = block
        # chaos hook: a fault plan on `chaos_tag` fires mid-demotion
        # (inside put_*, after the gather was dispatched, before the
        # entry is recorded); the engine catches it and replays
        self.chaos = chaos
        self.chaos_tag = chaos_tag
        # kv_checksums: stamp a digest over every entry's host bytes at
        # finalize (egress) and verify it before they are promoted
        # (ingress); a mismatch quarantines the entry
        self.checksums = bool(checksums)
        self._lock = threading.RLock()
        # LRU: oldest first, newest last
        self._entries: "OrderedDict[Tuple[str, str], TierEntry]" = (
            OrderedDict()
        )
        # entries pinned by a promotion upload: eviction never drops
        # bytes mid-upload
        self._refs: Dict[Tuple[str, str], int] = {}
        self.bytes_used = 0
        # monotonic counters (the JAX tier's stats keys)
        self.demotions = 0
        self.promotions = 0
        self.swap_outs = 0
        self.swap_ins = 0
        self.evictions = 0
        self.rejects = 0
        self.demote_failures = 0
        self.promote_hits = 0
        self.promote_misses = 0
        self.quarantines = 0
        self.integrity_checks = 0
        self._demote_seq = 0
        # transfer telemetry (transfer_stats): bytes each way and the
        # host time finalize spent waiting for copies
        self.bytes_d2h = 0
        self.bytes_h2d = 0
        self.fetch_wait_ms = 0.0

    # ---- internals -------------------------------------------------------

    @staticmethod
    def _key(kind: str, digest: str) -> Tuple[str, str]:
        return (kind, digest)

    def _finalize(self, ent: TierEntry) -> None:
        """Complete the entry's copies (idempotent): the KV egress site.
        The checksum is stamped the moment the bytes are on the host;
        the chaos byte-flip runs AFTER the stamp (corruption in transit
        is what a verifying ingress must catch)."""
        if ent.final:
            return
        t0 = time.perf_counter()
        ent.data = {k: _fetch(v) for k, v in ent.data.items()}
        self.fetch_wait_ms += (time.perf_counter() - t0) * 1e3
        if self.checksums:
            ent.checksum = kv_checksum(ent.data)
        if self.chaos is not None and hasattr(self.chaos, "maybe_corrupt"):
            where = "tier" if ent.kind == "prefix" else "swap"
            ent.data = self.chaos.maybe_corrupt(
                self.chaos_tag, where, ent.data
            )
        ent.final = True

    def _verify_locked(self, ent: TierEntry) -> bool:
        """Content-verify a finalized entry at its ingress; true with
        checksums off or for an entry stored unstamped."""
        if not self.checksums or not ent.checksum:
            return True
        self.integrity_checks += 1
        return verify_checksum(ent.data, ent.checksum)

    def _quarantine_locked(self, ent: TierEntry) -> None:
        """Drop a corrupted entry for good: never re-served, no longer
        advertised, its bytes released."""
        key = self._key(ent.kind, ent.digest)
        if self._entries.pop(key, None) is not None:
            self.bytes_used -= ent.nbytes
        self._refs.pop(key, None)
        self.quarantines += 1
        logger.warning(
            "kv_tier: quarantined corrupted %s entry %s (%d bytes)",
            ent.kind, ent.digest[:16], ent.nbytes,
        )

    def _evict_for_locked(self, need: int) -> bool:
        """Evict LRU unreferenced entries until `need` bytes fit; False
        when they cannot (larger than capacity, or all pinned)."""
        if need > self.capacity_bytes:
            return False
        while self.bytes_used + need > self.capacity_bytes:
            victim = None
            for key in self._entries:  # oldest first
                if self._refs.get(key, 0) == 0:
                    victim = key
                    break
            if victim is None:
                return False
            ent = self._entries.pop(victim)
            self.bytes_used -= ent.nbytes
            self.evictions += 1
        return True

    def _put(self, ent: TierEntry) -> bool:
        self._demote_seq += 1
        self.bytes_d2h += ent.nbytes  # the copy is already under way
        if self.chaos is not None:
            # may raise: the injected crash mid-demotion. The gather and
            # its copy were started; nothing is recorded yet, so the
            # failure leaks neither bytes nor entries
            self.chaos.on_engine_step(self.chaos_tag, self._demote_seq)
        with self._lock:
            key = self._key(ent.kind, ent.digest)
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes_used -= old.nbytes
            if not self._evict_for_locked(ent.nbytes):
                if old is not None:  # keep the previous bytes
                    self._entries[key] = old
                    self.bytes_used += old.nbytes
                self.rejects += 1
                return False
            self._entries[key] = ent
            self.bytes_used += ent.nbytes
        return True

    # ---- demotion --------------------------------------------------------

    def put_prefix(
        self, tokens: Sequence[int], staged: Dict[str, Any], depth: int
    ) -> bool:
        """Record an evicted published prefix (exact pool-row bytes,
        copies in flight). `tokens` is the block-aligned prefix, `depth`
        its length in cells."""
        toks = tuple(int(t) for t in tokens)
        chain = prefix_digest_chain(toks, self.block)
        if not chain:
            return False
        nbytes = sum(int(a.nbytes) for a in staged.values())
        ok = self._put(TierEntry(
            kind="prefix", digest=chain[-1], tokens=toks,
            depth=int(depth), data=staged, nbytes=nbytes,
        ))
        if ok:
            with self._lock:
                self.demotions += 1
        return ok

    def put_swap(
        self,
        tokens: Sequence[int],
        staged: Dict[str, Any],
        n_pages: int,
        page_size: int,
        salt: str = "",
    ) -> bool:
        """Record a preempted victim's live page run (cells
        [0, len(tokens)), the last one rewritten on resume)."""
        toks = tuple(int(t) for t in tokens)
        if not toks:
            return False
        nbytes = sum(int(a.nbytes) for a in staged.values())
        ok = self._put(TierEntry(
            kind="swap", digest=swap_digest(toks, salt), tokens=toks,
            depth=len(toks), data=staged, nbytes=nbytes,
            n_pages=int(n_pages), page_size=int(page_size),
        ))
        if ok:
            with self._lock:
                self.swap_outs += 1
                self.demotions += 1
        return ok

    def note_demote_failure(self) -> None:
        with self._lock:
            self.demote_failures += 1

    # ---- promotion -------------------------------------------------------

    def match_prefix(
        self, tokens: Sequence[int], min_depth: int = 0
    ) -> Optional[TierEntry]:
        """Deepest stored prefix of `tokens` STRICTLY deeper than
        `min_depth` (the radix cache's own match: the tier wins only
        where PCIe beats recompute), finalized and LRU-touched. Counts
        the promote hit / miss."""
        chain = prefix_digest_chain(tokens, self.block)
        with self._lock:
            for i in range(len(chain) - 1, -1, -1):
                if (i + 1) * self.block <= min_depth:
                    break
                ent = self._entries.get(self._key("prefix", chain[i]))
                if ent is not None:
                    self._finalize(ent)
                    if not self._verify_locked(ent):
                        # corrupted in transit: quarantine and keep
                        # scanning shallower prefixes
                        self._quarantine_locked(ent)
                        continue
                    self._entries.move_to_end(self._key("prefix", chain[i]))
                    self.promote_hits += 1
                    return ent
            self.promote_misses += 1
        return None

    def peek_swap(
        self, tokens: Sequence[int], salt: str = ""
    ) -> Optional[TierEntry]:
        """The swap entry of this exact folded sequence, finalized and
        NOT consumed: the caller installs first and consume()s after, so
        an admission that cannot allocate keeps the bytes."""
        toks = tuple(int(t) for t in tokens)
        if not toks:
            return None
        with self._lock:
            ent = self._entries.get(self._key("swap", swap_digest(toks, salt)))
            if ent is not None:
                self._finalize(ent)
                if not self._verify_locked(ent):
                    # corrupted in transit: the caller replays
                    self._quarantine_locked(ent)
                    return None
            return ent

    def consume(self, ent: TierEntry) -> None:
        """A swap entry was promoted into a live slot: single use (its
        bytes now live on the device and diverge as the slot decodes)."""
        with self._lock:
            key = self._key(ent.kind, ent.digest)
            if self._entries.pop(key, None) is not None:
                self.bytes_used -= ent.nbytes
            self.swap_ins += 1
            self.promotions += 1
            self.bytes_h2d += ent.nbytes

    def note_promoted(self, ent: TierEntry) -> None:
        """A prefix entry was re-published on the device; the host copy
        stays (LRU-touched)."""
        with self._lock:
            self.promotions += 1
            self.bytes_h2d += ent.nbytes

    def acquire(self, ent: TierEntry) -> None:
        """Pin an entry across a promotion upload."""
        with self._lock:
            key = self._key(ent.kind, ent.digest)
            self._refs[key] = self._refs.get(key, 0) + 1

    def release(self, ent: TierEntry) -> None:
        with self._lock:
            key = self._key(ent.kind, ent.digest)
            n = self._refs.get(key, 0)
            if n <= 1:
                self._refs.pop(key, None)
            else:
                self._refs[key] = n - 1

    # ---- maintenance -----------------------------------------------------

    def drain(self) -> None:
        """Complete every pending copy (the engine calls this at the top
        of each step, after the copies had a dispatch to land), so
        staging tensors do not pin device memory."""
        with self._lock:
            for ent in self._entries.values():
                self._finalize(ent)

    def clear(self) -> None:
        """Drop everything (engine reset)."""
        with self._lock:
            self._entries.clear()
            self._refs.clear()
            self.bytes_used = 0

    # ---- advertisement / telemetry ---------------------------------------

    def prefix_digests(self, limit: int = MAX_PUBLISHED_DIGESTS) -> List[str]:
        """Digests of the stored PREFIX entries, newest first, capped."""
        out: List[str] = []
        with self._lock:
            for _, ent in reversed(self._entries.items()):
                if ent.kind == "prefix":
                    out.append(ent.digest)
                    if len(out) >= limit:
                        break
        return out

    def entry_count(self, kind: Optional[str] = None) -> int:
        with self._lock:
            if kind is None:
                return len(self._entries)
            return sum(1 for e in self._entries.values() if e.kind == kind)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            lookups = self.promote_hits + self.promote_misses
            return {
                "capacity_bytes": float(self.capacity_bytes),
                "bytes_used": float(self.bytes_used),
                "entries": float(len(self._entries)),
                "prefix_entries": float(sum(
                    1 for e in self._entries.values() if e.kind == "prefix"
                )),
                "swap_entries": float(sum(
                    1 for e in self._entries.values() if e.kind == "swap"
                )),
                "demotions": float(self.demotions),
                "promotions": float(self.promotions),
                "swap_outs": float(self.swap_outs),
                "swap_ins": float(self.swap_ins),
                "evictions": float(self.evictions),
                "rejects": float(self.rejects),
                "demote_failures": float(self.demote_failures),
                "promote_hits": float(self.promote_hits),
                "promote_misses": float(self.promote_misses),
                "promote_hit_rate": (
                    self.promote_hits / lookups if lookups else 0.0
                ),
                "checksums": float(self.checksums),
                "integrity_checks": float(self.integrity_checks),
                "quarantines": float(self.quarantines),
            }

    def transfer_stats(self) -> Dict[str, float]:
        """Bytes demoted (D2H) and promoted (H2D) and the host time spent
        waiting for demotion copies to complete. Not in stats(): the
        JAX tier has no such keys."""
        with self._lock:
            return {
                "bytes_d2h": float(self.bytes_d2h),
                "bytes_h2d": float(self.bytes_h2d),
                "fetch_wait_ms": self.fetch_wait_ms,
            }
