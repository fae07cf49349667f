"""Cross-replica KV handoff for phase-split serving — the port's
counterpart of dlrover_tpu/serving/handoff.py: the package, the export,
the adoption, and the coordinator that routes packages from
prefill-role replicas to decode targets (`HandoffCoordinator`, wired by
the replica pool).

A prefill-role engine's admission IS the prefill: right after it the
slot holds exactly what a colocated engine holds before its first
decode step (zero tokens emitted, carry token at cell p-1, the
request's sampling seed drawn). `export_run` packages that state:

- paged: gather the slot's occupied pages out of the page pool — the
  shipped tensor is [L, n_ship (bucket-padded), page_size, KV, hd] per
  pool entry — plus the prompt, the remaining budget and the seed;
- dense: slice the slot's bank row up to the prompt's pow2 bucket.

`adopt_into_slot` is the decode-side inverse: fresh pages through
`PageAllocator.adopt`, the shipped cells scattered onto them and the
slot's table row written (adopted pages arrive at refcount 1, nothing
to copy on write).

Transports on one card: "device" keeps the gathered tensors on the card
(a gather and a scatter); "host" bounces them through page-locked host
memory (`_host_bounce`, the one D2H site), is stamped with
`kv_checksum` when the engine has kv_checksums=1 and passes through the
fault injector's `maybe_corrupt`. The coordinator verifies a stamped
package before any target enqueues it (a mismatch sends the request
back to replay on its prefill replica), and adoption verifies it again
and raises KVIntegrityError on a mismatch.

A package is always in the one-device layout: an export from a
tensor-parallel slice gathers its head shards, an adoption cuts the
cells back by head (models/decode.py `kv_read` / `kv_write`), so the
bytes and the checksum equal tp=1's and packages move between replicas
of any tp.
"""

import dataclasses
import threading
from typing import Any, Dict, List

import numpy as np
import torch

from dlrover_tpu_torch._device import upload
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.models.decode import kv_read, kv_write
from dlrover_tpu_torch.serving.engine import _pad_bucket
from dlrover_tpu_torch.serving.health import (
    KVIntegrityError,
    kv_checksum,
    verify_checksum,
)
from dlrover_tpu_torch.serving.paged_kv import TRASH_PAGE, OutOfPages


def _host_bounce(arr: torch.Tensor) -> torch.Tensor:
    """THE host transport's D2H point: a non-blocking copy into
    page-locked memory and a wait on its event (the package must be on
    the host before it is stamped). The CPU engine's gather already is
    the host copy."""
    if arr.device.type != "cuda":
        return arr
    host = torch.empty(arr.shape, dtype=arr.dtype, pin_memory=True)
    host.copy_(arr, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return host


# ---- the package ---------------------------------------------------------


@dataclasses.dataclass
class KVHandoff:
    """One prefilled request, packaged for adoption elsewhere."""

    prompt: np.ndarray            # [p] the original prompt
    max_new: int                  # remaining token budget
    # the request's sampling seed, or the generator state it was
    # submitted with (a resumed request continues that stream)
    prng_key: Any
    kv_layout: str                # "dense" | "paged"
    transport: str                # "device" | "host"
    n_cells: int                  # prompt cells resident (== p)
    data: Dict[str, Any]          # pool entry name -> shipped cells
    page_size: int = 0            # paged only
    n_ship: int = 0               # occupied pages shipped (paged)
    src: str = ""                 # source engine's chaos tag
    checksum: str = ""            # content digest (host transport)

    @property
    def nbytes(self) -> int:
        return int(sum(v.nbytes for v in self.data.values()))


def export_run(engine, idx: int, transport: str = "device") -> KVHandoff:
    """Package request `idx`'s resident KV for adoption. The slot must
    still be live: call before retire() frees its pages or row."""
    if transport not in ("device", "host"):
        raise ValueError(
            f"transport must be 'device' or 'host', got {transport!r}"
        )
    slot = next(
        (
            s for s in range(engine.n_slots)
            if engine.slot_req[s] is not None
            and engine.slot_req[s].idx == idx
        ),
        None,
    )
    if slot is None:
        raise KeyError(f"request {idx} holds no live slot")
    req = engine.slot_req[slot]
    p = len(req.prompt)
    if engine.kv_layout == "paged":
        run = engine._slot_pages[slot]
        n_ship = (p - 1) // engine.page_size + 1
        ids = np.full(_pad_bucket(n_ship, lo=4), TRASH_PAGE, np.int64)
        ids[:n_ship] = run[:n_ship]
        ids_dev = engine._upload(ids)
        data = kv_read(engine.page_pool,
                       lambda arr: arr[:, ids_dev.to(arr.device)])
        page_size = engine.page_size
    else:
        bank_len = engine.max_len + engine.spec_draft_len
        w = min(_pad_bucket(p), bank_len)
        data = kv_read(engine.cache,
                       lambda arr: arr[:, slot:slot + 1, :w].clone())
        page_size, n_ship = 0, 0
    checksum = ""
    if transport == "host":
        # the handoff EGRESS: stamp the digest the moment the bytes are
        # on the host, then let the fault injector model corruption in
        # transit (the adopting ingress verifies)
        data = {name: _host_bounce(v) for name, v in data.items()}
        if engine.kv_checksums:
            checksum = kv_checksum(data)
        if engine.chaos is not None and hasattr(engine.chaos, "maybe_corrupt"):
            data = engine.chaos.maybe_corrupt(engine.chaos_tag, "handoff", data)
    return KVHandoff(
        prompt=np.asarray(req.prompt, np.int64).copy(),
        max_new=max(int(engine.limit[slot]) - p, 1),
        prng_key=(req.gen_state.clone() if req.gen_state is not None
                  else int(req.seed)),
        kv_layout=engine.kv_layout,
        transport=transport,
        n_cells=p,
        data=data,
        page_size=page_size,
        n_ship=n_ship,
        src=engine.chaos_tag,
        checksum=checksum,
    )


def check_compatible(engine, pkg: KVHandoff) -> None:
    """Raise ValueError when `engine` cannot adopt `pkg` (the caller's
    cue to try another target or to replay)."""
    if engine.kv_layout != pkg.kv_layout:
        raise ValueError(
            f"kv_layout mismatch: package {pkg.kv_layout!r}, "
            f"engine {engine.kv_layout!r}"
        )
    if pkg.kv_layout == "paged":
        if engine.page_size != pkg.page_size:
            raise ValueError(
                f"page_size mismatch: package {pkg.page_size}, "
                f"engine {engine.page_size}"
            )
    else:
        bank_len = engine.max_len + engine.spec_draft_len
        w = next(iter(pkg.data.values())).shape[2]
        if w > bank_len:
            raise ValueError(
                f"shipped row width {w} exceeds engine bank length "
                f"{bank_len}"
            )
    if len(pkg.prompt) + 1 > engine.max_len:
        raise ValueError(
            f"prompt length {len(pkg.prompt)} leaves no room to generate "
            f"(max_len {engine.max_len})"
        )


def _on_device(v: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A shipped tensor on the adopting engine's device: itself when it
    is there already (the device transport), else a non-blocking upload
    from page-locked memory."""
    return v.to(device, non_blocking=True)


def _adopt_pages(engine, n: int) -> List[int]:
    """Reserve `n` pages for a shipped run, reclaiming as _alloc_pages
    does (evict prefix runs, then preempt)."""
    while True:
        try:
            return engine.allocator.adopt(n)
        except OutOfPages:
            if not engine._reclaim_pages():
                raise


def adopt_into_slot(engine, slot: int, pkg: KVHandoff) -> None:
    """Install a shipped package into `slot` in place of a prefill
    (called from the engine's admission, whose tail then sets the carry
    token, position, limit and generator as a colocated admission of the
    same prompt would). Raises KVIntegrityError on a stamped package
    that no longer verifies, OutOfPages when the pool cannot back the
    request even after reclaim."""
    if pkg.checksum:
        # the handoff INGRESS: corrupted bytes are never installed
        engine._integrity_checks += 1
        if not verify_checksum(pkg.data, pkg.checksum):
            engine._integrity_quarantines += 1
            raise KVIntegrityError(
                f"handoff package from {pkg.src or 'unknown source'} "
                "failed content verification; quarantined"
            )
    check_compatible(engine, pkg)
    dev = engine.device
    if engine.kv_layout == "paged":
        p = pkg.n_cells
        limit = min(p + pkg.max_new, engine.max_len)
        n_need = (limit - 1 + engine.spec_draft_len) // engine.page_size + 1
        adopted = _adopt_pages(engine, pkg.n_ship)
        try:
            own = engine._alloc_pages(n_need - pkg.n_ship)
        except OutOfPages:
            engine.allocator.free(adopted)
            raise
        m = next(iter(pkg.data.values())).shape[1]
        ids = np.full(m, TRASH_PAGE, np.int64)
        ids[:pkg.n_ship] = adopted
        ids_dev = upload(ids, dev)

        def put(arr, src):
            arr[:, ids_dev.to(arr.device)] = src.to(arr.dtype)

        kv_write(engine.page_pool,
                 {n: _on_device(v, dev) for n, v in pkg.data.items()}, put)
        run = adopted + own
        engine._table[slot] = engine._table_row(run)
        engine._slot_pages[slot] = run
    else:
        def put(arr, src):
            arr[:, slot:slot + 1, :src.shape[2]] = src.to(arr.dtype)

        kv_write(engine.cache,
                 {n: _on_device(v, dev) for n, v in pkg.data.items()}, put)


# ---- the coordinator -----------------------------------------------------


class HandoffCoordinator:
    """Routes prefilled requests from prefill-role replicas to decode
    targets. Wired as each prefill scheduler's `on_handoff` by
    ReplicaPool.add(); called OUTSIDE the source scheduler's lock
    (the `_dispatch_failure` discipline — adoption takes the target's
    lock). Returns True when the request was handled (adopted, or
    terminally shed by the target's deadline check); False sends the
    scheduler to the resume-by-replay fallback."""

    # _step is bumped from every prefill scheduler's pump thread, under
    # _lock
    GUARDED_FIELDS = frozenset({"_step"})

    def __init__(
        self,
        pool,
        chaos=None,
        chaos_tag: str = "handoff",
    ):
        self.pool = pool
        self.chaos = chaos
        self.chaos_tag = chaos_tag
        self._lock = threading.Lock()
        self._step = 0

    def _targets(self, source) -> List[Any]:
        """Healthy non-source adopters, decode-role first (colocated
        replicas are valid fallback targets — they can decode anything
        — but never steal work from dedicated decoders), least-loaded
        first for the same reason routing is."""
        reps = [
            r
            for r in self.pool.replicas()
            if r.scheduler is not source
            and r.healthy
            and not r.scheduler.crashed
            and getattr(r, "role", "colocated") != "prefill"
        ]
        decode = [r for r in reps if r.role == "decode"]
        out = decode or reps
        out.sort(key=lambda r: r.load())
        return out

    def on_prefill_done(self, scheduler, ticket, pkg) -> bool:
        with self._lock:
            step = self._step
            self._step += 1
        if self.chaos is not None:
            # the mid-handoff crash point: the package is exported,
            # the source slot retired, nothing adopted yet — exactly
            # the state resume-by-replay must recover from
            self.chaos.on_engine_step(self.chaos_tag, step)
        req = ticket.req
        if pkg.checksum:
            # the handoff INGRESS gate: verify the stamped package
            # HERE, before any target enqueues it — adoption itself
            # runs later, inside the target engine's admission pump,
            # where a raise would read as a fatal engine failure and
            # eject the healthy decoder. Returning False instead sends
            # the source scheduler down the resume-by-replay fallback:
            # the request re-prefills from its journaled prompt and
            # generator state, and the corrupted bytes are never
            # shipped anywhere.
            src_eng = getattr(scheduler, "engine", None)
            if src_eng is not None and hasattr(src_eng, "_integrity_checks"):
                src_eng._integrity_checks += 1
            if not verify_checksum(pkg.data, pkg.checksum):
                if src_eng is not None and hasattr(
                    src_eng, "_integrity_quarantines"
                ):
                    src_eng._integrity_quarantines += 1
                logger.warning(
                    "handoff package for request %d failed content "
                    "verification; quarantined — resuming by replay",
                    req.id,
                )
                return False
        for rep in self._targets(scheduler):
            try:
                rep.scheduler.adopt(req, ticket, pkg)
            except Exception:  # noqa: BLE001 — try the next target
                logger.warning(
                    "replica %s cannot adopt request %d",
                    rep.id, req.id, exc_info=True,
                )
                continue
            # adopted, or shed by the target's deadline check —
            # terminal either way, replay would not help
            return True
        return False
