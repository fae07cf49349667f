"""Live elastic resize of a serving replica — counterpart of
dlrover_tpu/serving/elastic.py.

A tp=4 replica that loses a chip does not die: it re-forms its slice at
the largest tp the surviving chips and the KV heads allow, and grows
back when the chip returns. Nothing live is resharded: every live
request is preempted for replay (resume-by-replay: the prompt, the
emitted tokens and the sampling generator's state rebuild it from host
data alone), the banks are made fresh at the new tp, and the queue
replays.

What survives a resize untouched: the request queue, the ledger,
request indices, the chaos step counter, the host KV tier's entries
(stored in the one-device layout: serving/kv_tier.py) and every
accumulated stat. What is rebuilt: the slice (`parallel/mesh.
serving_mesh`), the param placement (`engine._shard_params`: int8
weights move as they are, never requantized), the KV banks (dense bank
or page pool + allocator + table), the prefix pool and radix tree, the
drafter, the adapter bank (its id -> slot map kept) and the slot
mirrors.
"""

import dataclasses
import logging
import time

from dlrover_tpu_torch._device import local_devices
from dlrover_tpu_torch.parallel.mesh import largest_serving_tp, serving_mesh

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ResizeReport:
    """What one live resize did."""

    old_tp: int
    new_tp: int
    replayed: int        # live requests preempted for replay
    downtime_ms: float   # quiesce -> serving again
    direction: str       # "shrink" | "grow" | "noop"


def resize(engine, n_chips: int) -> ResizeReport:
    """Re-form `engine`'s slice live at the largest valid tp <=
    `n_chips`, never past the constructed tp, preempting every live
    request for replay. A reported no-op at the current tp. The caller
    holds whatever serializes engine access (the scheduler's lock)."""
    if n_chips < 1:
        raise ValueError(f"resize needs n_chips >= 1, got {n_chips}")
    t0 = time.perf_counter()
    cfg = engine.cfg
    n_kv = getattr(cfg, "n_kv_heads", None) or cfg.n_heads
    devices = local_devices(engine.device)
    new_tp = largest_serving_tp(n_chips, n_kv_heads=n_kv,
                                n_devices=len(devices))
    # never grow past the constructed slice: those are the only chips
    # the replica owns
    new_tp = min(new_tp, engine._full_tp)
    old_tp = engine.mesh_tp
    if new_tp == old_tp:
        return ResizeReport(old_tp, new_tp, 0, 0.0, "noop")
    direction = "shrink" if new_tp < old_tp else "grow"
    logger.info("elastic resize: tp=%d -> tp=%d (%d chips surviving)",
                old_tp, new_tp, n_chips)

    # 1. quiesce: abandon the dispatched-but-unharvested step; the
    # ledger then reflects the last harvested dispatch and replay
    # regenerates what the abandoned one would have emitted
    engine.drain_inflight()

    # 2. every live request back to the queue front by replay, in
    # reverse slot order: _preempt_slot appendlefts, so the queue front
    # ends in ascending slot order
    replayed = 0
    for slot in range(engine.n_slots - 1, -1, -1):
        if engine.slot_req[slot] is not None and not engine.done[slot]:
            engine._preempt_slot(slot)
            replayed += 1

    # 3. re-form the slice through the one factory; tp 1 drops the mesh
    # (the one-device engine, as a tp=1 construction)
    engine.mesh = (serving_mesh(new_tp, devices=devices, n_kv_heads=n_kv)
                   if new_tp > 1 else None)
    engine.mesh_tp = new_tp

    # 4. re-place the served params (int8 q8 / s8 keep their bits)
    engine.params = engine._shard_params(engine.params)

    # 5. fresh KV state at the new tp: banks, allocator, tables, prefix
    # pool and tree; the drafter; the adapter bank under the new
    # placement, every resident adapter re-uploaded into its slot
    engine._new_kv_state()
    engine._make_spec()
    if engine._adapter_cache is not None:
        engine._adapter_cache.rebuild(mesh=engine.mesh)

    # 6. the slot mirrors of a fresh engine (every slot was freed)
    engine.tok[:] = engine.pad_id
    engine.pos[:] = 0
    engine.limit[:] = 0
    engine.done[:] = True
    engine.adapt[:] = 0
    engine._inflight = None

    downtime_ms = (time.perf_counter() - t0) * 1e3
    engine._elastic_resize[direction] += 1
    engine._elastic_downtime_ms += downtime_ms
    engine._elastic_replayed += replayed
    return ResizeReport(old_tp, new_tp, replayed, downtime_ms, direction)
