"""Live elastic resize of a serving replica — the one-card part of
dlrover_tpu/serving/elastic.py.

The JAX engine survives a chip loss by re-forming its mesh at the
largest tp that the surviving chips and the KV heads allow, preempting
every live request for replay. The port's engine serves `mesh_spec`
tp=1 only: it runs on one card, where the target tp always clamps to
the constructed tp and a resize is the reported no-op JAX's tp=1 engine
returns. The re-forming branch waits for the port's tensor-parallel
serving.
"""

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ResizeReport:
    """What one live resize did."""

    old_tp: int
    new_tp: int
    replayed: int        # live requests preempted for replay
    downtime_ms: float   # quiesce -> serving again
    direction: str       # "shrink" | "grow" | "noop"


def largest_serving_tp(n_chips: int, n_kv_heads: Optional[int] = None) -> int:
    """The biggest t <= n_chips that divides `n_kv_heads` (the KV banks
    shard the head axis); always >= 1."""
    for t in range(max(1, int(n_chips)), 0, -1):
        if n_kv_heads is None or n_kv_heads % t == 0:
            return t
    return 1


def resize(engine, n_chips: int) -> ResizeReport:
    """Re-form `engine` at the largest valid tp <= `n_chips`, never past
    the constructed tp. At the constructed tp it is a no-op, reported."""
    if n_chips < 1:
        raise ValueError(f"resize needs n_chips >= 1, got {n_chips}")
    cfg = engine.cfg
    n_kv = getattr(cfg, "n_kv_heads", None) or cfg.n_heads
    new_tp = min(largest_serving_tp(n_chips, n_kv_heads=n_kv),
                 engine._full_tp)
    old_tp = engine.mesh_tp
    if new_tp == old_tp:
        return ResizeReport(old_tp, new_tp, 0, 0.0, "noop")
    raise NotImplementedError(
        f"resize from tp={old_tp} to tp={new_tp} re-forms a mesh; the "
        "port's engine serves on one card (tp=1)"
    )
