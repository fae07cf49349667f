"""Node state machine + composable node-event callbacks.

Reference parity: dlrover/python/master/node/status_flow.py:136
(`NodeStateFlow` table + `get_node_state_flow`) and
master/node/event_callback.py:42 (`NodeEventCallback`,
`TaskRescheduleCallback` :111, `TFPSNodeHandlingCallback`,
`AllReduceNodeHandlingCallback`).

TPU re-design: the transition table is a dict keyed by (from, to) — the
master validates every externally-reported status change against it and
rejects illegal jumps (e.g. a stale RUNNING report arriving after a node
was DELETED). Callbacks are a registry the node manager fires outside
its lock; the SPMD-specific callback invalidates the rendezvous world
when a member dies — the event that drives every survivor back into
re-rendezvous (the allreduce-handling analogue).

The port's copy of dlrover_tpu/master/status_flow.py (host Python, no
torch); it imports nothing of the JAX package.
"""

from dataclasses import dataclass
from typing import List, Optional

from dlrover_tpu_torch.common.constants import NodeStatus, NodeType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import Node


class IllegalTransitionError(ValueError):
    """Raised (strict mode) for a status jump the table does not allow."""


@dataclass(frozen=True)
class Transition:
    frm: str
    to: str
    # a transition that implies the node should be relaunched
    should_relaunch: bool = False


_S = NodeStatus

_TRANSITIONS = [
    # scheduling
    Transition(_S.INITIAL, _S.PENDING),
    Transition(_S.INITIAL, _S.RUNNING),
    Transition(_S.INITIAL, _S.FAILED, should_relaunch=True),
    Transition(_S.INITIAL, _S.DELETED, should_relaunch=True),
    Transition(_S.PENDING, _S.RUNNING),
    Transition(_S.PENDING, _S.SUCCEEDED),
    Transition(_S.PENDING, _S.FAILED, should_relaunch=True),
    Transition(_S.PENDING, _S.DELETED, should_relaunch=True),
    # running lifecycle
    Transition(_S.RUNNING, _S.SUCCEEDED),
    Transition(_S.RUNNING, _S.FAILED, should_relaunch=True),
    Transition(_S.RUNNING, _S.DELETED, should_relaunch=True),
    # terminal cleanup — no relaunch for nodes that already concluded
    Transition(_S.SUCCEEDED, _S.DELETED),
    Transition(_S.FAILED, _S.DELETED),
    # relaunch path: a failed node is re-queued as pending
    Transition(_S.FAILED, _S.PENDING),
]

ALLOWED = {(t.frm, t.to): t for t in _TRANSITIONS}


def resolve_transition(
    from_status: str, to_status: str
) -> Optional[Transition]:
    """The Transition for (from, to); same-status is a no-op (None);
    unknown from-status is treated as INITIAL (a node we never saw)."""
    if from_status == to_status:
        return None
    if from_status not in {
        _S.INITIAL,
        _S.PENDING,
        _S.RUNNING,
        _S.SUCCEEDED,
        _S.FAILED,
        _S.DELETED,
    }:
        from_status = _S.INITIAL
    t = ALLOWED.get((from_status, to_status))
    if t is None:
        raise IllegalTransitionError(
            f"illegal node status transition {from_status!r} -> "
            f"{to_status!r}"
        )
    return t


# ---------------------------------------------------------------------------
# event callbacks
# ---------------------------------------------------------------------------


class NodeEventCallback:
    """Observer of node lifecycle events (reference event_callback.py:42).
    Subclass and override what you need; exceptions are contained so one
    broken observer cannot take the master down."""

    def on_node_started(self, node: Node):
        pass

    def on_node_succeeded(self, node: Node):
        pass

    def on_node_failed(self, node: Node):
        pass

    def on_node_deleted(self, node: Node):
        pass


class CallbackRegistry:
    """Fires every registered callback for a status transition."""

    _EVENTS = {
        NodeStatus.RUNNING: "on_node_started",
        NodeStatus.SUCCEEDED: "on_node_succeeded",
        NodeStatus.FAILED: "on_node_failed",
        NodeStatus.DELETED: "on_node_deleted",
    }

    def __init__(self):
        self._callbacks: List[NodeEventCallback] = []

    def register(self, cb: NodeEventCallback):
        self._callbacks.append(cb)

    def fire(self, node: Node, new_status: str):
        method = self._EVENTS.get(new_status)
        if method is None:
            return
        for cb in self._callbacks:
            try:
                getattr(cb, method)(node)
            except Exception:  # noqa: BLE001 — observers must not kill us
                logger.exception(
                    "%s.%s failed for node %s-%s",
                    type(cb).__name__,
                    method,
                    node.type,
                    node.id,
                )


# ---------------------------------------------------------------------------
# stock callbacks
# ---------------------------------------------------------------------------


class TaskRescheduleCallback(NodeEventCallback):
    """Re-queue the dynamic data shards a dead worker was holding
    (reference TaskRescheduleCallback event_callback.py:111)."""

    def __init__(self, task_manager):
        self._task_manager = task_manager

    def on_node_failed(self, node: Node):
        self._task_manager.recover_tasks(node.id)

    def on_node_deleted(self, node: Node):
        if node.type == NodeType.WORKER:
            self._task_manager.recover_tasks(node.id)


class SpmdWorldCallback(NodeEventCallback):
    """SPMD membership: a dead/preempted member invalidates the current
    rendezvous world so every survivor re-rendezvouses (the allreduce
    handling of the reference, re-cast for single-program JAX where a
    peer's loss stalls *everyone*). A SUCCEEDED node leaves the world
    intact — peers all reach the final step together."""

    def __init__(self, rdzv_managers: dict):
        self._rdzv_managers = rdzv_managers

    def on_node_succeeded(self, node: Node):
        for rdzv in self._rdzv_managers.values():
            rdzv.remove_node(node.id, invalidate=False)

    def on_node_failed(self, node: Node):
        for rdzv in self._rdzv_managers.values():
            rdzv.remove_node(node.id)

    def on_node_deleted(self, node: Node):
        self.on_node_failed(node)


class SparseClusterCallback(NodeEventCallback):
    """Embedding-shard host failover: bump the sparse cluster version on
    a shard-host death so trainers rebuild their shard maps (reference
    TFPSNodeHandlingCallback — PS relaunch bumps the cluster version)."""

    def __init__(self, elastic_ps, shard_host_type: str = "ps"):
        self._elastic_ps = elastic_ps
        self._shard_host_type = shard_host_type

    def _bump(self, node: Node):
        if node.type == self._shard_host_type:
            self._elastic_ps.deregister_ps(node.id)

    def on_node_failed(self, node: Node):
        self._bump(node)

    def on_node_deleted(self, node: Node):
        self._bump(node)


class SpeedMonitorCallback(NodeEventCallback):
    """Keep the throughput monitor's running-worker set in sync."""

    def __init__(self, speed_monitor):
        self._speed_monitor = speed_monitor

    def on_node_started(self, node: Node):
        self._speed_monitor.add_running_worker(node.id)

    def on_node_succeeded(self, node: Node):
        self._speed_monitor.remove_running_worker(node.id)

    def on_node_failed(self, node: Node):
        self._speed_monitor.remove_running_worker(node.id)

    def on_node_deleted(self, node: Node):
        self._speed_monitor.remove_running_worker(node.id)
