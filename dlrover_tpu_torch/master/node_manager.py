"""Job/node manager: track node status, heartbeats, relaunch policy.

Reference parity: dlrover/python/master/node/job_manager.py:31 (`JobManager`
ABC), dist_job_manager.py:80 (`DistributedJobManager` — `_monitor_nodes`
:322, `_monitor_node_heart_beat` :346, `_should_relaunch` :593,
`_relaunch_node` :637) and local_job_manager.py. The scheduler that
materializes relaunches is pluggable (local subprocess scaler in-tree;
k8s scaler in dlrover_tpu.master.scaler).

The port's copy of dlrover_tpu/master/node_manager.py (host Python, no
torch); it imports nothing of the JAX package.
"""

import threading
import time
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.constants import (
    JobConstant,
    NodeExitReason,
    NodeStatus,
    NodeType,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.master.status_flow import (
    CallbackRegistry,
    IllegalTransitionError,
    NodeEventCallback,
    resolve_transition,
)


class NodeEvent:
    def __init__(self, event_type: str, node: Node):
        self.event_type = event_type
        self.node = node


class JobNodeManager:
    """Bookkeeping for every node in the job + failure handling policy.

    Single manager covering the reference's per-role managers
    (training_node.py TrainingNodeManager, worker.py WorkerManager, ps.py
    ParameterServerManager) — roles are a field on Node, and the policy
    methods take the role into account.
    """

    def __init__(
        self,
        heartbeat_timeout: float = 3 * JobConstant.HEARTBEAT_INTERVAL_SECS,
        max_relaunch_count: int = 3,
    ):
        self._lock = threading.Lock()
        self._nodes: Dict[str, Dict[int, Node]] = {}
        self._heartbeats: Dict[str, Dict[int, float]] = {}
        self.heartbeat_timeout = heartbeat_timeout
        self.max_relaunch_count = max_relaunch_count
        # hooks: called outside the lock
        self.on_node_failed: Optional[Callable[[Node], None]] = None
        self.on_relaunch: Optional[Callable[[Node], None]] = None
        self._next_ids: Dict[str, int] = {}
        # composable observers (reference NodeEventCallback framework)
        self.callbacks = CallbackRegistry()

    def register_callback(self, cb: NodeEventCallback):
        self.callbacks.register(cb)

    # ---- membership ------------------------------------------------------

    def add_node(self, node: Node):
        with self._lock:
            self._nodes.setdefault(node.type, {})[node.id] = node
            nxt = self._next_ids.get(node.type, 0)
            self._next_ids[node.type] = max(nxt, node.id + 1)

    def get_node(self, node_type: str, node_id: int) -> Optional[Node]:
        return self._nodes.get(node_type, {}).get(node_id)

    def get_nodes(self, node_type: str = None) -> List[Node]:
        with self._lock:
            if node_type:
                return list(self._nodes.get(node_type, {}).values())
            return [
                n for group in self._nodes.values() for n in group.values()
            ]

    def running_nodes(self, node_type: str = None) -> List[Node]:
        return [
            n
            for n in self.get_nodes(node_type)
            if n.status == NodeStatus.RUNNING
        ]

    def next_node_id(self, node_type: str) -> int:
        with self._lock:
            nxt = self._next_ids.get(node_type, 0)
            self._next_ids[node_type] = nxt + 1
            return nxt

    def pool(self, node_type: str):
        """Role-specific policy pool (WorkerPool/PSPool/ChiefPool/
        EvaluatorPool) of the JAX package's `master/node/pools.py`,
        which only its DistributedJobMaster's relaunch path reaches;
        not ported yet (ROADMAP queue 1, item 13)."""
        raise NotImplementedError(
            "the role policy pools (master/node/pools.py) are not ported "
            "yet (ROADMAP queue 1, item 13)"
        )

    # ---- status / heartbeat ingestion -----------------------------------

    def update_node_status(
        self,
        node_type: str,
        node_id: int,
        status: str,
        exit_reason="",
        strict: bool = False,
    ) -> Optional[Node]:
        """Apply an externally-reported status change, validated against
        the allowed-transition table (reference NodeStateFlow
        status_flow.py:136). Illegal jumps — e.g. a stale RUNNING report
        racing a DELETED — are rejected: logged and ignored, or raised
        when `strict`."""
        node = self.get_node(node_type, node_id)
        if node is None:
            node = Node(node_type, node_id)
            self.add_node(node)
        old = node.status
        try:
            transition = resolve_transition(old, status)
        except IllegalTransitionError:
            if strict:
                raise
            logger.warning(
                "ignored illegal status transition %s -> %s for "
                "node %s-%d (%s)",
                old,
                status,
                node_type,
                node_id,
                exit_reason,
            )
            return node
        if transition is None:  # same-status no-op
            return node
        node.update_from_event(status, exit_reason)
        logger.info(
            "node %s-%d: %s -> %s (%s)",
            node_type,
            node_id,
            old,
            status,
            exit_reason,
        )
        self.callbacks.fire(node, status)
        if status == NodeStatus.FAILED:
            if node.relaunched:
                # a replacement was already launched for this node —
                # apply the status (it may still converge to DELETED)
                # but never trigger a second relaunch from a
                # late-arriving duplicate failure report
                logger.info(
                    "suppressing relaunch for already-relaunched node "
                    "%s-%d",
                    node_type,
                    node_id,
                )
            else:
                self._handle_failure(node)
        return node

    def heartbeats(self):
        """Snapshot of (node_type, node_id, last_ts) for every node that
        has ever heartbeated — diagnosis/monitoring consumers."""
        with self._lock:
            return [
                (ntype, nid, ts)
                for ntype, beats in self._heartbeats.items()
                for nid, ts in beats.items()
            ]

    def report_heartbeat(self, node_type: str, node_id: int, ts: float):
        with self._lock:
            self._heartbeats.setdefault(node_type, {})[node_id] = (
                ts or time.time()
            )
        node = self.get_node(node_type, node_id)
        if node and node.status in (
            NodeStatus.INITIAL,
            NodeStatus.PENDING,
        ):
            self.update_node_status(node_type, node_id, NodeStatus.RUNNING)

    # ---- failure / relaunch policy --------------------------------------

    def _should_relaunch(self, node: Node) -> bool:
        """Reference `_should_relaunch` dist_job_manager.py:593: fatal
        errors never relaunch; exceeding max restarts fails the job;
        otherwise relaunch (OOM gets more memory; hardware error moves
        host — resource hints carried on the Node)."""
        if node.exit_reason == NodeExitReason.FATAL_ERROR:
            return False
        if node.relaunch_count >= self.max_relaunch_count:
            return False
        if not node.relaunchable:
            return False
        return True

    def _handle_failure(self, node: Node):
        if self._should_relaunch(node):
            node.inc_relaunch_count()
            node.update_status(NodeStatus.PENDING)
            logger.info(
                "relaunching node %s-%d (attempt %d, reason %s)",
                node.type,
                node.id,
                node.relaunch_count,
                node.exit_reason,
            )
            if self.on_relaunch:
                # platform model: a NEW node replaces this one; mark it
                # so late duplicate failure reports are dropped (the
                # agent model reuses the id and keeps relaunched False)
                node.relaunched = True
                self.on_relaunch(node)
        else:
            logger.warning(
                "node %s-%d failed unrecoverably (%s)",
                node.type,
                node.id,
                node.exit_reason,
            )
            if self.on_node_failed:
                self.on_node_failed(node)

    def find_dead_nodes(self) -> List[Node]:
        """Heartbeat scan (reference `_monitor_node_heart_beat`
        dist_job_manager.py:346): running nodes silent past the timeout."""
        now = time.time()
        dead = []
        for node in self.running_nodes():
            last = self._heartbeats.get(node.type, {}).get(node.id)
            if last is None:
                continue
            if now - last > self.heartbeat_timeout:
                dead.append(node)
        return dead

    def process_dead_nodes(self) -> List[Node]:
        dead = self.find_dead_nodes()
        for node in dead:
            logger.warning(
                "node %s-%d heartbeat timeout -> failed", node.type, node.id
            )
            self.update_node_status(
                node.type, node.id, NodeStatus.FAILED, NodeExitReason.KILLED
            )
        return dead

    # ---- job-level state -------------------------------------------------

    def all_workers_finished(self) -> bool:
        """DELETED workers (preempted / scaled away) don't block job
        success — only live membership must succeed."""
        workers = [
            n
            for n in self.get_nodes(NodeType.WORKER)
            if n.status != NodeStatus.DELETED
        ]
        return bool(workers) and all(
            n.status == NodeStatus.SUCCEEDED for n in workers
        )

    def any_unrecoverable_failure(self) -> bool:
        # a relaunched node's terminal FAILED is history, not a live
        # failure — its replacement carries the job now
        return any(
            n.status == NodeStatus.FAILED
            and not n.relaunched
            and not self._should_relaunch(n)
            for n in self.get_nodes()
        )

    def all_running_nodes_hanged(self, hang_timeout: float) -> bool:
        """Hang = every running node's heartbeat is stale-ish but within
        the dead window (reference all_running_node_hanged
        dist_job_manager.py:839 uses resource idleness; step-based hang
        detection lives in the diagnosis module)."""
        running = self.running_nodes()
        if not running:
            return False
        now = time.time()
        for node in running:
            last = self._heartbeats.get(node.type, {}).get(node.id, 0)
            if now - last < hang_timeout:
                return False
        return True
