"""Node model for the control plane.

Reference parity: dlrover/python/common/node.py (`Node`, `NodeResource`,
`NodeGroupResource`). A node is one TPU host (a TPU-VM worker): it owns
`chips` local accelerator chips and one agent process.

The port's copy of dlrover_tpu/common/node.py (host Python, no torch);
it imports nothing of the JAX package.
"""

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from dlrover_tpu_torch.common.constants import NodeExitReason, NodeStatus


@dataclass
class NodeResource:
    """Resources of one host. `chips` generalizes the reference's `gpu_num`."""

    cpu: float = 0.0
    memory_mb: int = 0
    chips: int = 0
    chip_type: str = ""

    @classmethod
    def resource_str_to_node_resource(cls, resource: str) -> "NodeResource":
        """Parse 'cpu=4,memory=8192Mi,chips=4'."""
        res = cls()
        if not resource:
            return res
        for kv in resource.split(","):
            if "=" not in kv:
                continue
            k, v = kv.split("=", 1)
            k = k.strip().lower()
            v = v.strip()
            if k == "cpu":
                res.cpu = float(v)
            elif k == "memory":
                res.memory_mb = int(v.lower().replace("mi", ""))
            elif k == "chips":
                res.chips = int(v)
        return res


@dataclass
class NodeGroupResource:
    """Resource template for a node group (e.g. all workers)."""

    count: int = 0
    node_resource: NodeResource = field(default_factory=NodeResource)


class Node:
    """Control-plane view of one host in the job."""

    def __init__(
        self,
        node_type: str,
        node_id: int,
        rank_index: Optional[int] = None,
        name: str = "",
        status: str = NodeStatus.INITIAL,
        config_resource: Optional[NodeResource] = None,
        max_relaunch_count: int = 3,
        critical: bool = False,
    ):
        self.type = node_type
        self.id = node_id
        self.rank_index = rank_index if rank_index is not None else node_id
        self.name = name or f"{node_type}-{node_id}"
        self.status = status
        self.config_resource = config_resource or NodeResource()
        self.used_resource = NodeResource()
        self.max_relaunch_count = max_relaunch_count
        self.relaunch_count = 0
        self.critical = critical
        self.is_released = False
        self.relaunchable = True
        # set once a replacement node has been launched for this one:
        # later failure reports for the same (retired) node are stale
        self.relaunched = False
        self.exit_reason = ""
        self.host_addr = ""
        self.create_time: Optional[float] = None
        self.start_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.heartbeat_time: float = 0.0
        self.start_hang_time: float = 0.0
        self.reported_status: str = NodeStatus.INITIAL
        self.paral_config: Dict = {}

    def update_status(self, status: str):
        if status == self.status:
            return False
        self.status = status
        now = time.time()
        if status == NodeStatus.RUNNING and self.start_time is None:
            self.start_time = now
        elif NodeStatus.is_terminal(status):
            self.finish_time = now
        return True

    def inc_relaunch_count(self):
        self.relaunch_count += 1

    def exceeded_max_relaunch(self) -> bool:
        return self.relaunch_count >= self.max_relaunch_count

    def is_unrecoverable_failure(self) -> bool:
        if not self.relaunchable:
            return True
        if self.exceeded_max_relaunch():
            return True
        if self.exit_reason == NodeExitReason.FATAL_ERROR:
            return True
        return False

    def update_from_event(self, status: str, exit_reason: str = ""):
        changed = self.update_status(status)
        if exit_reason:
            self.exit_reason = exit_reason
        return changed

    def get_relaunch_node_id(self, next_id: int) -> "Node":
        """Build the replacement node after a failure."""
        new_node = Node(
            node_type=self.type,
            node_id=next_id,
            rank_index=self.rank_index,
            config_resource=self.config_resource,
            max_relaunch_count=self.max_relaunch_count,
            critical=self.critical,
        )
        new_node.relaunch_count = self.relaunch_count + 1
        return new_node

    def __repr__(self):
        return (
            f"Node({self.type}-{self.id} rank={self.rank_index} "
            f"status={self.status})"
        )
