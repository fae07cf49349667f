"""Network/interconnect topology model for rank placement.

Reference parity: dlrover/python/master/elastic_training/net_topology.py
(`NodeTopologyMeta`, topology querier/sorter stubs) — the reference keeps
a per-node topology record so future placement can localize traffic.

TPU spin: topology is not a stub here — rank order *matters* on TPU.
Collectives ride ICI only between neighbors on the same slice torus;
cross-slice traffic falls onto DCN. So the sorter orders hosts
(slice_id, then a snake walk over torus coords) to keep mesh-adjacent
ranks ICI-adjacent, and the querier answers "are these two hosts on the
same slice" for the rendezvous manager's group assignment.

The port's copy of dlrover_tpu/master/net_topology.py (host Python, no
torch); it imports nothing of the JAX package.
"""

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class NodeTopologyMeta:
    node_id: int = 0
    node_rank: int = -1
    process_num: int = 1
    hostname: str = ""
    slice_id: int = 0
    # position of the host's chips inside the slice torus (x, y, z);
    # (-1,..) = unknown → falls back to node_id order.
    coords: Tuple[int, int, int] = (-1, -1, -1)
    bandwidth_gbps: float = 0.0


def _snake_key(meta: NodeTopologyMeta) -> Tuple:
    """Boustrophedon walk over the torus: consecutive ranks are physical
    neighbors, so ring collectives (ppermute pipelines, ring attention)
    never hop more than one ICI link per step."""
    x, y, z = meta.coords
    if x < 0:
        return (meta.slice_id, 0, 0, 0, meta.node_id)
    ys = y if x % 2 == 0 else -y
    zs = z if (x + y) % 2 == 0 else -z
    return (meta.slice_id, x, ys, zs, meta.node_id)


class NetworkTopology:
    """Master-resident topology registry + placement queries.

    Served concurrently by the master's RPC threads — all access
    goes through a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._nodes: Dict[int, NodeTopologyMeta] = {}

    def report(self, meta: NodeTopologyMeta):
        with self._lock:
            self._nodes[meta.node_id] = meta

    def get(self, node_id: int) -> Optional[NodeTopologyMeta]:
        with self._lock:
            return self._nodes.get(node_id)

    def sorted_node_ids(self) -> List[int]:
        """Rank order for rendezvous: slice-major snake over the torus."""
        with self._lock:
            metas = list(self._nodes.values())
        return [m.node_id for m in sorted(metas, key=_snake_key)]

    def same_slice(self, a: int, b: int) -> bool:
        with self._lock:
            ma, mb = self._nodes.get(a), self._nodes.get(b)
        return (
            ma is not None
            and mb is not None
            and ma.slice_id == mb.slice_id
        )

    def slices(self) -> Dict[int, List[int]]:
        with self._lock:
            metas = list(self._nodes.values())
        out: Dict[int, List[int]] = {}
        for m in sorted(metas, key=_snake_key):
            out.setdefault(m.slice_id, []).append(m.node_id)
        return out

    def dcn_cut_pairs(self, rank_order: List[int]) -> int:
        """Count adjacent rank pairs that cross slices (i.e. pay DCN
        latency in a ring). The snake order minimizes this to
        (#slices - 1) for fully-known coords."""
        cuts = 0
        for a, b in zip(rank_order, rank_order[1:]):
            if not self.same_slice(a, b):
                cuts += 1
        return cuts
