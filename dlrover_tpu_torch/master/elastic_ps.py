"""Elastic parameter-server membership + cluster versioning.

Reference parity: dlrover/python/master/elastic_training/elastic_ps.py:18
(`ElasticPsService`) — the master tracks which PS nodes are alive and a
monotonically increasing *cluster version* so every participant can agree
on a membership epoch; TF failover rebuilds sessions when the global
version moves past a worker's local version
(trainer/tensorflow/failover/tensorflow_failover.py:33).

TPU spin: dense state is SPMD over the mesh, but sparse embedding shards
(dlrover_tpu/embedding KvEmbedding) live on designated *hosts*; when an
embedding-shard host set changes, the master bumps the global version and
sparse trainers re-resolve their shard map — same protocol, new payload.

The port's copy of dlrover_tpu/master/elastic_ps.py (host Python, no
torch); it imports nothing of the JAX package.
"""

import threading
import time
from typing import Dict, List


class VersionType:
    GLOBAL = "global"
    LOCAL = "local"
    RESTORED = "restored"


class ElasticPsService:
    """Alive-PS set + cluster version bookkeeping (master-resident)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ps_addrs: Dict[int, str] = {}  # ps node_id -> host:port
        self._global_version = 0
        # per-node local versions: {node_type: {node_id: version}}
        self._local_versions: Dict[str, Dict[int, int]] = {}
        self._restored_versions: Dict[str, Dict[int, int]] = {}
        self._updated_at = 0.0

    # ---- membership ------------------------------------------------------

    def register_ps(self, node_id: int, addr: str) -> int:
        """Add/refresh an alive PS; returns the current global version."""
        with self._lock:
            if self._ps_addrs.get(node_id) != addr:
                self._ps_addrs[node_id] = addr
                self._bump_locked()
            return self._global_version

    def deregister_ps(self, node_id: int) -> int:
        with self._lock:
            if self._ps_addrs.pop(node_id, None) is not None:
                self._bump_locked()
            return self._global_version

    def alive_ps(self) -> List[str]:
        """Addresses ordered by node id — the TF_CONFIG ps list order."""
        with self._lock:
            return [self._ps_addrs[i] for i in sorted(self._ps_addrs)]

    # ---- versions --------------------------------------------------------

    def _bump_locked(self):
        self._global_version += 1
        self._updated_at = time.time()

    def inc_global_version(self) -> int:
        with self._lock:
            self._bump_locked()
            return self._global_version

    def get_version(
        self, version_type: str, node_type: str = "", node_id: int = 0
    ) -> int:
        with self._lock:
            if version_type == VersionType.GLOBAL:
                return self._global_version
            if version_type == VersionType.LOCAL:
                return self._local_versions.get(node_type, {}).get(node_id, 0)
            # never-reported RESTORED defaults to -1 so it is
            # distinguishable from "restored at version 0" (reference
            # ElasticPsService failover semantics, elastic_ps.py:18)
            return self._restored_versions.get(node_type, {}).get(node_id, -1)

    def update_version(
        self,
        version_type: str,
        version: int,
        node_type: str = "",
        node_id: int = 0,
    ):
        with self._lock:
            if version_type == VersionType.GLOBAL:
                self._global_version = max(self._global_version, version)
                self._updated_at = time.time()
                return
            table = (
                self._local_versions
                if version_type == VersionType.LOCAL
                else self._restored_versions
            )
            table.setdefault(node_type, {})[node_id] = version

    def stale_workers(self, node_type: str = "worker") -> List[int]:
        """Workers whose local version lags the global one — these must
        rebuild their sessions/shard maps (the failover trigger)."""
        with self._lock:
            locals_ = self._local_versions.get(node_type, {})
            return sorted(
                nid
                for nid, v in locals_.items()
                if v < self._global_version
            )
