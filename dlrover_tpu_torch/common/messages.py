"""Typed control-plane messages carried over the 2-RPC wire.

Reference parity: dlrover/python/common/grpc.py:155-503 — the reference
pickles ~60 dataclasses over a single gRPC service with two RPCs
(`report` and `get`). We keep that proven design: every message below is a
plain dataclass; `Message` is the envelope. Serialization in comm.py.

The port's copy of dlrover_tpu/common/messages.py (host Python, no
torch); it imports nothing of the JAX package.
"""

import socket
from contextlib import closing
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


def find_free_port(port: int = 0) -> int:
    with closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
        s.bind(("", port))
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        return s.getsockname()[1]


def addr_connected(addr: str, timeout: float = 3.0) -> bool:
    if not addr or ":" not in addr:
        return False
    host, port = addr.rsplit(":", 1)
    try:
        with closing(socket.create_connection((host, int(port)), timeout)):
            return True
    except (OSError, ValueError):
        return False


class BaseRequest:
    """Marker base for messages sent via `report`/`get`."""


# ---------------------------------------------------------------------------
# generic envelope
# ---------------------------------------------------------------------------


@dataclass
class Message(BaseRequest):
    node_id: int = -1
    node_type: str = ""
    data: bytes = b""


@dataclass
class Response:
    success: bool = True
    reason: str = ""


# ---------------------------------------------------------------------------
# node lifecycle / heartbeats
# ---------------------------------------------------------------------------


@dataclass
class NodeMeta(BaseRequest):
    type: str = ""
    id: int = 0
    rank: int = -1
    addr: str = ""
    chips: int = 0
    memory_mb: int = 0
    cpu: float = 0.0


@dataclass
class NodeStatusReport(BaseRequest):
    node_id: int = 0
    node_type: str = ""
    status: str = ""
    exit_reason: str = ""
    restart_count: int = 0


@dataclass
class HeartBeat(BaseRequest):
    node_id: int = 0
    node_type: str = ""
    timestamp: float = 0.0


@dataclass
class HeartbeatResponse:
    """Master can piggyback actions (e.g. 'restart', 'stop') on heartbeats;
    reference: DiagnosisAction on heartbeat replies."""

    action: str = ""
    action_args: Dict = field(default_factory=dict)
    # identity of the serving master process: a changed value between
    # heartbeats means the master restarted (empty in-memory state) and
    # the agent must re-register itself + its state
    master_session: str = ""


@dataclass
class ResourceStats(BaseRequest):
    node_id: int = 0
    node_type: str = ""
    cpu_percent: float = 0.0
    memory_mb: int = 0
    chip_util: float = 0.0
    chip_memory_mb: int = 0


@dataclass
class GlobalStep(BaseRequest):
    node_id: int = 0
    step: int = 0
    timestamp: float = 0.0
    # host-side (python/dispatch) ms per step, EXCLUDING device wait:
    # under SPMD lockstep every node's wall time is identical (the
    # fast ones wait in the collective), so runtime straggler
    # attribution needs this host-local signal (reference compares
    # per-node bench times, rdzv_manager.py:579,607)
    host_compute_ms: float = 0.0


@dataclass
class ModelInfo(BaseRequest):
    node_id: int = 0
    num_params: int = 0
    flops_per_step: float = 0.0
    batch_size_per_host: int = 0
    seq_len: int = 0
    # JSON of utils/program_stats.ProgramStats for the compiled train
    # step (XLA cost/memory analysis — the reference's TF graph profile
    # extractor equivalent); empty when the trainer didn't profile
    program_stats: str = ""


@dataclass
class TrainingExceptionReport(BaseRequest):
    node_id: int = 0
    node_type: str = ""
    level: str = ""
    error_data: str = ""
    restart_count: int = 0


# ---------------------------------------------------------------------------
# rendezvous
# ---------------------------------------------------------------------------


@dataclass
class JoinRendezvous(BaseRequest):
    node_id: int = 0
    node_rank: int = -1
    local_world_size: int = 1
    rdzv_name: str = "training"
    node_addr: str = ""


@dataclass
class JoinRendezvousResponse:
    round: int = 0


@dataclass
class GetCommWorld(BaseRequest):
    node_id: int = 0
    rdzv_name: str = "training"


@dataclass
class CommWorldResponse:
    round: int = 0
    group: int = 0
    # node_rank -> (node_id, local_world_size, node_addr)
    world: Dict[int, Tuple[int, int, str]] = field(default_factory=dict)


@dataclass
class NumNodesWaiting(BaseRequest):
    rdzv_name: str = "training"


@dataclass
class NumNodesWaitingResponse:
    waiting_num: int = 0


@dataclass
class RendezvousStateQuery(BaseRequest):
    rdzv_name: str = "training"


@dataclass
class RendezvousStateResponse:
    """Read-only rendezvous snapshot (no round-completion side effects):
    workers and agents poll it to learn the current world went stale."""

    round: int = 0
    world_size: int = 0
    waiting_num: int = 0


@dataclass
class NetworkCheckResult(BaseRequest):
    node_id: int = 0
    normal: bool = True
    elapsed_time: float = 0.0


@dataclass
class NetworkCheckQuery(BaseRequest):
    node_id: int = 0
    query: str = "fault"  # "fault" | "straggler"


@dataclass
class NetworkCheckQueryResponse:
    nodes: List[int] = field(default_factory=list)
    reason: str = ""


# ---------------------------------------------------------------------------
# KV store / sync barriers
# ---------------------------------------------------------------------------


@dataclass
class KeyValuePair(BaseRequest):
    key: str = ""
    value: bytes = b""


@dataclass
class KeyValueQuery(BaseRequest):
    key: str = ""


@dataclass
class SyncJoin(BaseRequest):
    sync_name: str = ""
    node_id: int = 0
    node_rank: int = 0


@dataclass
class SyncFinish(BaseRequest):
    sync_name: str = ""


@dataclass
class SyncQuery(BaseRequest):
    sync_name: str = ""


@dataclass
class SyncQueryResponse:
    reached: bool = False


# ---------------------------------------------------------------------------
# dynamic data sharding
# ---------------------------------------------------------------------------


@dataclass
class DatasetShardParams(BaseRequest):
    dataset_name: str = ""
    dataset_size: int = 0
    shard_size: int = 0
    num_epochs: int = 1
    shuffle: bool = False
    storage_type: str = "text"
    task_type: str = "train"


@dataclass
class GetDatasetTask(BaseRequest):
    node_id: int = 0
    dataset_name: str = ""


@dataclass
class DatasetTask:
    task_id: int = -1
    shard_start: int = 0
    shard_end: int = 0
    task_type: str = "train"
    epoch: int = 0
    # False when the master does not know the dataset at all — a
    # restarted master with empty state, NOT an exhausted dataset.
    # Clients re-register the dataset + restore their shard checkpoint
    # instead of treating it as end-of-data.
    dataset_known: bool = True

    @property
    def exists(self) -> bool:
        return self.task_id >= 0


@dataclass
class ReportTaskResult(BaseRequest):
    node_id: int = 0
    dataset_name: str = ""
    task_id: int = 0
    success: bool = True


@dataclass
class DatasetEpochQuery(BaseRequest):
    dataset_name: str = ""


@dataclass
class DatasetEpochResponse:
    epoch: int = 0
    finished: bool = False


@dataclass
class ShardCheckpointRequest(BaseRequest):
    dataset_name: str = ""


@dataclass
class ShardCheckpointResponse:
    content: str = ""


@dataclass
class RestoreShardCheckpoint(BaseRequest):
    dataset_name: str = ""
    content: str = ""


# ---------------------------------------------------------------------------
# checkpoint coordination
# ---------------------------------------------------------------------------


@dataclass
class CkptSaveStep(BaseRequest):
    node_id: int = 0
    step: int = 0
    path: str = ""


@dataclass
class CkptLatestStepQuery(BaseRequest):
    path: str = ""


@dataclass
class CkptLatestStepResponse:
    step: int = -1


# ---------------------------------------------------------------------------
# runtime re-config (master -> trainer)
# ---------------------------------------------------------------------------


@dataclass
class ParallelConfigRequest(BaseRequest):
    node_id: int = 0


@dataclass
class ParallelConfig:
    """Master-suggested runtime config; written to a file by the agent for
    the trainer to pick up (reference: common/grpc.py ParallelConfig +
    DataLoaderConfig + elastic_agent ParalConfigTuner)."""

    dataloader_batch_size: int = 0
    dataloader_num_workers: int = 0
    grad_accum_steps: int = 0
    version: int = 0


# ---------------------------------------------------------------------------
# job control
# ---------------------------------------------------------------------------


@dataclass
class JobStageQuery(BaseRequest):
    pass


@dataclass
class JobStageResponse:
    stage: str = ""


@dataclass
class ScaleRequest(BaseRequest):
    node_type: str = "worker"
    count: int = 0


@dataclass
class ElasticRunConfigQuery(BaseRequest):
    pass


@dataclass
class ElasticRunConfigResponse:
    configs: Dict[str, str] = field(default_factory=dict)


@dataclass
class DiagnosisReport(BaseRequest):
    node_id: int = 0
    data_type: str = ""
    content: str = ""
    timestamp: float = 0.0


# ---------------------------------------------------------------------------
# elastic PS (sparse embedding-shard hosts) + topology
# ---------------------------------------------------------------------------


@dataclass
class PsRegister(BaseRequest):
    node_id: int = 0
    addr: str = ""
    alive: bool = True


@dataclass
class PsClusterQuery(BaseRequest):
    pass


@dataclass
class PsClusterResponse:
    version: int = 0
    ps_addrs: List[str] = field(default_factory=list)


@dataclass
class ClusterVersionReport(BaseRequest):
    version_type: str = "local"  # global | local | restored
    version: int = 0
    node_type: str = "worker"
    node_id: int = 0


@dataclass
class ClusterVersionQuery(BaseRequest):
    version_type: str = "global"
    node_type: str = "worker"
    node_id: int = 0


@dataclass
class ClusterVersionResponse:
    version: int = 0


@dataclass
class TopologyReport(BaseRequest):
    """Host interconnect position (slice + torus coords) for placement."""

    node_id: int = 0
    node_rank: int = -1
    process_num: int = 1
    hostname: str = ""
    slice_id: int = 0
    coords: Tuple[int, int, int] = (-1, -1, -1)
    bandwidth_gbps: float = 0.0


@dataclass
class TopologyQuery(BaseRequest):
    pass


@dataclass
class TopologyResponse:
    # node ids in slice-major snake order (ICI-contiguous rank order)
    sorted_node_ids: List[int] = field(default_factory=list)
