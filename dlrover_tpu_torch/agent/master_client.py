"""Worker/agent → master client: every control-plane RPC in one place.

Reference parity: dlrover/python/elastic_agent/master_client.py:50
(`MasterClient` — join_rendezvous :314, get_comm_world :325,
check_fault_node :330, check_straggler :344, report_heart_beat :233).
Retries with backoff on transient transport failures (the master may be
restarting); singleton per process.

The port's copy of dlrover_tpu/agent/master_client.py: every verb, the
same retry schedule and final ConnectionError, over the port's stdlib
transport (`common/comm.py`), whose `RpcError` takes the place of
`grpc.RpcError`. A port client talks to a port master: the envelopes
carry the port's own message classes.
"""

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.comm import (
    MasterStub,
    ReplyEnvelope,
    RpcError,
)
from dlrover_tpu_torch.common.constants import JobConstant, NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger

CommWorld = Dict[int, Tuple[int, int, str]]


class MasterClient:
    _singleton = None
    _singleton_lock = threading.Lock()

    def __init__(
        self,
        master_addr: str,
        node_id: int = 0,
        node_type: str = "worker",
        timeout: float = JobConstant.MASTER_CLIENT_TIMEOUT_SECS,
        max_retries: int = 5,
    ):
        self._stub = MasterStub(master_addr, timeout)
        self.node_id = node_id
        self.node_type = node_type
        self.max_retries = max_retries

    # ---- plumbing --------------------------------------------------------

    def _call(
        self, kind: str, payload, timeout=None, retries=None
    ) -> ReplyEnvelope:
        fn = self._stub.get if kind == "get" else self._stub.report
        last_err = None
        n = retries if retries is not None else self.max_retries
        for attempt in range(n):
            try:
                reply = fn(
                    payload,
                    node_id=self.node_id,
                    node_type=self.node_type,
                    timeout=timeout,
                )
                return reply
            except RpcError as e:  # master restarting / net blip
                last_err = e
                if attempt + 1 >= n:
                    break  # no retry follows — don't sleep the backoff
                wait = min(2.0 * (attempt + 1), 10.0)
                logger.warning(
                    "master RPC %s(%s) failed (%s); retry in %.1fs",
                    kind,
                    type(payload).__name__,
                    e.code() if hasattr(e, "code") else e,
                    wait,
                )
                time.sleep(wait)
        raise ConnectionError(
            f"master unreachable after {n} tries"
        ) from last_err

    def get(self, payload, timeout=None):
        reply = self._call("get", payload, timeout)
        if not reply.success:
            logger.debug("get(%s) -> %s", type(payload).__name__, reply.reason)
        return reply.payload

    def report(self, payload, timeout=None, retries=None) -> ReplyEnvelope:
        return self._call("report", payload, timeout, retries)

    def close(self):
        self._stub.close()

    # ---- node lifecycle --------------------------------------------------

    def register_node(self, rank: int = -1, addr: str = ""):
        return self.report(
            msg.NodeMeta(
                type=self.node_type, id=self.node_id, rank=rank, addr=addr
            )
        )

    def report_node_status(
        self,
        status: str,
        exit_reason: str = "",
        timeout=None,
        retries=None,
    ):
        # timeout/retries: the SIGTERM leave path reports with a short
        # single attempt — an unreachable master must not burn the
        # eviction grace period ahead of the checkpoint persist
        return self.report(
            msg.NodeStatusReport(
                node_id=self.node_id,
                node_type=self.node_type,
                status=status,
                exit_reason=exit_reason,
            ),
            timeout=timeout,
            retries=retries,
        )

    def report_heart_beat(self) -> msg.HeartbeatResponse:
        reply = self.report(
            msg.HeartBeat(
                node_id=self.node_id,
                node_type=self.node_type,
                timestamp=time.time(),
            )
        )
        return reply.payload or msg.HeartbeatResponse()

    def report_global_step(
        self, step: int, host_compute_ms: float = 0.0
    ):
        return self.report(
            msg.GlobalStep(
                node_id=self.node_id,
                step=step,
                timestamp=time.time(),
                host_compute_ms=host_compute_ms,
            )
        )

    def report_resource_stats(
        self, cpu_percent: float, memory_mb: int, chip_util: float = 0.0
    ):
        return self.report(
            msg.ResourceStats(
                node_id=self.node_id,
                node_type=self.node_type,
                cpu_percent=cpu_percent,
                memory_mb=memory_mb,
                chip_util=chip_util,
            )
        )

    def report_failure(
        self, error_data: str, level: str, restart_count: int = 0
    ):
        return self.report(
            msg.TrainingExceptionReport(
                node_id=self.node_id,
                node_type=self.node_type,
                level=level,
                error_data=error_data,
                restart_count=restart_count,
            )
        )

    # ---- rendezvous ------------------------------------------------------

    def join_rendezvous(
        self,
        local_world_size: int = 1,
        node_rank: int = -1,
        rdzv_name: str = "training",
        node_addr: str = "",
    ) -> int:
        reply = self.report(
            msg.JoinRendezvous(
                node_id=self.node_id,
                node_rank=node_rank,
                local_world_size=local_world_size,
                rdzv_name=rdzv_name,
                node_addr=node_addr,
            )
        )
        payload = reply.payload
        return payload.round if payload else 0

    def get_comm_world(
        self, rdzv_name: str = "training"
    ) -> Tuple[int, int, CommWorld]:
        resp = self.get(
            msg.GetCommWorld(node_id=self.node_id, rdzv_name=rdzv_name)
        )
        if resp is None:
            return 0, 0, {}
        return resp.round, resp.group, resp.world

    def num_nodes_waiting(self, rdzv_name: str = "training") -> int:
        resp = self.get(msg.NumNodesWaiting(rdzv_name=rdzv_name))
        return resp.waiting_num if resp else 0

    def rdzv_state(
        self, rdzv_name: str = "training"
    ) -> msg.RendezvousStateResponse:
        """Read-only rendezvous snapshot (round/world_size/waiting) —
        the staleness signal workers and agents poll."""
        resp = self.get(msg.RendezvousStateQuery(rdzv_name=rdzv_name))
        return resp if resp else msg.RendezvousStateResponse()

    def report_network_check(self, normal: bool, elapsed: float):
        return self.report(
            msg.NetworkCheckResult(
                node_id=self.node_id, normal=normal, elapsed_time=elapsed
            )
        )

    def check_fault_nodes(self) -> List[int]:
        resp = self.get(
            msg.NetworkCheckQuery(node_id=self.node_id, query="fault")
        )
        return resp.nodes if resp else []

    def check_stragglers(self) -> List[int]:
        resp = self.get(
            msg.NetworkCheckQuery(node_id=self.node_id, query="straggler")
        )
        return resp.nodes if resp else []

    # ---- KV store / sync -------------------------------------------------

    def kv_set(self, key: str, value: bytes):
        return self.report(msg.KeyValuePair(key=key, value=value))

    def kv_get(self, key: str) -> bytes:
        resp = self.get(msg.KeyValueQuery(key=key))
        return resp.value if resp else b""

    def sync_join(self, sync_name: str, node_rank: int = 0) -> bool:
        reply = self.report(
            msg.SyncJoin(
                sync_name=sync_name,
                node_id=self.node_id,
                node_rank=node_rank,
            )
        )
        return bool(reply.payload and reply.payload.reached)

    def sync_finished(self, sync_name: str) -> bool:
        resp = self.get(msg.SyncQuery(sync_name=sync_name))
        return resp.reached if resp else False

    # ---- data sharding ---------------------------------------------------

    def report_dataset_params(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        storage_type: str = "table",
    ):
        return self.report(
            msg.DatasetShardParams(
                dataset_name=dataset_name,
                dataset_size=dataset_size,
                shard_size=shard_size,
                num_epochs=num_epochs,
                shuffle=shuffle,
                storage_type=storage_type,
            )
        )

    def get_task(self, dataset_name: str) -> msg.DatasetTask:
        resp = self.get(
            msg.GetDatasetTask(
                node_id=self.node_id, dataset_name=dataset_name
            )
        )
        return resp if resp is not None else msg.DatasetTask()

    def report_task_result(
        self, dataset_name: str, task_id: int, success: bool = True
    ):
        return self.report(
            msg.ReportTaskResult(
                node_id=self.node_id,
                dataset_name=dataset_name,
                task_id=task_id,
                success=success,
            )
        )

    def get_dataset_epoch(self, dataset_name: str):
        return self.get(msg.DatasetEpochQuery(dataset_name=dataset_name))

    def get_shard_checkpoint(self, dataset_name: str) -> str:
        resp = self.get(
            msg.ShardCheckpointRequest(dataset_name=dataset_name)
        )
        return resp.content if resp else ""

    def restore_shard_checkpoint(self, dataset_name: str, content: str):
        return self.report(
            msg.RestoreShardCheckpoint(
                dataset_name=dataset_name, content=content
            )
        )

    # ---- checkpoint / config ---------------------------------------------

    def report_ckpt_saved(self, step: int, path: str):
        return self.report(
            msg.CkptSaveStep(node_id=self.node_id, step=step, path=path)
        )

    def report_model_info(
        self,
        num_params: int = 0,
        flops_per_step: float = 0.0,
        batch_size_per_host: int = 0,
        seq_len: int = 0,
        program_stats: str = "",
    ):
        """Model + compiled-program stats for the master's metric
        collector / resource optimizer (reference report_model_info;
        program_stats JSON comes from utils/program_stats.py)."""
        return self.report(
            msg.ModelInfo(
                node_id=self.node_id,
                num_params=num_params,
                flops_per_step=flops_per_step,
                batch_size_per_host=batch_size_per_host,
                seq_len=seq_len,
                program_stats=program_stats,
            )
        )

    def report_diagnosis(
        self, data_type: str, content: str, ts: float = 0.0
    ):
        """Push collector payloads (log windows, chip metrics) into the
        master's diagnosis store (reference datacollector → master
        DiagnosisManager flow)."""
        return self.report(
            msg.DiagnosisReport(
                node_id=self.node_id,
                data_type=data_type,
                content=content,
                timestamp=ts,
            )
        )

    def get_ckpt_latest_step(self, path: str) -> int:
        resp = self.get(msg.CkptLatestStepQuery(path=path))
        return resp.step if resp else -1

    def get_paral_config(self) -> msg.ParallelConfig:
        resp = self.get(msg.ParallelConfigRequest(node_id=self.node_id))
        return resp or msg.ParallelConfig()

    def get_job_stage(self) -> str:
        resp = self.get(msg.JobStageQuery())
        return resp.stage if resp else ""

    def get_elastic_run_config(self) -> Dict[str, str]:
        resp = self.get(msg.ElasticRunConfigQuery())
        return resp.configs if resp else {}

    # ---- elastic PS / topology ---------------------------------------------

    def register_ps(self, addr: str, alive: bool = True) -> int:
        """Register this node as a sparse embedding-shard host; returns
        the new global cluster version."""
        resp = self.report(
            msg.PsRegister(node_id=self.node_id, addr=addr, alive=alive)
        )
        return resp.payload.version if resp and resp.payload else 0

    def get_ps_cluster(self) -> msg.PsClusterResponse:
        resp = self.get(msg.PsClusterQuery())
        return resp or msg.PsClusterResponse()

    def update_cluster_version(
        self, version: int, version_type: str = "local"
    ):
        return self.report(
            msg.ClusterVersionReport(
                version_type=version_type,
                version=version,
                node_type=self.node_type,
                node_id=self.node_id,
            )
        )

    def get_cluster_version(self, version_type: str = "global") -> int:
        resp = self.get(
            msg.ClusterVersionQuery(
                version_type=version_type,
                node_type=self.node_type,
                node_id=self.node_id,
            )
        )
        return resp.version if resp else 0

    def report_topology(
        self,
        node_rank: int = -1,
        hostname: str = "",
        slice_id: int = 0,
        coords=(-1, -1, -1),
        process_num: int = 1,
        bandwidth_gbps: float = 0.0,
    ):
        return self.report(
            msg.TopologyReport(
                node_id=self.node_id,
                node_rank=node_rank,
                process_num=process_num,
                hostname=hostname,
                slice_id=slice_id,
                coords=tuple(coords),
                bandwidth_gbps=bandwidth_gbps,
            )
        )

    def get_topology_order(self) -> List[int]:
        resp = self.get(msg.TopologyQuery())
        return resp.sorted_node_ids if resp else []

    # ---- singleton -------------------------------------------------------

    @classmethod
    def singleton(cls) -> "MasterClient":
        with cls._singleton_lock:
            if cls._singleton is None:
                addr = os.environ.get(NodeEnv.MASTER_ADDR, "")
                node_id = int(os.environ.get(NodeEnv.NODE_ID, 0))
                if not addr:
                    raise RuntimeError(
                        f"{NodeEnv.MASTER_ADDR} not set; is this process "
                        "running under tpurun / an elastic agent?"
                    )
                cls._singleton = cls(addr, node_id=node_id)
            return cls._singleton

    @classmethod
    def reset_singleton(cls):
        with cls._singleton_lock:
            if cls._singleton is not None:
                cls._singleton.close()
            cls._singleton = None
