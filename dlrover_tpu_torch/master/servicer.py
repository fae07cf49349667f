"""Master RPC servicer: dispatch `get`/`report` on message type.

Reference parity: dlrover/python/master/servicer.py:72 (`MasterServicer`,
`get` :99, `report` :305) — one big type-dispatch over the ~60 message
dataclasses. Handlers delegate to the managers the master wires in.

The port's copy of dlrover_tpu/master/servicer.py (host Python, no
torch); it imports nothing of the JAX package.
"""

import time
from typing import Optional

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.comm import (
    Envelope,
    MasterServicerBase,
    ReplyEnvelope,
)
from dlrover_tpu_torch.common.constants import NodeStatus
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.elastic_ps import ElasticPsService
from dlrover_tpu_torch.master.kv_store import KVStoreService, SyncService
from dlrover_tpu_torch.master.net_topology import NetworkTopology, NodeTopologyMeta
from dlrover_tpu_torch.master.monitor.error_monitor import (
    ErrorRecord,
    SimpleErrorMonitor,
)
from dlrover_tpu_torch.master.monitor.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.master.node_manager import JobNodeManager
from dlrover_tpu_torch.master.rendezvous import (
    ElasticTrainingRendezvousManager,
    NetworkCheckRendezvousManager,
)
from dlrover_tpu_torch.master.shard.task_manager import TaskManager


class MasterServicer(MasterServicerBase):
    def __init__(
        self,
        task_manager: Optional[TaskManager] = None,
        node_manager: Optional[JobNodeManager] = None,
        speed_monitor: Optional[SpeedMonitor] = None,
        error_monitor: Optional[SimpleErrorMonitor] = None,
        kv_store: Optional[KVStoreService] = None,
        sync_service: Optional[SyncService] = None,
        rdzv_managers: Optional[dict] = None,
        job_name: str = "job",
    ):
        self.task_manager = task_manager or TaskManager()
        self.node_manager = node_manager or JobNodeManager()
        self.speed_monitor = speed_monitor or SpeedMonitor()
        self.error_monitor = error_monitor or SimpleErrorMonitor()
        self.kv_store = kv_store or KVStoreService()
        self.sync_service = sync_service or SyncService()
        self.elastic_ps = ElasticPsService()
        self.topology = NetworkTopology()
        self.rdzv_managers = rdzv_managers or {
            "training": ElasticTrainingRendezvousManager(),
            "network-check": NetworkCheckRendezvousManager(),
        }
        self.paral_config = msg.ParallelConfig()
        # identity of this master process, piggybacked on heartbeat
        # replies: agents detect master restarts (state loss) by the
        # session change and re-register (agent/training.py)
        import uuid

        self.session_id = uuid.uuid4().hex[:12]
        from dlrover_tpu_torch.master.stats import JobMetricCollector

        self.metric_collector = JobMetricCollector(job_name=job_name)
        self.run_configs = {}
        self._ckpt_steps = {}  # path -> latest committed step
        self.job_stage = "init"
        # set by the owning master: callable(data_type, node_id,
        # payload, ts) feeding its DiagnosisManager data store
        self.diagnosis_sink = None
        # composable node-event observers (reference event_callback.py):
        # data-shard recovery, SPMD world invalidation, sparse cluster
        # versioning and throughput bookkeeping all ride node events
        from dlrover_tpu_torch.master.status_flow import (
            SparseClusterCallback,
            SpeedMonitorCallback,
            SpmdWorldCallback,
            TaskRescheduleCallback,
        )

        self.node_manager.register_callback(
            TaskRescheduleCallback(self.task_manager)
        )
        self.node_manager.register_callback(
            SpmdWorldCallback(self.rdzv_managers)
        )
        self.node_manager.register_callback(
            SparseClusterCallback(self.elastic_ps)
        )
        self.node_manager.register_callback(
            SpeedMonitorCallback(self.speed_monitor)
        )

    def _rdzv(self, name: str):
        return self.rdzv_managers[name]

    # ------------------------------------------------------------------
    # get: queries
    # ------------------------------------------------------------------

    def get(self, env: Envelope) -> ReplyEnvelope:
        req = env.payload
        if isinstance(req, msg.GetDatasetTask):
            if self.task_manager.get_dataset(req.dataset_name) is None:
                # unknown ≠ exhausted: a restarted master has no
                # datasets — the client must re-register, not stop
                return ReplyEnvelope(
                    payload=msg.DatasetTask(dataset_known=False)
                )
            task = self.task_manager.get_task(
                req.node_id, req.dataset_name
            )
            return ReplyEnvelope(payload=task)
        if isinstance(req, msg.DatasetEpochQuery):
            ds = self.task_manager.get_dataset(req.dataset_name)
            if ds is None:
                return ReplyEnvelope(
                    success=False, reason="unknown dataset"
                )
            return ReplyEnvelope(
                payload=msg.DatasetEpochResponse(
                    epoch=ds.epoch(), finished=ds.finished()
                )
            )
        if isinstance(req, msg.ShardCheckpointRequest):
            content = self.task_manager.checkpoint_dataset(
                req.dataset_name
            )
            return ReplyEnvelope(
                payload=msg.ShardCheckpointResponse(content=content)
            )
        if isinstance(req, msg.GetCommWorld):
            rdzv = self._rdzv(req.rdzv_name)
            rnd, group, world = rdzv.get_comm_world(req.node_id)
            return ReplyEnvelope(
                payload=msg.CommWorldResponse(
                    round=rnd, group=group, world=world
                )
            )
        if isinstance(req, msg.NumNodesWaiting):
            rdzv = self._rdzv(req.rdzv_name)
            return ReplyEnvelope(
                payload=msg.NumNodesWaitingResponse(
                    waiting_num=rdzv.num_nodes_waiting()
                )
            )
        if isinstance(req, msg.RendezvousStateQuery):
            rdzv = self._rdzv(req.rdzv_name)
            rnd, world_size, waiting = rdzv.state()
            return ReplyEnvelope(
                payload=msg.RendezvousStateResponse(
                    round=rnd,
                    world_size=world_size,
                    waiting_num=waiting,
                )
            )
        if isinstance(req, msg.NetworkCheckQuery):
            rdzv = self._rdzv("network-check")
            if req.query == "fault":
                nodes = rdzv.check_fault_nodes()
            else:
                nodes = rdzv.get_stragglers()
            return ReplyEnvelope(
                payload=msg.NetworkCheckQueryResponse(nodes=nodes)
            )
        if isinstance(req, msg.KeyValueQuery):
            return ReplyEnvelope(
                payload=msg.KeyValuePair(
                    key=req.key, value=self.kv_store.get(req.key)
                )
            )
        if isinstance(req, msg.SyncQuery):
            return ReplyEnvelope(
                payload=msg.SyncQueryResponse(
                    reached=self.sync_service.reached(req.sync_name)
                )
            )
        if isinstance(req, msg.CkptLatestStepQuery):
            step = self._ckpt_steps.get(req.path, -1)
            return ReplyEnvelope(
                payload=msg.CkptLatestStepResponse(step=step)
            )
        if isinstance(req, msg.ParallelConfigRequest):
            return ReplyEnvelope(payload=self.paral_config)
        if isinstance(req, msg.JobStageQuery):
            return ReplyEnvelope(
                payload=msg.JobStageResponse(stage=self.job_stage)
            )
        if isinstance(req, msg.ElasticRunConfigQuery):
            return ReplyEnvelope(
                payload=msg.ElasticRunConfigResponse(
                    configs=dict(self.run_configs)
                )
            )
        if isinstance(req, msg.PsClusterQuery):
            return ReplyEnvelope(
                payload=msg.PsClusterResponse(
                    version=self.elastic_ps.get_version("global"),
                    ps_addrs=self.elastic_ps.alive_ps(),
                )
            )
        if isinstance(req, msg.ClusterVersionQuery):
            return ReplyEnvelope(
                payload=msg.ClusterVersionResponse(
                    version=self.elastic_ps.get_version(
                        req.version_type, req.node_type, req.node_id
                    )
                )
            )
        if isinstance(req, msg.TopologyQuery):
            return ReplyEnvelope(
                payload=msg.TopologyResponse(
                    sorted_node_ids=self.topology.sorted_node_ids()
                )
            )
        return ReplyEnvelope(
            success=False, reason=f"unknown get: {type(req).__name__}"
        )

    # ------------------------------------------------------------------
    # report: state updates
    # ------------------------------------------------------------------

    def report(self, env: Envelope) -> ReplyEnvelope:
        req = env.payload
        if isinstance(req, msg.DatasetShardParams):
            self.task_manager.new_dataset(
                req.dataset_name,
                req.dataset_size,
                req.shard_size,
                req.num_epochs,
                req.shuffle,
                req.storage_type,
                req.task_type,
            )
            return ReplyEnvelope()
        if isinstance(req, msg.ReportTaskResult):
            ok = self.task_manager.report_task(
                req.dataset_name, req.task_id, req.success
            )
            return ReplyEnvelope(success=ok)
        if isinstance(req, msg.RestoreShardCheckpoint):
            self.task_manager.restore_dataset(
                req.dataset_name, req.content
            )
            return ReplyEnvelope()
        if isinstance(req, msg.JoinRendezvous):
            rdzv = self._rdzv(req.rdzv_name)
            rnd = rdzv.join_rendezvous(
                req.node_id,
                req.local_world_size,
                req.node_rank,
                req.node_addr,
            )
            return ReplyEnvelope(
                payload=msg.JoinRendezvousResponse(round=rnd)
            )
        if isinstance(req, msg.NetworkCheckResult):
            rdzv = self._rdzv("network-check")
            rdzv.report_network_check(
                req.node_id, req.normal, req.elapsed_time
            )
            return ReplyEnvelope()
        if isinstance(req, msg.NodeMeta):
            from dlrover_tpu_torch.common.node import Node

            node = Node(req.type, req.id, rank_index=req.rank)
            node.host_addr = req.addr
            self.node_manager.add_node(node)
            return ReplyEnvelope()
        if isinstance(req, msg.NodeStatusReport):
            # shard recovery / world invalidation / speed bookkeeping
            # all fire via the node manager's callback registry
            self.node_manager.update_node_status(
                req.node_type, req.node_id, req.status, req.exit_reason
            )
            return ReplyEnvelope()
        if isinstance(req, msg.HeartBeat):
            self.node_manager.report_heartbeat(
                req.node_type, req.node_id, req.timestamp
            )
            return ReplyEnvelope(
                payload=msg.HeartbeatResponse(
                    master_session=self.session_id
                )
            )
        if isinstance(req, msg.GlobalStep):
            self.speed_monitor.collect_worker_step(
                req.node_id,
                req.step,
                req.timestamp,
                host_compute_ms=getattr(
                    req, "host_compute_ms", 0.0
                ),
            )
            return ReplyEnvelope()
        if isinstance(req, msg.ResourceStats):
            node = self.node_manager.get_node(
                req.node_type, req.node_id
            )
            if node is not None:
                node.used_resource.cpu = req.cpu_percent
                node.used_resource.memory_mb = req.memory_mb
            return ReplyEnvelope()
        if isinstance(req, msg.ModelInfo):
            self.run_configs["model_info"] = str(req)
            # feed the stats pipeline (reference JobMetricCollector
            # :84 — model info flows to the local/brain reporters and
            # sizes the resource optimizer's estimates)
            import json as _json

            program = {}
            if req.program_stats:
                try:
                    program = _json.loads(req.program_stats)
                except ValueError:
                    pass
            # flops_per_step and batch_size_per_host are both per-host
            # (trainer scales cost_analysis by local_device_count);
            # without token counts there is no per-token figure — report
            # 0 rather than a step total masquerading as per-token
            tokens_host = req.batch_size_per_host * req.seq_len
            self.metric_collector.collect_model_info(
                num_params=req.num_params,
                flops_per_token=(
                    req.flops_per_step / tokens_host
                    if tokens_host > 0
                    else 0.0
                ),
                batch_size=req.batch_size_per_host,
                seq_len=req.seq_len,
                program=program,
            )
            return ReplyEnvelope()
        if isinstance(req, msg.TrainingExceptionReport):
            handled = self.error_monitor.process_error(
                ErrorRecord(
                    req.node_id,
                    req.node_type,
                    req.level,
                    req.error_data,
                    req.restart_count,
                )
            )
            return ReplyEnvelope(success=handled)
        if isinstance(req, msg.KeyValuePair):
            self.kv_store.set(req.key, req.value)
            return ReplyEnvelope()
        if isinstance(req, msg.SyncJoin):
            done = self.sync_service.join(req.sync_name, req.node_id)
            return ReplyEnvelope(
                payload=msg.SyncQueryResponse(reached=done)
            )
        if isinstance(req, msg.SyncFinish):
            self.sync_service.finish(req.sync_name)
            return ReplyEnvelope()
        if isinstance(req, msg.CkptSaveStep):
            prev = self._ckpt_steps.get(req.path, -1)
            self._ckpt_steps[req.path] = max(prev, req.step)
            return ReplyEnvelope()
        if isinstance(req, msg.DiagnosisReport):
            # agent-pushed diagnosis data (log windows, chip metrics)
            # lands in the owning master's DiagnosisManager store
            if self.diagnosis_sink is not None:
                self.diagnosis_sink(
                    req.data_type,
                    req.node_id,
                    req.content,
                    req.timestamp or None,
                )
            return ReplyEnvelope()
        if isinstance(req, msg.PsRegister):
            if req.alive:
                v = self.elastic_ps.register_ps(req.node_id, req.addr)
            else:
                v = self.elastic_ps.deregister_ps(req.node_id)
            return ReplyEnvelope(
                payload=msg.ClusterVersionResponse(version=v)
            )
        if isinstance(req, msg.ClusterVersionReport):
            self.elastic_ps.update_version(
                req.version_type, req.version, req.node_type, req.node_id
            )
            return ReplyEnvelope()
        if isinstance(req, msg.TopologyReport):
            self.topology.report(
                NodeTopologyMeta(
                    node_id=req.node_id,
                    node_rank=req.node_rank,
                    process_num=req.process_num,
                    hostname=req.hostname,
                    slice_id=req.slice_id,
                    coords=tuple(req.coords),
                    bandwidth_gbps=req.bandwidth_gbps,
                )
            )
            return ReplyEnvelope()
        return ReplyEnvelope(
            success=False, reason=f"unknown report: {type(req).__name__}"
        )
