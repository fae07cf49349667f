"""Job masters: one process that owns the control plane of a job.

Reference parity: dlrover/python/master/master.py:17 (`JobMaster` ABC),
dist_master.py:86 (`DistributedJobMaster`, run loop :211),
local_master.py:38 (`LocalJobMaster` — in-process master for single-host
runs and tests). The master hosts the 2-RPC service and a poll loop
that watches for completion, unrecoverable failure, heartbeat deaths and
hangs.

The port's counterpart of dlrover_tpu/master/master.py: `JobMaster` and
`LocalJobMaster` as there, over the port's stdlib transport
(`common/comm.py`) in place of gRPC. `DistributedJobMaster` raises.
"""

import threading
from typing import Optional

from dlrover_tpu_torch.common.comm import build_master_server
from dlrover_tpu_torch.common.constants import JobStage
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import find_free_port
from dlrover_tpu_torch.master.servicer import MasterServicer


class JobMaster:
    """Base master: RPC service + managers + watch loop."""

    def __init__(
        self,
        port: int = 0,
        servicer: Optional[MasterServicer] = None,
        poll_interval: float = 2.0,
        hang_timeout: float = 1800.0,
        job_name: str = "job",
    ):
        self.servicer = servicer or MasterServicer(job_name=job_name)
        self.port = port or find_free_port()
        self._server = build_master_server(self.servicer, self.port)
        self.poll_interval = poll_interval
        self.hang_timeout = hang_timeout
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.exit_code = 0

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    # ---- lifecycle -------------------------------------------------------

    def prepare(self):
        self._server.start()
        self.servicer.job_stage = JobStage.RUNNING
        logger.info("master serving on port %d", self.port)

    def run(self) -> int:
        """Blocking watch loop (reference DistributedJobMaster.run :211)."""
        self.prepare()
        try:
            while not self._stop.is_set():
                if self._poll_once():
                    break
                self._stop.wait(self.poll_interval)
        finally:
            self.stop()
        return self.exit_code

    def start(self):
        """Run the master in a daemon thread (in-process/local use)."""
        self.prepare()
        self._thread = threading.Thread(
            target=self._loop, name="master-loop", daemon=True
        )
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            if self._poll_once():
                break
            self._stop.wait(self.poll_interval)

    def _poll_once(self) -> bool:
        """One watch iteration; True = job finished (either way)."""
        s = self.servicer
        # heartbeat deaths flow through update_node_status → the
        # SpmdWorldCallback invalidates the rendezvous world so
        # survivors re-form instead of hanging on dead collectives
        s.node_manager.process_dead_nodes()
        if s.task_manager.has_datasets() and s.task_manager.finished():
            logger.info("all dataset tasks completed — job succeeded")
            self.servicer.job_stage = JobStage.SUCCEEDED
            return True
        if s.node_manager.all_workers_finished():
            logger.info("all workers succeeded — job succeeded")
            self.servicer.job_stage = JobStage.SUCCEEDED
            return True
        if s.node_manager.any_unrecoverable_failure():
            logger.error("unrecoverable node failure — job failed")
            self.servicer.job_stage = JobStage.FAILED
            self.exit_code = 1
            return True
        if s.speed_monitor.step_stalled(self.hang_timeout):
            logger.error("training hang detected — job failed")
            self.servicer.job_stage = JobStage.FAILED
            self.exit_code = 1
            return True
        return False

    def stop(self):
        self._stop.set()
        if self.servicer.job_stage == JobStage.RUNNING:
            self.servicer.job_stage = JobStage.STOPPED
        self._server.stop(grace=1.0)

    def join(self, timeout: Optional[float] = None):
        if self._thread:
            self._thread.join(timeout)


class LocalJobMaster(JobMaster):
    """Single-host master (reference local_master.py:38): same servicer,
    no platform scheduler; used by `tpurun` when no external master is
    configured and by the test suite."""

    def __init__(self, port: int = 0, num_nodes: int = 1, **kw):
        super().__init__(port=port, **kw)
        for rdzv in self.servicer.rdzv_managers.values():
            rdzv.update_rdzv_params(
                min_nodes=num_nodes, max_nodes=num_nodes
            )
        self.servicer.sync_service.set_expected_workers(num_nodes)


class DistributedJobMaster(JobMaster):
    """Multi-host master of the JAX package: the platform watcher, the
    relaunch policy's role pools, the scaler, the periodic auto-scaler
    and the diagnosis inference chain around the same servicer. Those
    need Kubernetes or Ray and the diagnosis package, which the port
    does not have yet (ROADMAP queue 1, item 13)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DistributedJobMaster (platform watcher, scaler, auto-scaler, "
            "diagnosis) is not ported yet (ROADMAP queue 1, item 13); "
            "use LocalJobMaster"
        )


def run_master(
    port: int = 0,
    num_nodes: int = 1,
    job_name: str = "local",
) -> LocalJobMaster:
    """Convenience: start a LocalJobMaster thread and return it."""
    master = LocalJobMaster(
        port=port, num_nodes=num_nodes, job_name=job_name
    )
    master.start()
    return master
