"""Job metric collection + pluggable reporters (master side).

Reference parity: dlrover/python/master/stats/job_collector.py:84
(`JobMetricCollector` — gathers job/model/runtime metrics), reporter.py
(`StatsReporter` ABC :55, `LocalStatsReporter` :99, `BrainReporter`
:146 persisting to the Brain/MySQL datastore), training_metrics.py.

TPU design: the same collector shape, with reporters writing JSON lines
locally or handing off to the brain service's datastore
(dlrover_tpu.brain) — the offline resource optimizer trains its plans
on exactly this stream.

The port's copy of dlrover_tpu/master/stats.py (host Python, no torch);
it imports nothing of the JAX package.
"""

import abc
import json
import os
import tempfile
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger


@dataclass
class ModelMetrics:
    """What the trainer knows about the model (reference ModelInfo)."""

    num_params: int = 0
    flops_per_token: float = 0.0
    batch_size: int = 0
    seq_len: int = 0
    # parsed utils/program_stats.ProgramStats of the compiled train
    # step (flops, peak HBM, op histogram) — the XLA stand-in for the
    # reference's TF graph OperationStats/TensorStats
    program: Dict = field(default_factory=dict)


@dataclass
class RuntimeMetrics:
    """A point-in-time snapshot of the running job."""

    timestamp: float = 0.0
    global_step: int = 0
    samples_per_sec: float = 0.0
    num_nodes: int = 0
    host_cpu_percent: float = 0.0
    host_mem_gb: float = 0.0
    device_mem_gb: float = 0.0


class StatsReporter(abc.ABC):
    @abc.abstractmethod
    def report_model(self, job: str, m: ModelMetrics): ...

    @abc.abstractmethod
    def report_runtime(self, job: str, m: RuntimeMetrics): ...


class LocalStatsReporter(StatsReporter):
    """Append metrics to JSONL files under `out_dir` (reference
    LocalStatsReporter keeps them in memory; files survive the master)."""

    def __init__(self, out_dir: Optional[str] = None):
        # under the temp directory the environment names (TMPDIR), where
        # the JAX package writes /tmp/dlrover_tpu/stats
        self.out_dir = out_dir or os.path.join(
            tempfile.gettempdir(), "dlrover_tpu", "stats"
        )
        os.makedirs(self.out_dir, exist_ok=True)
        self._lock = threading.Lock()
        self.runtime_history: List[RuntimeMetrics] = []
        self.model: Optional[ModelMetrics] = None

    def _append(self, name: str, payload: Dict):
        with self._lock:
            with open(os.path.join(self.out_dir, name), "a") as f:
                f.write(json.dumps(payload) + "\n")

    def report_model(self, job: str, m: ModelMetrics):
        self.model = m
        self._append("model.jsonl", {"job": job, **asdict(m)})

    def report_runtime(self, job: str, m: RuntimeMetrics):
        self.runtime_history.append(m)
        self._append("runtime.jsonl", {"job": job, **asdict(m)})


class BrainReporter(StatsReporter):
    """Hand metrics to the brain datastore (dlrover_tpu.brain) for
    offline optimization across jobs (reference BrainReporter → MySQL)."""

    def __init__(self, datastore):
        self._ds = datastore

    def report_model(self, job: str, m: ModelMetrics):
        self._ds.persist_metrics(job, "model", asdict(m))

    def report_runtime(self, job: str, m: RuntimeMetrics):
        self._ds.persist_metrics(job, "runtime", asdict(m))


class JobMetricCollector:
    """Aggregates per-node reports into job-level metrics and fans them
    out to reporters. The servicer calls the collect_* methods from its
    report() dispatch; the speed monitor supplies throughput."""

    def __init__(
        self,
        job_name: str,
        reporters: Optional[List[StatsReporter]] = None,
        report_interval: float = 30.0,
    ):
        self.job_name = job_name
        self.reporters = reporters or [LocalStatsReporter()]
        self.report_interval = report_interval
        self._node_resources: Dict[int, Dict] = {}
        self._model: Optional[ModelMetrics] = None
        self._last_report = 0.0
        self._lock = threading.Lock()

    def collect_model_info(
        self,
        num_params: int = 0,
        flops_per_token: float = 0.0,
        batch_size: int = 0,
        seq_len: int = 0,
        program: Optional[Dict] = None,
    ):
        m = ModelMetrics(
            num_params, flops_per_token, batch_size, seq_len,
            program or {},
        )
        with self._lock:
            if self._model == m:
                return
            self._model = m
        for r in self.reporters:
            try:
                r.report_model(self.job_name, m)
            except Exception:
                logger.exception("model report failed")

    def collect_node_resource(
        self,
        node_id: int,
        cpu_percent: float = 0.0,
        mem_gb: float = 0.0,
        device_mem_gb: float = 0.0,
    ):
        with self._lock:
            self._node_resources[node_id] = {
                "cpu": cpu_percent,
                "mem": mem_gb,
                "dev_mem": device_mem_gb,
                "ts": time.time(),
            }

    def maybe_report_runtime(
        self, global_step: int, samples_per_sec: float
    ):
        """Rate-limited job snapshot (called from the master loop)."""
        now = time.time()
        with self._lock:
            if now - self._last_report < self.report_interval:
                return
            self._last_report = now
            nodes = list(self._node_resources.values())
        m = RuntimeMetrics(
            timestamp=now,
            global_step=global_step,
            samples_per_sec=samples_per_sec,
            num_nodes=len(nodes),
            host_cpu_percent=sum(n["cpu"] for n in nodes)
            / max(len(nodes), 1),
            host_mem_gb=sum(n["mem"] for n in nodes),
            device_mem_gb=sum(n["dev_mem"] for n in nodes),
        )
        for r in self.reporters:
            try:
                r.report_runtime(self.job_name, m)
            except Exception:
                logger.exception("runtime report failed")
