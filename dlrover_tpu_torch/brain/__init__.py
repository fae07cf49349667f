"""Brain: the job-metrics datastore and the optimize algorithms — the
counterpart of dlrover_tpu/brain/, limited to what the replica pool
reads: `datastore.py` (sqlite samples, the pool's telemetry sink) and
`algorithms.py` (the ten registered algorithms, the serving forecast
among them). The RPC service over them (`brain/service.py`) is not
ported."""

from dlrover_tpu_torch.brain.algorithms import (
    ALGORITHMS,
    OptimizeContext,
    run_algorithm,
)
from dlrover_tpu_torch.brain.datastore import JobMetricsStore

__all__ = [
    "ALGORITHMS",
    "JobMetricsStore",
    "OptimizeContext",
    "run_algorithm",
]
