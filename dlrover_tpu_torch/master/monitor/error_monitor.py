"""Error monitor: aggregate process/node error reports.

Reference parity: dlrover/python/master/monitor/error_monitor.py
(`ErrorMonitor` ABC :22, `SimpleErrorMonitor` :42). Platform-specific
variants (K8sJobErrorMonitor :77) plug in by subclassing.

The port's copy of dlrover_tpu/master/monitor/error_monitor.py (host
Python, no torch); it imports nothing of the JAX package.
"""

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List

from dlrover_tpu_torch.common.constants import TrainingExceptionLevel
from dlrover_tpu_torch.common.log import default_logger as logger


@dataclass
class ErrorRecord:
    node_id: int
    node_type: str
    level: str
    error_data: str
    restart_count: int = 0
    timestamp: float = field(default_factory=time.time)


class ErrorMonitor:
    def process_error(self, record: ErrorRecord) -> bool:
        """Return True if the error was 'handled' (job-stopping errors
        return False so the caller escalates)."""
        raise NotImplementedError


class SimpleErrorMonitor(ErrorMonitor):
    def __init__(self, max_records: int = 1000):
        self._lock = threading.Lock()
        self._records: List[ErrorRecord] = []
        self._max_records = max_records

    def process_error(self, record: ErrorRecord) -> bool:
        with self._lock:
            self._records.append(record)
            if len(self._records) > self._max_records:
                self._records.pop(0)
        logger.warning(
            "error from %s-%d level=%s: %s",
            record.node_type,
            record.node_id,
            record.level,
            record.error_data[:500],
        )
        return record.level != TrainingExceptionLevel.NODE_ERROR

    def errors_of(self, node_id: int) -> List[ErrorRecord]:
        with self._lock:
            return [r for r in self._records if r.node_id == node_id]

    def recent(self, n: int = 20) -> List[ErrorRecord]:
        with self._lock:
            return self._records[-n:]
