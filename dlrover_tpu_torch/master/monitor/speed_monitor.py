"""Speed monitor: global-step throughput + straggler baseline + hang input.

Reference parity: dlrover/python/master/monitor/speed_monitor.py:43
(`SpeedMonitor` — `collect_global_step` :81, running-speed window,
straggler baseline). Workers report (step, timestamp); the monitor keeps a
sliding window of (steps/sec) samples and exposes job throughput, which
drives the auto-scaler and hang detection.

The port's copy of dlrover_tpu/master/monitor/speed_monitor.py (host
Python, no torch); it imports nothing of the JAX package.
"""

import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Set, Tuple


class SpeedMonitor:
    def __init__(self, window: int = 10):
        self._lock = threading.Lock()
        self._global_step = 0
        self._global_step_ts = 0.0
        self._init_step = 0
        self._start_ts = time.time()
        self._speeds: Deque[Tuple[float, float]] = deque(maxlen=window)
        self._worker_steps: Dict[int, Tuple[int, float]] = {}
        # per-node latest host-compute sample (ms, ts) — the runtime
        # straggler signal (host time diverges under SPMD lockstep
        # even though wall time cannot); smoothing happens over the
        # diagnosis store's history, not here
        self._worker_compute: Dict[int, Tuple[float, float]] = {}
        self._worker_start: Dict[int, float] = {}
        self._paused: Set[int] = set()
        self.first_step_ts: float = 0.0

    # ---- ingestion -------------------------------------------------------

    def collect_global_step(self, step: int, ts: Optional[float] = None):
        ts = ts or time.time()
        with self._lock:
            if self._global_step_ts and step > self._global_step:
                dt = ts - self._global_step_ts
                if dt > 0:
                    self._speeds.append(
                        ((step - self._global_step) / dt, ts)
                    )
            if not self.first_step_ts and step > 0:
                self.first_step_ts = ts
            self._global_step = max(self._global_step, step)
            self._global_step_ts = ts

    def global_step_info(self):
        """(last global step, its timestamp) — 0/0.0 before any report."""
        with self._lock:
            return self._global_step, self._global_step_ts

    def collect_worker_step(
        self,
        node_id: int,
        step: int,
        ts: Optional[float] = None,
        host_compute_ms: float = 0.0,
    ):
        ts = ts or time.time()
        with self._lock:
            self._worker_steps[node_id] = (step, ts)
            if host_compute_ms > 0.0:
                self._worker_compute[node_id] = (
                    host_compute_ms,
                    ts,
                )
        self.collect_global_step(step, ts)

    def worker_compute_samples(
        self,
    ) -> Dict[int, Tuple[float, float]]:
        """Latest (host_compute_ms, ts) per node — feeds the
        diagnosis straggler operator."""
        with self._lock:
            return dict(self._worker_compute)

    def clear_worker_compute(self, node_id: int):
        """Forget a node's host-compute sample — called when the
        master acts on a straggler so pre-restart samples cannot
        re-flag the relaunched (healthy) worker."""
        with self._lock:
            self._worker_compute.pop(node_id, None)

    def add_running_worker(self, node_id: int):
        with self._lock:
            self._worker_start.setdefault(node_id, time.time())

    def remove_running_worker(self, node_id: int):
        with self._lock:
            self._worker_start.pop(node_id, None)
            self._worker_steps.pop(node_id, None)
            self._worker_compute.pop(node_id, None)

    # ---- queries ---------------------------------------------------------

    @property
    def global_step(self) -> int:
        return self._global_step

    @property
    def running_speed(self) -> float:
        """Steps/sec over the sliding window."""
        with self._lock:
            if not self._speeds:
                return 0.0
            return sum(s for s, _ in self._speeds) / len(self._speeds)

    def all_worker_steps(self) -> Dict[int, int]:
        with self._lock:
            return {nid: s for nid, (s, _) in self._worker_steps.items()}

    def step_stalled(self, timeout: float) -> bool:
        """No global-step progress within `timeout` while workers run —
        the primary hang signal (feeds the diagnosis inference chain)."""
        with self._lock:
            if not self._worker_start:
                return False
            if not self._global_step_ts:
                oldest = min(self._worker_start.values())
                return time.time() - oldest > timeout
            return time.time() - self._global_step_ts > timeout

    def reset_running_speed_monitor(self):
        with self._lock:
            self._speeds.clear()
            self._global_step_ts = 0.0
