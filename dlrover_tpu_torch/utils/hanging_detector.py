"""In-library hang detection: liveness heartbeats per training step.

Reference parity: atorch/atorch/fault_tolerance/hanging_detector.py:86
(`HangingDetector` reports step liveness to a store; a monitor decides
a relaunch is needed) and custom_agent.py:19 (`LocalDetectHangingAgent`).
A copy of dlrover_tpu/utils/hanging_detector.py (pure Python threads).
The trainer calls ``record_step()`` after each completed step (after
the device has finished it — a deadlocked collective or kernel means
the step never returns, which is exactly what the wall-clock watchdog
catches). A daemon thread logs an error once no step lands within
``timeout`` seconds. The JAX version then reports the failure to the
master so the agent restarts the workers; that waits for the control
plane's port (ROADMAP queue 1, item 9).
"""

import threading
import time
from typing import Optional

from dlrover_tpu_torch.common.log import default_logger as logger


class HangingDetector:
    def __init__(
        self,
        timeout: float = 1800.0,
        check_interval: float = 10.0,
    ):
        self.timeout = timeout
        self.check_interval = check_interval
        self._last_step_time: Optional[float] = None
        self._last_step = -1
        self._hang_reported = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- trainer-facing ----------------------------------------------------

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="hanging-detector", daemon=True
        )
        self._thread.start()

    def record_step(self, step: Optional[int] = None):
        self._last_step_time = time.monotonic()
        if step is not None:
            self._last_step = step
        self._hang_reported = False

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # -- watchdog ----------------------------------------------------------

    def stalled_seconds(self) -> float:
        if self._last_step_time is None:
            return 0.0
        return time.monotonic() - self._last_step_time

    def _loop(self):
        while not self._stop.wait(self.check_interval):
            if self._last_step_time is None:
                continue  # not a single step yet: startup, not a hang
            stalled = self.stalled_seconds()
            if stalled < self.timeout or self._hang_reported:
                continue
            self._hang_reported = True
            logger.error(
                "training hang: no step for %.0f s (last step %d)",
                stalled,
                self._last_step,
            )
