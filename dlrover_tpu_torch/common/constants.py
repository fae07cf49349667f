"""Constants the port reads — a copy of the parts of
dlrover_tpu/common/constants.py it needs."""

import os
import tempfile


class ConfigPath:
    """Files through which the trainer publishes its state to the agent.
    The defaults lie in the temp directory the environment names
    (TMPDIR), /tmp on a default machine."""

    ENV_RUNTIME_METRICS = "DLROVER_TPU_RUNTIME_METRICS_PATH"
    DEFAULT_RUNTIME_METRICS = os.path.join(
        tempfile.gettempdir(), "dlrover_tpu", "runtime_metrics.json"
    )
    # worker-published accelerator stats
    ENV_CHIP_METRICS = "DLROVER_TPU_CHIP_METRICS_PATH"
    DEFAULT_CHIP_METRICS = os.path.join(
        tempfile.gettempdir(), "dlrover_tpu", "chip_metrics.json"
    )
