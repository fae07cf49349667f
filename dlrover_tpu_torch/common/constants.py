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


class CheckpointConstant:
    """File names and the commit timeout of the flash checkpoint (the
    JAX package's, so both write the same directory layout)."""

    TRACKER_FILE = "latest_checkpointed_iteration.txt"
    MODEL_STATES_NAME = "model_states"
    OPTIM_STATES_NAME = "optim_states"
    DONE_FILE_PREFIX = ".done_"
    SAVE_TIMEOUT_SECS = 600


class NodeEnv:
    """Environment variables the agent sets for worker processes."""

    JOB_NAME = "DLROVER_TPU_JOB_NAME"
    MASTER_ADDR = "DLROVER_TPU_MASTER_ADDR"
    NODE_ID = "DLROVER_TPU_NODE_ID"
    NODE_RANK = "DLROVER_TPU_NODE_RANK"
    NODE_NUM = "DLROVER_TPU_NODE_NUM"
    COORDINATOR_ADDR = "DLROVER_TPU_COORDINATOR_ADDR"
    RESTART_COUNT = "DLROVER_TPU_RESTART_COUNT"
    MOCK_ERR_RANK = "DLROVER_TPU_MOCK_ERR_RANK"
