"""Constants the port reads — a copy of the parts of
dlrover_tpu/common/constants.py it needs: the trainer's and the flash
checkpoint's files, and the control plane's node, job and rendezvous
names the master and its client speak."""

import os
import tempfile


class NodeType:
    MASTER = "master"
    WORKER = "worker"
    PS = "ps"
    CHIEF = "chief"
    EVALUATOR = "evaluator"


class NodeStatus:
    INITIAL = "initial"
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    DELETED = "deleted"
    UNKNOWN = "unknown"
    # breakdown of FAILED for relaunch policy
    OOM = "oom"

    @classmethod
    def is_terminal(cls, status):
        return status in (cls.SUCCEEDED, cls.FAILED, cls.DELETED)


class NodeEventType:
    ADDED = "added"
    MODIFIED = "modified"
    DELETED = "deleted"


class NodeExitReason:
    SUCCEEDED = "succeeded"
    KILLED = "killed"
    OOM = "oom"
    FATAL_ERROR = "fatal_error"
    HARDWARE_ERROR = "hardware_error"  # relaunch on a *different* host
    RELAUNCHED = "relaunched"
    UNKNOWN_ERROR = "unknown_error"


class DiagnosisDataType:
    """Payload kinds flowing agent → master over DiagnosisReport."""

    TRAINING_LOG = "training_log"
    CHIP_METRICS = "chip_metrics"
    STEP_REPORT = "step_report"
    HEARTBEAT = "heartbeat"


class JobStage:
    INIT = "init"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    STOPPED = "stopped"


class RendezvousName:
    TRAINING = "training"
    NETWORK_CHECK = "network-check"


class TrainingExceptionLevel:
    PROCESS_ERROR = "process_error"
    NODE_ERROR = "node_error"
    RDZV_ERROR = "rdzv_error"
    WARNING = "warning"
    INFO = "info"


class JobConstant:
    RDZV_JOIN_TIMEOUT_DEFAULT = 600
    # after min_nodes joined, wait this long for more before completing
    RDZV_WAITING_TIMEOUT = 3
    HEARTBEAT_INTERVAL_SECS = 15
    MASTER_CLIENT_TIMEOUT_SECS = 30
    TRAINING_AGENT_LOOP_INTERVAL_SECS = 5
    PENDING_NODE_TIMEOUT_SECS = 900
    NODE_CHECK_TIMEOUT_SECS = 300


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
