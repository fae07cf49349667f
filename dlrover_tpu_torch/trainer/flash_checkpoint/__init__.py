from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (  # noqa: F401
    CheckpointEngine,
    Checkpointer,
    StorageType,
)
from dlrover_tpu_torch.trainer.flash_checkpoint.formats import (  # noqa: F401
    FullCheckpointer,
    OrbaxCheckpointer,
    ShardedCheckpointer,
)
