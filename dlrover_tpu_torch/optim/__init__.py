from dlrover_tpu_torch.optim.agd import agd
from dlrover_tpu_torch.optim.low_precision import bf16_adam, int8_adam
from dlrover_tpu_torch.optim.mup import mup_learning_rates, mup_scale_init
from dlrover_tpu_torch.optim.wsam import sam_gradient, wsam

__all__ = [
    "agd",
    "wsam",
    "sam_gradient",
    "bf16_adam",
    "int8_adam",
    "mup_learning_rates",
    "mup_scale_init",
]
