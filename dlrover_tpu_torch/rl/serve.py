"""The continuous-batching engine under the RL package's import path
(`from dlrover_tpu_torch.rl.serve import ContinuousBatcher`), as JAX's
`dlrover_tpu/rl/serve.py` keeps it: the engine lives in
serving/engine.py, and the PPO rollout is one of its callers."""

from dlrover_tpu_torch.serving.engine import (  # noqa: F401
    ContinuousBatcher,
    _pad_bucket,
    _Request,
)

__all__ = ["ContinuousBatcher"]
