"""RLHF: PPO training over a multi-model engine — counterpart of
dlrover_tpu/rl/ (reference atorch/rl: `rl_train`, the PPO trainer,
`ModelEngine` holding actor / critic / ref / reward, the replay buffer
and a generation backend).

Every model is an (apply_fn, params) pair of torch tensors on one
device. Rollouts run through the lockstep samplers of rl/generate.py or
the serving engine's continuous batcher (rl/serve.py); the PPO update
is eager autograd with torch optimizers built by optimizer factories
(`lora_optimizer` for a LoRA actor)."""

from dlrover_tpu_torch.rl.generate import sample_tokens
from dlrover_tpu_torch.rl.model_engine import ModelEngine
from dlrover_tpu_torch.rl.ppo import (
    GaeConfig,
    PpoConfig,
    PpoTrainer,
    compute_gae,
    ppo_loss,
)
from dlrover_tpu_torch.rl.replay_buffer import Experience, ReplayBuffer
from dlrover_tpu_torch.rl.serve import ContinuousBatcher

__all__ = [
    "Experience",
    "GaeConfig",
    "ModelEngine",
    "PpoConfig",
    "PpoTrainer",
    "ReplayBuffer",
    "compute_gae",
    "ppo_loss",
    "sample_tokens",
    "ContinuousBatcher",
]
