"""Multi-model engine: actor / critic / ref / reward under one roof —
counterpart of dlrover_tpu/rl/model_engine.py.

Each model is an (apply_fn, params) pair; apply_fn(params, tokens)
returns logits for actor and ref, per-token values for the critic; the
reward is a function of (tokens, prompt lengths). The ref is a detached
copy of the actor's params by default (a frozen snapshot at engine
construction)."""

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.utils._pytree import tree_map


def _snapshot(params):
    """A detached copy of every tensor of `params` (JAX's tree_map of
    jnp.copy)."""
    return tree_map(lambda t: t.detach().clone()
                    if isinstance(t, torch.Tensor) else t, params)


@dataclasses.dataclass
class ModelSpec:
    apply_fn: Callable  # (params, tokens[B,L]) -> model-specific output
    params: Any
    trainable: bool = False
    # a Llama config (models/llama.LlamaConfig) enables the KV-cache
    # rollout engines (rl/generate.py sample_tokens_cached, the
    # continuous batcher); None keeps the model-agnostic sampler
    model_cfg: Any = None


class ModelEngine:
    def __init__(
        self,
        actor: ModelSpec,
        critic: ModelSpec,
        reward_fn: Callable,  # (tokens[B,L], lens[B]) -> rewards [B]
        ref: Optional[ModelSpec] = None,
    ):
        self.actor = actor
        self.critic = critic
        self.reward_fn = reward_fn
        # the frozen reference policy of the KL penalty
        self.ref = ref or ModelSpec(
            apply_fn=actor.apply_fn,
            params=_snapshot(actor.params),
            trainable=False,
        )

    @staticmethod
    def token_logprobs(apply_fn: Callable, params,
                       tokens: torch.Tensor) -> torch.Tensor:
        """log pi(token_t | tokens_<t) for t >= 1 -> [B, L-1], f32."""
        logits = apply_fn(params, tokens)[:, :-1, :]
        logp = torch.log_softmax(logits.float(), dim=-1)
        tgt = tokens[:, 1:].long()
        return torch.gather(logp, -1, tgt[..., None])[..., 0]

    def actor_logprobs(self, tokens):
        return self.token_logprobs(self.actor.apply_fn, self.actor.params,
                                   tokens)

    def ref_logprobs(self, tokens):
        return self.token_logprobs(self.ref.apply_fn, self.ref.params,
                                   tokens)

    def values(self, tokens):
        return self.critic.apply_fn(self.critic.params, tokens)

    def rewards(self, tokens, lens):
        return self.reward_fn(tokens, lens)

    def sync_ref(self):
        """Re-anchor the frozen reference at the current actor."""
        self.ref = dataclasses.replace(self.ref,
                                       params=_snapshot(self.actor.params))
