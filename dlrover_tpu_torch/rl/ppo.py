"""PPO: GAE advantages, clipped losses, and the rollout -> update
trainer — counterpart of dlrover_tpu/rl/ppo.py.

`make_experience` rolls the actor out (the lockstep samplers of
rl/generate.py, or the continuous batcher), scores the rows with the
reward function, penalizes them by their KL against the ref policy,
credits each row's reward at its first generated EOS and computes GAE;
`train_on_buffer` runs the clipped-surrogate policy and value updates
over shuffled replay minibatches.

Optimizers are factories, as in parallel/accelerate.py (`list of param
leaves -> torch.optim.Optimizer`, or `models/lora.py` `lora_optimizer`,
which also takes the tree: `make_optimizer`). JAX's default
`optax.adam(1e-4)` is `torch.optim.Adam(params, lr=1e-4, betas=(0.9,
0.999), eps=1e-8)` here. `actor_opt_state` / `critic_opt_state` are the
torch optimizers (they hold the state and the param tensors, which they
update in place).

Two places where eager PyTorch would do work JAX's jit drops as dead
code are skipped, with the same values: the critic's step takes only
the value loss (no actor forward), and the actor's step takes gradients
only for the leaves its optimizer trains (under `lora_optimizer` no
frozen dW product is formed)."""

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch._device import DeviceLike, resolve_device
from dlrover_tpu_torch.parallel.accelerate import make_optimizer
from dlrover_tpu_torch.rl.generate import sample_tokens, sample_tokens_cached
from dlrover_tpu_torch.rl.model_engine import ModelEngine
from dlrover_tpu_torch.rl.replay_buffer import Experience, ReplayBuffer


@dataclasses.dataclass(frozen=True)
class GaeConfig:
    gamma: float = 1.0
    lam: float = 0.95


@dataclasses.dataclass(frozen=True)
class PpoConfig:
    clip_ratio: float = 0.2
    value_clip: float = 0.2
    vf_coef: float = 0.5
    entropy_coef: float = 0.0
    kl_coef: float = 0.1          # reward-side KL penalty vs ref
    epochs: int = 2
    minibatch_size: int = 8
    max_len: int = 32
    temperature: float = 1.0
    gae: GaeConfig = GaeConfig()
    # "auto": the lockstep sampler (the KV-cache one for a Llama actor);
    # "continuous": the slot-based continuous batcher (rl/serve.py),
    # which needs a Llama actor (model_cfg): it rides the KV-cache decode
    rollout_engine: str = "auto"


def compute_gae(
    rewards: torch.Tensor,   # [B, T] per-step rewards
    values: torch.Tensor,    # [B, T]
    mask: torch.Tensor,      # [B, T]
    cfg: GaeConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked generalized advantage estimation, right to left (JAX's
    reverse scan as a loop over T). The carry holds the next step's
    (advantage, value), zeroed where that step is padding: a masked
    step must not bootstrap."""
    b, t_len = rewards.shape
    adv_next = torch.zeros(b, dtype=rewards.dtype, device=rewards.device)
    val_next = torch.zeros_like(adv_next)
    advs = torch.empty_like(rewards)
    for t in range(t_len - 1, -1, -1):
        r, v, m = rewards[:, t], values[:, t], mask[:, t]
        delta = r + cfg.gamma * val_next - v
        adv = delta + cfg.gamma * cfg.lam * adv_next
        advs[:, t] = adv
        adv_next, val_next = adv * m, v * m
    advantages = advs * mask
    return advantages, advantages + values


def _value_loss(critic_params, critic_apply: Callable,
                batch: Dict[str, torch.Tensor], cfg: PpoConfig):
    """The clipped value loss, 0.5 * mean over generated positions of
    max((v - ret)^2, (v_clipped - ret)^2)."""
    mask = batch["mask"]
    old_values = batch["values"]
    ret = batch["returns"]
    denom = torch.clamp(mask.sum(), min=1.0)
    values = critic_apply(critic_params, batch["tokens"])[:, :-1]
    v_clipped = old_values + torch.clamp(values - old_values,
                                         -cfg.value_clip, cfg.value_clip)
    vf = torch.maximum((values - ret) ** 2, (v_clipped - ret) ** 2)
    return 0.5 * (vf * mask).sum() / denom


def ppo_loss(
    actor_params,
    critic_params,
    engine_actor_apply: Callable,
    engine_critic_apply: Callable,
    batch: Dict[str, torch.Tensor],
    cfg: PpoConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    tokens = batch["tokens"]
    mask = batch["mask"]
    old_logp = batch["logprobs"]
    adv = batch["advantages"]

    # normalize advantages over generated positions
    denom = torch.clamp(mask.sum(), min=1.0)
    a_mean = (adv * mask).sum() / denom
    a_std = torch.sqrt(((adv - a_mean) ** 2 * mask).sum() / denom + 1e-8)
    adv = (adv - a_mean) / a_std

    new_logp = ModelEngine.token_logprobs(engine_actor_apply, actor_params,
                                          tokens)
    ratio = torch.exp(new_logp - old_logp)
    surr = torch.minimum(
        ratio * adv,
        torch.clamp(ratio, 1 - cfg.clip_ratio, 1 + cfg.clip_ratio) * adv,
    )
    pg_loss = -(surr * mask).sum() / denom
    vf_loss = _value_loss(critic_params, engine_critic_apply, batch, cfg)
    entropy = -(new_logp * mask).sum() / denom  # logprob proxy

    total = pg_loss + cfg.vf_coef * vf_loss - cfg.entropy_coef * entropy
    return total, {
        "pg_loss": pg_loss,
        "vf_loss": vf_loss,
        "ratio_mean": (ratio * mask).sum() / denom,
    }


def _adam(params):
    """optax.adam(1e-4)."""
    return torch.optim.Adam(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8)


def _trained(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    """The leaves `opt` updates, marked to take gradients."""
    leaves = [p for g in opt.param_groups for p in g["params"]]
    for p in leaves:
        p.requires_grad_(True)
    return leaves


def _apply(opt: torch.optim.Optimizer, leaves, loss) -> None:
    """One optimizer step on the gradients of `loss` for `leaves`."""
    grads = torch.autograd.grad(loss, leaves)
    for p, g in zip(leaves, grads):
        p.grad = g
    opt.step()
    for p in leaves:
        p.grad = None


class PpoTrainer:
    """Rollout -> experience -> minibatch PPO epochs, on `device`
    (default: the card; the models' params must live there)."""

    def __init__(
        self,
        engine: ModelEngine,
        cfg: PpoConfig = PpoConfig(),
        actor_opt: Optional[Callable] = None,
        critic_opt: Optional[Callable] = None,
        eos_id: int = -1,
        device: DeviceLike = None,
    ):
        self.engine = engine
        self.cfg = cfg
        self.eos_id = eos_id
        self.device = resolve_device(device)
        self.actor_opt = actor_opt or _adam
        self.critic_opt = critic_opt or _adam
        self.actor_opt_state = make_optimizer(self.actor_opt,
                                              engine.actor.params)
        self.critic_opt_state = make_optimizer(self.critic_opt,
                                               engine.critic.params)
        self._actor_leaves = _trained(self.actor_opt_state)
        self._critic_leaves = _trained(self.critic_opt_state)
        self.buffer = ReplayBuffer()
        self._cb = None

    # ---- rollout ---------------------------------------------------------

    def make_experience(
        self, prompts, prompt_lens,
        generator: Optional[torch.Generator] = None,
    ) -> Experience:
        """Roll out `prompts` [B, max_len] (a row's positions from its
        `prompt_lens` on are ignored) and turn the rows into experience.
        `generator` (default: seeded 0 on the device) draws the samples,
        or the continuous engine's per-request seeds."""
        cfg = self.cfg
        eng = self.engine
        prompts = torch.as_tensor(prompts, dtype=torch.long,
                                  device=self.device)
        prompt_lens = torch.as_tensor(prompt_lens, dtype=torch.long,
                                      device=self.device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        model_cfg = getattr(eng.actor, "model_cfg", None)
        # dense models only: MoE capacity dropping depends on the
        # sequence length, so its S=1 decode logits are not the
        # teacher-forced distribution the PPO ratio uses
        if model_cfg is not None and getattr(model_cfg, "n_experts", 0):
            model_cfg = None
        if cfg.rollout_engine not in ("auto", "continuous"):
            raise ValueError(
                f"unknown rollout_engine {cfg.rollout_engine!r}: "
                "expected 'auto' or 'continuous'"
            )
        with torch.no_grad():
            if cfg.rollout_engine == "continuous":
                if model_cfg is None:
                    raise ValueError(
                        "rollout_engine='continuous' needs a llama/GPT-"
                        "family actor (KV-cache decode); this actor has "
                        "none (or is MoE, whose S=1 decode logits are "
                        "off-policy)"
                    )
                tokens = self._continuous_rollout(
                    model_cfg, prompts, prompt_lens, generator)
            elif model_cfg is not None:
                # greedy rows equal the generic sampler's; sampled ones
                # may differ near decision boundaries (the two engines'
                # logits agree to float rounding): the same policy
                tokens, _ = sample_tokens_cached(
                    model_cfg, eng.actor.params, prompts, prompt_lens,
                    cfg.max_len, generator=generator,
                    temperature=cfg.temperature, eos_id=self.eos_id)
            else:
                tokens, _ = sample_tokens(
                    eng.actor.apply_fn, eng.actor.params, prompts,
                    prompt_lens, cfg.max_len, generator=generator,
                    temperature=cfg.temperature, eos_id=self.eos_id)
            logp = eng.actor_logprobs(tokens)         # [B, L-1]
            ref_logp = eng.ref_logprobs(tokens)
            return self._finish_experience(tokens, prompt_lens, logp,
                                           ref_logp)

    def _continuous_rollout(self, model_cfg, prompts, prompt_lens,
                            generator) -> torch.Tensor:
        """A mixed-length rollout through the slot engine, returned as
        the [B, max_len] buffer the lockstep samplers produce (the
        behavior logprobs are recomputed teacher-forced either way).
        Each request's sampling is seeded from `generator`."""
        from dlrover_tpu_torch.rl.serve import ContinuousBatcher

        cfg = self.cfg
        b = prompts.shape[0]
        cb = self._cb
        if cb is None or cb.n_slots != b:
            cb = ContinuousBatcher(
                model_cfg,
                self.engine.actor.params,
                n_slots=b,
                max_len=cfg.max_len,
                max_new_tokens=cfg.max_len,
                temperature=cfg.temperature,
                eos_id=self.eos_id if self.eos_id >= 0 else None,
                # outside every vocab: never a tokenizer's eos; emitted
                # pads are dropped by the harvest, prompt-bucket pads
                # are masked
                pad_id=-1,
                device=self.device,
            )
            self._cb = cb
        else:
            # the actor trained since the last rollout: serve its new
            # weights, not the install-time ones
            cb.update_params(self.engine.actor.params)
        seeds = torch.randint(0, 2**31 - 1, (b,), generator=generator,
                              device=generator.device).tolist()
        p_np = prompts.cpu().numpy()
        lens = prompt_lens.cpu().numpy()
        submitted = []  # rows with room to generate, in order
        for row in range(b):
            n = int(lens[row])
            if n >= cfg.max_len:
                # a buffer-filling prompt generates nothing, as in the
                # lockstep engines (submit() refuses max_new < 1)
                continue
            cb.submit(p_np[row, :n], max_new=cfg.max_len - n,
                      prng_key=seeds[row])
            submitted.append(row)
        outs = cb.generate_all([]) if submitted else []
        toks = np.zeros((b, cfg.max_len), p_np.dtype)
        for row in range(b):
            n = int(lens[row])
            toks[row, :n] = p_np[row, :n]
        for row, out in zip(submitted, outs):
            n = int(lens[row])
            m = min(len(out), cfg.max_len - n)
            toks[row, n:n + m] = out[:m]
        return torch.from_numpy(toks).to(self.device)

    def _finish_experience(self, tokens, prompt_lens, logp,
                           ref_logp) -> Experience:
        cfg = self.cfg
        eng = self.engine
        dev = tokens.device
        values = eng.values(tokens)[:, :-1].float()         # [B, L-1]
        seq_reward = eng.rewards(tokens, prompt_lens).float()  # [B]

        b, seq = tokens.shape
        gen_full = (torch.arange(seq, device=dev)[None, :]
                    >= prompt_lens[:, None])
        # each row ends at its first generated EOS (or the buffer end);
        # positions after it are padding and must not train
        if self.eos_id >= 0:
            is_eos = (tokens == self.eos_id) & gen_full
            end_pos = torch.where(
                is_eos.any(dim=1),
                torch.argmax(is_eos.to(torch.int32), dim=1),
                seq - 1)
        else:
            end_pos = torch.full((b,), seq - 1, device=dev)

        pos = torch.arange(1, seq, device=dev)[None, :]
        mask = ((pos >= prompt_lens[:, None])
                & (pos <= end_pos[:, None])).float()

        # per-step reward: the KL penalty everywhere and the sequence
        # reward on the row's final step
        kl = logp - ref_logp
        step_rewards = -cfg.kl_coef * kl * mask
        last_idx = torch.clamp(end_pos - 1, 0, seq - 2)
        step_rewards[torch.arange(b, device=dev), last_idx] += seq_reward

        adv, ret = compute_gae(step_rewards, values, mask, cfg.gae)

        def host(t):
            return t.cpu().numpy()

        return Experience(
            tokens=host(tokens),
            prompt_lens=host(prompt_lens),
            logprobs=host(logp),
            values=host(values),
            advantages=host(adv),
            returns=host(ret),
            mask=host(mask),
        )

    # ---- update ----------------------------------------------------------

    def _update_fn(self, batch: Dict[str, torch.Tensor]):
        """One minibatch: the actor's step on the whole PPO loss, then
        the critic's on the value loss, each from the params before
        either step (the critic's loss does not read the actor)."""
        eng = self.engine
        cfg = self.cfg
        loss, metrics = ppo_loss(
            eng.actor.params, eng.critic.params,
            eng.actor.apply_fn, eng.critic.apply_fn, batch, cfg,
        )
        _apply(self.actor_opt_state, self._actor_leaves, loss)
        _apply(self.critic_opt_state, self._critic_leaves,
               _value_loss(eng.critic.params, eng.critic.apply_fn, batch,
                           cfg))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return metrics

    def train_on_buffer(self, rng=None) -> Dict[str, float]:
        cfg = self.cfg
        last_metrics: Dict[str, float] = {}
        for mb in self.buffer.minibatches(
            cfg.minibatch_size,
            rng=rng or np.random.default_rng(0),
            epochs=cfg.epochs,
        ):
            batch = {
                "tokens": torch.as_tensor(mb.tokens, dtype=torch.long,
                                          device=self.device),
                **{k: torch.as_tensor(getattr(mb, k), device=self.device)
                   for k in ("mask", "logprobs", "values", "advantages",
                             "returns")},
            }
            metrics = self._update_fn(batch)
            last_metrics = {k: float(v) for k, v in metrics.items()}
        return last_metrics

    def step(self, prompts, prompt_lens,
             generator: Optional[torch.Generator] = None) -> Dict[str, float]:
        """One PPO iteration: rollout, buffer, update, clear."""
        exp = self.make_experience(prompts, prompt_lens, generator)
        self.buffer.add(exp)
        metrics = self.train_on_buffer()
        self.buffer.clear()
        return metrics
