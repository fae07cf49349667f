"""Autoregressive sampling over a fixed [batch, max_len] token buffer
(the PPO rollout backend) — counterpart of dlrover_tpu/rl/generate.py.

Each step writes position t of the buffer; rows keep their prompt
positions (ragged prompts: a row generates from its own prompt length)
and stop at their first generated `eos_id` (the done mask). Two
engines, one step rule (`_select_next`):

- `sample_tokens`: model-agnostic, a full causal forward of the whole
  buffer each position (works with any apply_fn);
- `sample_tokens_cached`: the Llama KV-cache path (models/decode.py),
  decoding from position 0 through `decode_step` on `init_kv_cache`, one
  token a step instead of a full forward.

Where JAX splits a key each step, the draws come from a
`torch.Generator` (default: a fresh one seeded 0 on the prompts'
device): greedy rows equal JAX's token for token, sampled rows follow
the same distribution with other draws."""

from typing import Callable, Optional, Tuple

import torch

from dlrover_tpu_torch.models.decode import (
    _check_positional_capacity,
    categorical,
    decode_step,
    init_kv_cache,
)


def _select_next(last_logits, toks, done, generator, t, start_pos,
                 temperature, greedy, eos_id):
    """One step's token at position t, written into `toks` in place:
    argmax (greedy) or a draw at `temperature` (floored at 1e-6, as
    JAX's); a row still inside its prompt keeps its token, a done row
    its pad; a generated eos marks its row done. Returns `done`."""
    if greedy:
        nxt = torch.argmax(last_logits, dim=-1)
    else:
        probs = torch.softmax(
            last_logits.float() / max(temperature, 1e-6), dim=-1)
        nxt = categorical(probs, generator)
    gen_here = t >= start_pos
    nxt = torch.where(gen_here & ~done, nxt.to(toks.dtype), toks[:, t])
    done = done | (gen_here & (nxt == eos_id))
    toks[:, t] = nxt
    return done


def _start(prompts, generator):
    toks = prompts.clone()
    if generator is None:
        generator = torch.Generator(device=prompts.device).manual_seed(0)
    done = torch.zeros(prompts.shape[0], dtype=torch.bool,
                       device=prompts.device)
    return toks, done, generator


def sample_tokens(
    apply_fn: Callable,
    params,
    prompts: torch.Tensor,
    prompt_lens: torch.Tensor,
    max_len: int,
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    greedy: bool = False,
    eos_id: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """prompts: [B, max_len] (positions >= prompt_lens[b] ignored).
    Returns (tokens [B, max_len], done [B])."""
    toks, done, generator = _start(prompts, generator)
    start_pos = prompt_lens.to(prompts.device)
    with torch.no_grad():
        for t in range(1, max_len):
            logits = apply_fn(params, toks)
            done = _select_next(logits[:, t - 1, :], toks, done, generator,
                                t, start_pos, temperature, greedy, eos_id)
    return toks, done


def sample_tokens_cached(
    cfg,
    params,
    prompts: torch.Tensor,
    prompt_lens: torch.Tensor,
    max_len: int,
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    greedy: bool = False,
    eos_id: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`sample_tokens` on the KV-cache engine (a Llama config): every
    position from 0 goes through `decode_step`, prompt positions
    included, so each row's cache fills as its tokens are read."""
    _check_positional_capacity(cfg, max_len)
    toks, done, generator = _start(prompts, generator)
    start_pos = prompt_lens.to(prompts.device)
    with torch.no_grad():
        cache = init_kv_cache(cfg, prompts.shape[0], max_len,
                              device=prompts.device)
        for t in range(1, max_len):
            logits, cache = decode_step(cfg, params, toks[:, t - 1], cache,
                                        t - 1)
            done = _select_next(logits, toks, done, generator, t, start_pos,
                                temperature, greedy, eos_id)
    return toks, done
