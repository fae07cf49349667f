"""Low-precision optimizer states — counterpart of
dlrover_tpu/optim/low_precision.py.

`Bf16AdamW` / `bf16_adam`: AdamW with the first moment stored in bf16
and the second in f32, the update in f32. `Int8AdamW` / `int8_adam`:
AdamW with both moments stored as per-block int8 with f32 scales (mu
and sqrt(nu), each flattened, zero-padded to a block multiple and held
as one [1, padded] row, as the JAX `Int8AdamState` holds them): at
every step both are dequantized (kernel 6, `dequantize_int8`), updated
in f32, used unquantized for the update, and quantized back (kernel 5,
`quantize_int8`). Each factory returns the `params -> Optimizer` that
`accelerate` / `ElasticTrainer` take, and its step is the optax chain
of the JAX factory (see `_chain`).
"""

from typing import Dict, Mapping

import numpy as np
import torch

from dlrover_tpu_torch.ops.quantization import (
    DEFAULT_BLOCK,
    dequantize_any,
    quantize_any,
)
from dlrover_tpu_torch.optim._chain import (
    ChainOptimizer,
    Mask,
    ScalarOrSchedule,
)

_MOMENTS = ("q_mu", "s_mu", "q_nu", "s_nu")


class Bf16AdamW(ChainOptimizer):
    """`scale_by_adam_low_precision` (mu bf16, nu f32) ->
    `add_decayed_weights` -> `scale_by_learning_rate`."""

    def __init__(self, params, lr: ScalarOrSchedule = 1e-3, b1=0.9,
                 b2=0.999, eps=1e-8, weight_decay=0.0, mask: Mask = None):
        super().__init__(params, dict(betas=(b1, b2), eps=eps), lr,
                         weight_decay, mask)

    def _init_state(self, p, group):
        return {"mu": torch.zeros_like(p, dtype=torch.bfloat16),
                "nu": torch.zeros_like(p, dtype=torch.float32)}

    def _direction(self, p, g, state, group, bc):
        b1, b2 = group["betas"]
        g = g.float()
        mu = state["mu"].float().mul_(b1).add_(g * (1 - b1))
        state["mu"] = mu = mu.to(torch.bfloat16)
        nu = state["nu"]
        nu.mul_(b2).add_(g.square().mul_(1 - b2))
        den = (nu / bc[1]).sqrt_().add_(group["eps"])
        return mu.float().div_(bc[0]).div_(den)


def bf16_adam(learning_rate: ScalarOrSchedule = 1e-3, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8,
              weight_decay: float = 0.0, mask: Mask = None):
    """AdamW with a bf16 first moment (half the mu memory): the factory
    `params -> Bf16AdamW`."""
    return lambda params: Bf16AdamW(params, learning_rate, b1, b2, eps,
                                    weight_decay, mask)


def _padded(p: torch.Tensor, block: int) -> int:
    return -(-p.numel() // block) * block


class Int8AdamW(ChainOptimizer):
    """`scale_by_adam_int8` -> `add_decayed_weights` ->
    `scale_by_learning_rate`. State per param: `q_mu`, `q_nu` int8
    [1, padded] and `s_mu`, `s_nu` f32 [1, padded / block], starting at
    zeros and ones as in JAX."""

    def __init__(self, params, lr: ScalarOrSchedule = 1e-3, b1=0.9,
                 b2=0.999, eps=1e-8, weight_decay=0.0,
                 block: int = DEFAULT_BLOCK, mask: Mask = None):
        super().__init__(params, dict(betas=(b1, b2), eps=eps, block=block),
                         lr, weight_decay, mask)

    def _init_state(self, p, group):
        n = _padded(p, group["block"])
        blocks = n // group["block"]
        state = {}
        for m in ("mu", "nu"):
            state["q_" + m] = torch.zeros((1, n), dtype=torch.int8,
                                          device=p.device)
            state["s_" + m] = torch.ones((1, blocks), dtype=torch.float32,
                                         device=p.device)
        return state

    def _direction(self, p, g, state, group, bc):
        b1, b2 = group["betas"]
        block = group["block"]
        pad = state["q_mu"].shape[1] - p.numel()
        g = g.float()
        # mu = b1 * dq(q_mu) + (1 - b1) * g, each op rounded once
        mu = dequantize_any(state["q_mu"], state["s_mu"], p.shape, pad)
        mu.mul_(b1).add_(g * (1 - b1))
        # nu = b2 * dq(q_nu)^2 + (1 - b2) * g^2
        nu = dequantize_any(state["q_nu"], state["s_nu"], p.shape, pad)
        nu.square_().mul_(b2).add_(g.square().mul_(1 - b2))
        state["q_mu"], state["s_mu"], _, _ = quantize_any(mu, block)
        state["q_nu"], state["s_nu"], _, _ = quantize_any(nu.sqrt(), block)
        # the update from the unquantized moments
        den = nu.div_(bc[1]).sqrt_().add_(group["eps"])
        return mu.div_(bc[0]).div_(den)


def int8_adam(learning_rate: ScalarOrSchedule = 1e-3, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8,
              weight_decay: float = 0.0, block: int = DEFAULT_BLOCK,
              mask: Mask = None):
    """AdamW with int8 block-quantized moments (about a quarter of
    AdamW's moment memory): the factory `params -> Int8AdamW`."""
    return lambda params: Int8AdamW(params, learning_rate, b1, b2, eps,
                                    weight_decay, block, mask)


def int8_adam_state_from_numpy(opt: Int8AdamW,
                               state: Mapping[str, object]) -> None:
    """Load a JAX `Int8AdamState` into `opt`: `state["count"]` the step
    count, and `state[k]` for k in q_mu, s_mu, q_nu, s_nu a sequence of
    numpy arrays, one per param in the optimizer's order (its param
    groups' params, in turn), in the JAX layout ([1, padded] int8,
    [1, padded / block] f32). The counterpart of
    `llama.params_from_numpy` for the optimizer."""
    params = [p for g in opt.param_groups for p in g["params"]]
    for key in _MOMENTS:
        if len(state[key]) != len(params):
            raise ValueError(
                f"{key} has {len(state[key])} leaves for {len(params)} params"
            )
    for i, p in enumerate(params):
        st: Dict[str, torch.Tensor] = opt.state[p]
        for key in _MOMENTS:
            a = np.asarray(state[key][i])
            if tuple(a.shape) != tuple(st[key].shape):
                raise ValueError(
                    f"{key}[{i}] has shape {a.shape}, the optimizer "
                    f"holds {tuple(st[key].shape)}"
                )
            st[key] = torch.from_numpy(np.array(a, copy=True)).to(
                device=p.device, dtype=st[key].dtype)
    opt.count = int(np.asarray(state["count"]))
