"""Mixed precision: dtype policies and dynamic loss scaling — counterpart
of dlrover_tpu/parallel/amp.py.

The default keeps f32 params with bf16 compute and needs no loss
scaling (bf16's exponent range equals f32's); `LossScaleState` is kept
for f16 experiments and parity. The fp8 delayed-scaling matmul of the
JAX module is not ported yet.
"""

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch
from torch.utils._pytree import tree_leaves, tree_map

from dlrover_tpu_torch._device import DeviceLike, resolve_device


@dataclass(frozen=True)
class Policy:
    """What dtype each tensor class lives in (haiku/flax mp convention)."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, tree):
        return _cast_floating(tree, self.compute_dtype)


def _cast_floating(tree, dtype: torch.dtype):
    """Every floating tensor of a nested dict/list/tuple cast to `dtype`
    (differentiably; a tensor already in `dtype` is returned as is)."""

    def cast(x: Any):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    return tree_map(cast, tree)


def get_policy(name: str) -> Policy:
    """'bf16' (default compute policy), 'f32', 'half' (pure bf16)."""
    if name in ("bf16", "mixed", "amp"):
        return Policy()
    if name in ("f32", "full"):
        return Policy(torch.float32, torch.float32, torch.float32)
    if name in ("half", "pure_bf16"):
        return Policy(torch.bfloat16, torch.bfloat16, torch.bfloat16)
    raise ValueError(f"unknown precision policy: {name}")


class LossScaleState(NamedTuple):
    scale: torch.Tensor        # f32 scalar
    good_steps: torch.Tensor   # i32 scalar


def init_loss_scale(
    initial: float = 2.0 ** 15, device: DeviceLike = None
) -> LossScaleState:
    """The loss-scale state on `device` (None: the card, as every entry
    point of the port; the CPU only when the caller names it)."""
    device = resolve_device(device)
    return LossScaleState(
        scale=torch.tensor(initial, dtype=torch.float32, device=device),
        good_steps=torch.tensor(0, dtype=torch.int32, device=device),
    )


def scale_loss(loss: torch.Tensor, state: LossScaleState) -> torch.Tensor:
    return loss * state.scale.to(loss.dtype)


def unscale_grads(grads, state: LossScaleState):
    inv = 1.0 / state.scale.float()
    return tree_map(lambda g: (g.float() * inv).to(g.dtype), grads)


def all_finite(grads) -> torch.Tensor:
    finite: Optional[torch.Tensor] = None
    for g in tree_leaves(grads):
        ok = torch.isfinite(g).all()
        finite = ok if finite is None else finite & ok
    return torch.tensor(True) if finite is None else finite


def adjust_loss_scale(
    state: LossScaleState,
    grads_finite: torch.Tensor,
    growth_interval: int = 2000,
    growth_factor: float = 2.0,
    backoff_factor: float = 0.5,
    max_scale: float = 2.0 ** 24,
) -> LossScaleState:
    """torch.cuda.amp.GradScaler update rule, branchless."""
    finite = grads_finite.to(state.scale.device)
    grown = state.good_steps + 1 >= growth_interval
    new_scale = torch.where(
        finite,
        torch.where(
            grown,
            torch.clamp(state.scale * growth_factor, max=max_scale),
            state.scale,
        ),
        torch.clamp(state.scale * backoff_factor, min=1.0),
    )
    new_good = torch.where(
        finite & ~grown, state.good_steps + 1, torch.zeros_like(state.good_steps)
    )
    return LossScaleState(scale=new_scale, good_steps=new_good)
