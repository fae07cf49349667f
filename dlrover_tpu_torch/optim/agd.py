"""AGD optimizer (NeurIPS'23) — counterpart of dlrover_tpu/optim/agd.py
(reference atorch/atorch/optimizers/agd.py:18, "AGD: an
Auto-switchable optimizer using stepwise gradient Difference as
preconditioning matrix").

The second moment tracks the squared gradient difference (g_t -
g_{t-1})^2 instead of g_t^2, and the preconditioner switches per
coordinate between adaptive (1/sqrt(v)) and SGD with momentum (1/delta)
as sqrt(v_hat) + eps passes delta. Weight decay and the learning rate
follow the optax chain of the JAX `agd` (see `_chain`).
"""

import torch

from dlrover_tpu_torch.optim._chain import (
    ChainOptimizer,
    Mask,
    ScalarOrSchedule,
)


class AGD(ChainOptimizer):
    """`scale_by_agd` -> `add_decayed_weights` -> `scale_by_learning_rate`.
    State per param: `mu`, `nu` and `prev_grad` (zeros at the start: the
    first difference is the gradient itself, as in the reference)."""

    def __init__(self, params, lr: ScalarOrSchedule = 1e-3, b1=0.9,
                 b2=0.999, delta=1e-5, eps=1e-8, weight_decay=0.0,
                 mask: Mask = None):
        super().__init__(params, dict(betas=(b1, b2), delta=delta, eps=eps),
                         lr, weight_decay, mask)

    def _init_state(self, p, group):
        return {k: torch.zeros_like(p) for k in ("mu", "nu", "prev_grad")}

    def _direction(self, p, g, state, group, bc):
        b1, b2 = group["betas"]
        diff = g - state["prev_grad"]
        state["mu"].mul_(b1).add_(g * (1 - b1))
        # (1 - b2) * d * d, left to right as the JAX expression
        state["nu"].mul_(b2).add_((diff * (1 - b2)).mul_(diff))
        state["prev_grad"].copy_(g)
        den = (state["nu"] / bc[1]).sqrt_().add_(group["eps"])
        return (state["mu"] / bc[0]).div_(den.clamp_(min=group["delta"]))


def agd(
    learning_rate: ScalarOrSchedule = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    delta: float = 1e-5,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    mask: Mask = None,
):
    """AGD with optional decoupled weight decay (AdamW-style): the
    factory `params -> AGD`."""
    return lambda params: AGD(params, learning_rate, b1, b2, delta, eps,
                              weight_decay, mask)
