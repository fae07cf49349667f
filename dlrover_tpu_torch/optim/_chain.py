"""What the port's optimizers share: the tail of the optax chains that
dlrover_tpu/optim builds, `scale_by_<method> -> add_decayed_weights(wd,
mask) -> scale_by_learning_rate(lr)`, as one `torch.optim.Optimizer`.

A subclass gives the method's direction for one param (`_direction`,
with the param's state); `step` walks the params one at a time, so the
f32 temporaries of a step never exceed a few copies of the largest
param, and applies

    p <- p + (-lr) * (direction + wd * p)

with the decay on the param before the step, where the mask allows it,
op by op as optax does it (each product and sum rounded once). There
is one step count, as in the optax state; `lr` is a float or a schedule
`count -> lr` evaluated at the count before the step's increment, as
`optax.scale_by_learning_rate` does.
"""

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

ScalarOrSchedule = Union[float, Callable[[int], float]]
# weight-decay mask: one bool per param in the optimizer's order (its
# param groups' params, in turn), or a callable on that list of params
# that returns them
Mask = Optional[Union[Sequence[bool],
                      Callable[[List[torch.Tensor]], Sequence[bool]]]]


def _resolve_mask(mask: Mask, params: List[torch.Tensor]) -> List[bool]:
    if mask is None:
        return [True] * len(params)
    flags = list(mask(params) if callable(mask) else mask)
    if len(flags) != len(params):
        raise ValueError(
            f"mask has {len(flags)} entries for {len(params)} params"
        )
    return [bool(f) for f in flags]


def bias_corrections(betas: Sequence[float], count: int) -> List[float]:
    """1 - beta ** count for each beta, in f32 as the optax transforms
    compute it (`count.astype(float32)`, an f32 power), as Python
    floats holding those f32 values."""
    c = torch.tensor(float(count), dtype=torch.float32)
    return [float(1 - torch.pow(float(b), c)) for b in betas]


class ChainOptimizer(torch.optim.Optimizer):
    """Base of the port's optax-chain optimizers (see the module). Each
    param group holds `betas` (b1, b2), whose bias corrections the
    subclass divides by."""

    def __init__(self, params, defaults: Dict, lr: ScalarOrSchedule,
                 weight_decay: float, mask: Mask):
        super().__init__(params, dict(defaults, lr=lr,
                                      weight_decay=weight_decay))
        self.count = 0
        flat = [p for g in self.param_groups for p in g["params"]]
        self._decay = dict(zip(flat, _resolve_mask(mask, flat)))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p].update(self._init_state(p, group))

    def _init_state(self, p: torch.Tensor, group: Dict) -> Dict:
        raise NotImplementedError

    def _direction(self, p: torch.Tensor, g: torch.Tensor, state: Dict,
                   group: Dict, bc: Tuple[torch.Tensor, torch.Tensor]
                   ) -> torch.Tensor:
        """The method's update for `p` (before decay and lr), as a new
        tensor of p's shape that the caller may overwrite; updates
        `state` in place. `bc` holds 1 - b1**count and 1 - b2**count
        (count 1 at the first step) as 0-dim f32 tensors on p's device:
        a division by a tensor is an IEEE one on the card, where a
        division by a Python number is a product with its reciprocal."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        before = self.count
        self.count += 1
        for group in self.param_groups:
            lr = group["lr"]
            lr = float(lr(before)) if callable(lr) else float(lr)
            wd = group["weight_decay"]
            bcs = bias_corrections(group["betas"], self.count)
            on_device = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                bc = on_device.get(p.device)
                if bc is None:
                    bc = on_device[p.device] = tuple(
                        torch.tensor(bcs, dtype=torch.float32,
                                     device=p.device).unbind())
                u = self._direction(p, p.grad, self.state[p], group, bc)
                if wd and self._decay[p]:
                    u.add_(p * wd)
                p.add_(u.mul_(-lr))
                del u   # before the next param's temporaries
        return loss
