"""accelerate(): (model fns, strategy) -> init + train step on one device.

Counterpart of dlrover_tpu/parallel/accelerate.py for one device. The
JAX version jits one SPMD program over a mesh, with partition rules
placing the state; here there is one card, no rules and no mesh, and
the step runs eagerly. What stays the same: the precision policy casts
the params before the loss, grad accumulation walks a leading microbatch axis and weights each
microbatch's gradients by its valid-token count (f32 sums of grad x
weight, divided by the summed weight), `grad_norm` is the global norm
of the gradients the optimizer sees, and with loss scaling a step whose
gradients are not finite changes neither params nor optimizer state.
Activation checkpointing is the model's (`LlamaConfig.remat`, per
layer); the JAX Strategy's whole-loss `remat` / `remat_save_names`
are not ported.

The train state is `{"params": tree, "opt_state": the optimizer,
"step": int[, "loss_scale"]}`, updated in place by each step (the
optimizer holds the param tensors); `trainer/flash_checkpoint` saves
it under the paths JAX's `flatten_state` gives the JAX state and
restores it in place. The optimizer is a factory `params ->
torch.optim.Optimizer`, called on the list of param leaves (the tree's
flatten order). The counterpart of
`optax.adamw(1e-4)` is `torch.optim.AdamW(params, lr=1e-4, betas=(0.9,
0.999), eps=1e-8, weight_decay=1e-4)`: torch's default weight decay is
1e-2, optax's 1e-4.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from dlrover_tpu_torch._device import DeviceLike, resolve_device
from dlrover_tpu_torch.parallel import amp

TrainState = Dict[str, Any]
LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


@dataclass(frozen=True)
class Strategy:
    """Declarative acceleration strategy (the auto_accelerate analogue).

    grad_accum > 1 keeps the global batch fixed: the step walks a
    leading microbatch axis of the batch. precision / loss_scale as in
    the JAX package; `device` (default: the card) takes the place of
    its mesh and batch spec."""

    device: DeviceLike = None
    grad_accum: int = 1
    precision: str = "f32"       # "f32" | "bf16" | "half" (amp.get_policy)
    loss_scale: bool = False


@dataclass
class Accelerated:
    """What accelerate() hands back to the trainer."""

    device: torch.device
    strategy: Strategy
    init: Callable[[torch.Generator], TrainState]
    train_step: Callable[[TrainState, Any], Tuple[TrainState, Dict]]
    eval_step: Optional[Callable] = None

    def place_batch(self, batch) -> Any:
        """A host batch (numpy arrays or tensors) on the device: the
        one-device form of the JAX `shard_batch`."""
        return tree_map(lambda x: torch.as_tensor(x, device=self.device),
                        batch)


def param_leaves(params) -> List[torch.Tensor]:
    """The floating tensors of a param tree, in flatten order: what
    the optimizer updates and the gradients are taken for."""
    return [x for x in tree_leaves(params)
            if isinstance(x, torch.Tensor) and x.is_floating_point()]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax
    `global_norm`)."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


def accelerate(
    init_params: Callable[[torch.Generator], Any],
    loss_fn: LossFn,
    optimizer: OptimizerFactory,
    strategy: Optional[Strategy] = None,
) -> Accelerated:
    """Build the training program on one device.

    init_params(generator) -> params tree (drawn on the device)
    loss_fn(params, batch) -> (loss, metrics)
    optimizer(list of param leaves) -> torch.optim.Optimizer
    """
    strategy = strategy or Strategy()
    device = resolve_device(strategy.device)
    policy = amp.get_policy(strategy.precision)

    def _loss_body(params, batch):
        return loss_fn(policy.cast_to_compute(params), batch)

    def _init(generator: torch.Generator) -> TrainState:
        params = init_params(generator)
        leaves = param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        state = {"params": params, "opt_state": optimizer(leaves), "step": 0}
        if strategy.loss_scale:
            state["loss_scale"] = amp.init_loss_scale(device=device)
        return state

    def _grads(params, batch, ls=None):
        loss, metrics = _loss_body(params, batch)
        scaled = loss if ls is None else amp.scale_loss(loss, ls)
        grads = torch.autograd.grad(
            scaled, param_leaves(params), allow_unused=True,
            materialize_grads=True,
        )
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def _train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = state["params"]
        ls = state.get("loss_scale") if strategy.loss_scale else None
        if strategy.grad_accum > 1:
            # microbatches weighted by their valid-token count
            # (metrics["loss_weight"] where the loss provides one, else
            # uniform), so a masked loss matches the single big-batch step
            grads, loss_sum, w_sum = None, 0.0, 0.0
            for i in range(strategy.grad_accum):
                mb = tree_map(lambda x: x[i], batch)
                loss, m, g = _grads(params, mb, ls)
                w = m.get("loss_weight")
                w = torch.ones((), device=loss.device) if w is None else w
                w = w.float()
                if grads is None:
                    grads = [gi * w for gi in g]
                else:
                    for acc, gi in zip(grads, g):
                        acc.add_(gi * w)
                loss_sum = loss_sum + loss * w
                w_sum = w_sum + w
                del g
            inv = 1.0 / torch.clamp(w_sum, min=1e-8)
            for acc in grads:
                acc.mul_(inv)
            metrics = {"loss": loss_sum * inv}
        else:
            loss, metrics, grads = _grads(params, batch, ls)
            metrics = dict(metrics, loss=loss)
        if ls is not None:
            grads = amp.unscale_grads(list(grads), ls)

        metrics["grad_norm"] = global_norm(grads)
        finite = amp.all_finite(grads) if ls is not None else None
        if finite is None or bool(finite):
            leaves = param_leaves(params)
            for p, g in zip(leaves, grads):
                p.grad = g.to(p.dtype)
            state["opt_state"].step()
            for p in leaves:
                p.grad = None
        del grads
        state["step"] += 1
        if ls is not None:
            state["loss_scale"] = amp.adjust_loss_scale(ls, finite)
            metrics["loss_scale"] = state["loss_scale"].scale
        return state, metrics

    def _eval_step(state: TrainState, batch) -> Dict:
        with torch.no_grad():
            _, metrics = _loss_body(state["params"], batch)
        return metrics

    return Accelerated(
        device=device,
        strategy=strategy,
        init=_init,
        train_step=_train_step,
        eval_step=_eval_step,
    )
