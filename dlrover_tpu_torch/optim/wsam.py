"""Weighted Sharpness-Aware Minimization (KDD'23) — counterpart of
dlrover_tpu/optim/wsam.py (reference atorch/atorch/optimizers/wsam.py:11
`WeightedSAM`).

SAM needs a second gradient at the perturbed point w + rho * g/|g|;
WSAM weights the sharpness term: direction = (1-gamma)*g(w) +
gamma*g(w_adv). As in JAX these are functions over (loss_fn, params,
args) that return gradients, here through `torch.autograd.grad` on a
tree of tensors; the gradients come back in the params' tree structure,
and the params are not changed.
"""

from typing import Any, Callable, List, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from dlrover_tpu_torch.parallel.accelerate import global_norm


def _value_and_grad(loss_fn, leaves: List[torch.Tensor], spec, args,
                    has_aux: bool):
    """(loss, aux, grads) of loss_fn at the point `leaves` (aux None
    without has_aux); grads a list in the leaves' order."""
    xs = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad():
        out = loss_fn(tree_unflatten(xs, spec), *args)
        loss, aux = out if has_aux else (out, None)
        grads = torch.autograd.grad(loss, xs, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), aux, list(grads)


def _adversarial(leaves, grads, rho: float) -> List[torch.Tensor]:
    """w + rho * g / max(|g|, 1e-12), |g| the global norm."""
    scale = rho / torch.clamp(global_norm(grads), min=1e-12)
    return [p.detach() + scale * g for p, g in zip(leaves, grads)]


def sam_gradient(
    loss_fn: Callable[..., Any],
    params,
    *loss_args,
    rho: float = 0.05,
    has_aux: bool = False,
):
    """Gradient at the SAM adversarial point w + rho * g/||g|| (with
    has_aux: (grads, aux) of that point, as `jax.grad`)."""
    leaves, spec = tree_flatten(params)
    _, _, g = _value_and_grad(loss_fn, leaves, spec, loss_args, has_aux)
    adv = _adversarial(leaves, g, rho)
    _, aux, g_adv = _value_and_grad(loss_fn, adv, spec, loss_args, has_aux)
    grads = tree_unflatten(g_adv, spec)
    return (grads, aux) if has_aux else grads


def wsam(
    loss_fn: Callable[..., Any],
    rho: float = 0.05,
    gamma: float = 0.9,
    has_aux: bool = False,
) -> Callable:
    """Return grad_fn(params, *args) -> (value, grads) computing the WSAM
    gradient: (1-gamma)*grad(w) + gamma*grad(w_adv). gamma=1 is vanilla
    SAM; gamma=0 is the base optimizer. value is the loss at w ((loss,
    aux) with has_aux, as `jax.value_and_grad`)."""

    def grad_fn(params, *loss_args) -> Tuple[Any, Any]:
        leaves, spec = tree_flatten(params)
        loss, aux, g = _value_and_grad(loss_fn, leaves, spec, loss_args,
                                       has_aux)
        adv = _adversarial(leaves, g, rho)
        _, _, g_adv = _value_and_grad(loss_fn, adv, spec, loss_args,
                                      has_aux)
        combined = [(1.0 - gamma) * a + gamma * b for a, b in zip(g, g_adv)]
        value = (loss, aux) if has_aux else loss
        return value, tree_unflatten(combined, spec)

    return grad_fn
