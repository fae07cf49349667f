"""muP — maximal update parametrization for width scaling; counterpart
of dlrover_tpu/optim/mup.py (reference atorch mup,
atorch/atorch/mup/infshape.py, module.py).

Two functions over the param tree keyed by path regex, as in JAX:

- `mup_scale_init`: rescale a standard init — output layers get
  1/width_mult (matrix-like weights keep their fan-in init, which
  already scales as 1/sqrt(width)).
- `mup_learning_rates`: per-leaf lr multipliers (1/width_mult for
  matrix-like and output weights under Adam-family optimizers).

width_mult = dim / base_dim. Vector-like params (norms, biases, embed)
keep multiplier 1. Paths are the port's `path_str` of
`torch.utils._pytree` key paths: the port's Llama tree gives the JAX
paths (`layers/wq`, `lm_head/weight`, ...).

The JAX `scale_updates_by_mup` is an optax transform that multiplies
the updates by the multipliers; its counterpart here is
`mup_param_groups`, torch param groups at lr x multiplier.
"""

import re
from typing import Any, Callable, Dict, List, Sequence, Tuple, Union

import torch
from torch.utils._pytree import tree_leaves, tree_map_with_path

# (path_regex, kind): kind in {"matrix", "output", "vector"}
MupRules = Sequence[Tuple[str, str]]

DEFAULT_LLAMA_MUP_RULES: MupRules = (
    (r"lm_head", "output"),
    (r"layers/(wq|wk|wv|wo|w_gate|w_up|w_down|we_gate|we_up|we_down)",
     "matrix"),
    (r"router", "matrix"),
    (r"embed|_norm|scale", "vector"),
)


def path_str(path) -> str:
    """A pytree key path -> 'layers/attn/wq' style string (the port's
    copy of dlrover_tpu/parallel/sharding.py `path_str`)."""
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        elif hasattr(p, "name"):
            parts.append(str(p.name))
        else:
            parts.append(str(p))
    return "/".join(parts)


def _kind_for(path: str, rules: MupRules) -> str:
    for pat, kind in rules:
        if re.search(pat, path):
            return kind
    return "vector"


def mup_scale_init(
    params: Any,
    width_mult: float,
    rules: MupRules = DEFAULT_LLAMA_MUP_RULES,
) -> Any:
    """Rescale an SP (standard-parametrization) init to muP: a new tree,
    output leaves divided by width_mult, the others as they were."""

    def leaf(path, p):
        if _kind_for(path_str(path), rules) == "output":
            return p / width_mult
        return p

    return tree_map_with_path(leaf, params)


def mup_learning_rates(
    params: Any,
    width_mult: float,
    rules: MupRules = DEFAULT_LLAMA_MUP_RULES,
) -> Any:
    """Per-leaf lr multiplier tree (Adam-family muP: matrix/output
    weights learn at base_lr / width_mult)."""

    def leaf(path, p):
        if _kind_for(path_str(path), rules) in ("matrix", "output"):
            return 1.0 / width_mult
        return 1.0

    return tree_map_with_path(leaf, params)


def mup_param_groups(
    leaves: List[torch.Tensor],
    lr_tree: Any,
    lr: Union[float, Callable[[int], float]],
) -> List[Dict]:
    """Torch param groups, one per leaf in order, at lr x the leaf's
    multiplier (`lr_tree` from `mup_learning_rates`, flattened in the
    same order as `leaves`; a schedule lr gives each group the schedule
    times the multiplier). For an Adam-family optimizer whose lr scaling
    comes last in its chain (the port's optimizers, torch's AdamW) this
    is the JAX `scale_updates_by_mup` placed after it: every term of
    the update, the weight decay included, is scaled by the multiplier
    (up to the rounding of lr x multiplier)."""
    mults = tree_leaves(lr_tree)
    if len(mults) != len(leaves):
        raise ValueError(
            f"lr_tree has {len(mults)} multipliers for {len(leaves)} leaves"
        )

    def scaled(m: float):
        if callable(lr):
            return lambda count: lr(count) * m
        return lr * m

    return [{"params": [p], "lr": scaled(float(m))}
            for p, m in zip(leaves, mults)]
