"""LoRA adapters for the stacked-layer Llama — counterpart of
dlrover_tpu/models/lora.py (the parts serving and the merge use).

- Adapters are extra stacked leaves in the SAME param dict
  (`layers/wq_lora_a` [L, in, r], `layers/wq_lora_b` [L, r, out]); the
  model's layer loop consumes them as it consumes every other leaf.
- The effective weight `W + (alpha/r) * A @ B` is formed in
  `llama._compute_weights`, the one place the training layer and the
  KV-cache decoder both take their weights from.
- `merge` folds the adapters into the base weights for good (merge to
  full, PEFT's merge_and_unload).
- Freezing is an optimizer concern, not a graph one: `lora_optimizer`
  builds the inner optimizer on the adapter leaves alone, so the base
  gets no update and no moment state (the memory LoRA saves).
- An adapter-only checkpoint is the `adapter_state_dict` sub-tree saved
  through the flash checkpoint engine, restored with `load_adapters`.

PEFT semantics kept: A ~ N(0, 1/r), B = 0 (the delta starts at exactly
zero), the delta scaled by alpha / rank. lora_dropout is not
implemented (the weight-level merge has no activation hook): pass 0.
`lora_partition_rules` are JAX's: under fsdp the adapter leaves are
stored as pieces like their base weights.
"""

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_map_with_path

Params = Dict[str, Any]

LORA_A = "_lora_a"
LORA_B = "_lora_b"


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """peft.LoraConfig's knobs."""

    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")
    dropout: float = 0.0

    def __post_init__(self):
        if self.rank <= 0:
            raise ValueError(f"lora rank must be positive: {self.rank}")
        if self.dropout:
            raise NotImplementedError(
                "lora_dropout is not supported by the weight-level "
                "merge; use 0.0"
            )


def is_adapter_path(path: str) -> bool:
    return LORA_A in path or LORA_B in path


def validate_targets(params: Params, targets) -> None:
    """Raise unless every target names a stacked [L, in, out] leaf of
    params["layers"]: a typo'd target would otherwise inject and merge
    nothing, silently. Shared by `inject`, `merge` and the serving
    AdapterRegistry."""
    layers = params["layers"]
    for t in targets:
        if t not in layers:
            raise KeyError(
                f"lora target {t!r} not in params['layers'] "
                f"(have {sorted(k for k in layers if not is_adapter_path(k))})"
            )
        if layers[t].ndim != 3:
            raise ValueError(
                f"lora target {t!r} must be stacked [L, in, out], "
                f"got shape {tuple(layers[t].shape)}"
            )


def adapter_base(key: str) -> str:
    """The base-weight key an adapter leaf points at
    (`wq_lora_a` -> `wq`)."""
    return key.split(LORA_A)[0].split(LORA_B)[0]


def inject(
    cfg, params: Params, lora: LoraConfig, generator: torch.Generator,
    param_dtype: torch.dtype = torch.float32,
):
    """Add adapter leaves beside each target weight; returns the
    (config, params) pair to train or serve with. The config carries
    lora.alpha (the merge reads alpha from the config and the rank from
    the adapter's shape). A is drawn on the target weight's device from
    `generator` (which must live there); B starts at zero. Base weights
    are untouched. Not the JAX package's numbers: its draws come from
    jax.random; parity tests carry JAX's injected tree across."""
    validate_targets(params, lora.targets)
    layers = dict(params["layers"])
    for t in lora.targets:
        w = layers[t]
        n_layers, d_in, d_out = w.shape
        a = torch.randn((n_layers, d_in, lora.rank), generator=generator,
                        device=w.device, dtype=param_dtype)
        layers[t + LORA_A] = a / math.sqrt(lora.rank)
        layers[t + LORA_B] = torch.zeros((n_layers, lora.rank, d_out),
                                         device=w.device, dtype=param_dtype)
    out = dict(params)
    out["layers"] = layers
    return dataclasses.replace(cfg, lora_alpha=lora.alpha), out


def lora_labels(params: Params):
    """A tree of `params`' structure with "lora" at every adapter leaf and
    "frozen" everywhere else (the labels JAX's `optax.multi_transform`
    takes)."""
    from dlrover_tpu_torch.optim.mup import path_str

    return tree_map_with_path(
        lambda path, _: "lora" if is_adapter_path(path_str(path))
        else "frozen", params)


class LoraOptimizer:
    """The optimizer factory `lora_optimizer` returns. Unlike a plain
    factory (`list of param leaves -> torch.optim.Optimizer`) it needs
    the labels, so it is called with the leaves and the param tree they
    come from (`parallel.accelerate.make_optimizer` does so for every
    factory that sets `takes_params`)."""

    takes_params = True

    def __init__(self, base: Callable[[List[torch.Tensor]],
                                      torch.optim.Optimizer]):
        self.base = base

    def __call__(self, leaves: List[torch.Tensor],
                 params: Params) -> torch.optim.Optimizer:
        labels = dict(zip((id(t) for t in tree_leaves(params)),
                          tree_leaves(lora_labels(params))))
        adapters = [p for p in leaves if labels.get(id(p)) == "lora"]
        if not adapters:
            raise ValueError(
                "lora_optimizer: the params hold no adapter leaf to train "
                "(lora.inject them first)")
        opt = self.base(adapters)
        # the key JAX's multi_transform files the inner state under
        # (`opt_state/inner_states/lora/inner_state/...`): the flash
        # checkpoint engine reads it off the optimizer
        opt.multi_transform_label = "lora"
        return opt


def lora_optimizer(base) -> LoraOptimizer:
    """Wrap an optimizer factory: the adapters train, everything else is
    frozen, with no optimizer state for it (JAX `multi_transform` with
    `set_to_zero` for the base). The inner optimizer is built on the
    adapter leaves alone, so no update, weight decay included, ever
    touches a frozen leaf; the gradients of frozen leaves may still be
    taken (accelerate reports the global norm over all of them, as
    JAX's does)."""
    return LoraOptimizer(base)


def adapter_state_dict(params: Params) -> Params:
    """The adapter-only sub-tree: what an adapter checkpoint holds and
    what the serving AdapterRegistry registers."""
    return {
        "layers": {
            k: v for k, v in params["layers"].items() if is_adapter_path(k)
        }
    }


def load_adapters(params: Params, adapters: Params) -> Params:
    """Insert an adapter dict into a base param tree. The caller's dicts
    are not modified."""
    layers = dict(params["layers"])
    for k, v in adapters["layers"].items():
        if not is_adapter_path(k):
            raise KeyError(f"{k!r} is not an adapter leaf")
        base = adapter_base(k)
        if base not in layers:
            raise KeyError(f"adapter {k!r} has no base weight {base!r}")
        layers[k] = v
    out = dict(params)
    out["layers"] = layers
    return out


def merge(cfg, params: Params) -> Params:
    """Fold the adapters into the base weights and drop them:
    W <- W + (alpha/r) A @ B, the product accumulated in f32, the sum
    stored in W's dtype. Every adapter leaf must name an existing base
    weight and carry its A/B partner: a stray leaf (a typo'd target, half
    a pair dropped by a checkpoint filter) would otherwise be discarded
    instead of merged."""
    for k in params["layers"]:
        if not is_adapter_path(k):
            continue
        base = adapter_base(k)
        if base not in params["layers"]:
            raise KeyError(
                f"adapter leaf {k!r} has no base weight {base!r} to "
                f"merge into — a typo'd target silently no-ops "
                f"without this check"
            )
        partner = base + (LORA_B if k.endswith(LORA_A) else LORA_A)
        if partner not in params["layers"]:
            raise KeyError(
                f"adapter leaf {k!r} is missing its pair {partner!r}"
            )
    layers = {}
    for k, v in params["layers"].items():
        if is_adapter_path(k):
            continue
        a = params["layers"].get(k + LORA_A)
        if a is not None:
            b = params["layers"][k + LORA_B]
            scale = cfg.lora_alpha / a.shape[-1]
            delta = torch.einsum("lir,lro->lio", a.float(), b.float())
            v = (v.float() + scale * delta).to(v.dtype)
        layers[k] = v
    out = dict(params)
    out["layers"] = layers
    return out


def lora_partition_rules():
    """PartitionSpecs of the adapter leaves (JAX's
    `lora_partition_rules`), each mirroring its base weight's layout:
    column-parallel targets (wq/wk/wv/w_gate/w_up) shard A's input dim
    on fsdp and B's output dim on tensor; row-parallel ones (wo/w_down)
    A's input dim on tensor and B's output dim on fsdp. The rank dim is
    never split."""
    from dlrover_tpu_torch.parallel.mesh import PartitionSpec as P

    return [
        (r"layers/(wq|wk|wv|w_gate|w_up)_lora_a", P("pipe", "fsdp", None)),
        (r"layers/(wq|wk|wv|w_gate|w_up)_lora_b", P("pipe", None, "tensor")),
        (r"layers/(wo|w_down)_lora_a", P("pipe", "tensor", None)),
        (r"layers/(wo|w_down)_lora_b", P("pipe", None, "fsdp")),
    ]
