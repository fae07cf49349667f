"""Activation checkpointing (rematerialization) — counterpart of
dlrover_tpu/parallel/remat.py.

The JAX package maps a policy name to a `jax.checkpoint` policy; here a
name maps to the `context_fn` of `torch.utils.checkpoint.checkpoint`
(non-reentrant), which decides what the checkpointed region saves.
"full" saves nothing inside the region and recomputes it in the
backward, as `jax.checkpoint_policies.nothing_saveable` does. The named
policies that save chosen activations (`dots*`, `proj*`, `save_names`)
and the host offload (`offload_names`) are not ported yet.
"""

from typing import Callable, Optional

from torch.utils.checkpoint import checkpoint, noop_context_fn

_NOT_PORTED = (
    "dots", "dots_no_batch", "proj", "proj_mlp", "save_names",
    "offload_names",
)


def resolve_policy(name: str) -> Optional[Callable]:
    """The checkpoint `context_fn` of a policy name (`cfg.remat_policy`):
    None for "none" (no checkpoint), the default context (nothing
    saved, everything recomputed) for "full"."""
    if name == "none":
        return None
    if name == "full":
        return noop_context_fn
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"remat policy {name!r} is not ported yet (ROADMAP queue 1, "
            "item 6: the named remat policies); use 'full' or 'none'"
        )
    raise ValueError(f"unknown remat policy: {name}")


def apply_remat(fn: Callable, policy_name: str = "full") -> Callable:
    """Wrap `fn` (a layer body) with the chosen policy: its activations
    are recomputed in the backward instead of kept."""
    context_fn = resolve_policy(policy_name)
    if context_fn is None:
        return fn

    def wrapped(*args, **kwargs):
        return checkpoint(
            fn, *args, use_reentrant=False, context_fn=context_fn, **kwargs
        )

    return wrapped
