"""Activation checkpointing (rematerialization) policies and host
offload — counterpart of dlrover_tpu/parallel/remat.py.

The JAX package maps a policy name to a `jax.checkpoint` policy; here a
name maps to the `context_fn` of `torch.utils.checkpoint.checkpoint`
(non-reentrant), which decides what the checkpointed region saves:

- "none": no checkpoint; "full": nothing saved, everything recomputed
  (`nothing_saveable`);
- "dots" / "dots_no_batch": the outputs of the matrix products saved
  (`aten.mm` / `bmm` / `addmm` / `baddbmm` and the tagged products; only
  those without a batch dimension, `mm` / `addmm` and the tagged ones,
  for "dots_no_batch"), through `create_selective_checkpoint_contexts`;
- "proj" / "proj_mlp" / "save_names": the activations tagged with those
  names saved (JAX's `save_only_these_names`), everything else recomputed;
- "offload_names": the tagged activations kept in pinned host memory
  between the forward and the backward and brought back for the
  recompute (JAX's `save_and_offload_only_these_names`), everything else
  recomputed.

Tags are ops registered with `torch.library`, so a policy sees the name
among the op's arguments: `tagged_matmul(x, w, name)` is the product
itself carrying the name (torch's recompute re-runs every op a policy
does not save, so a tag on a product's output would save memory but not
the product's work), `checkpoint_name(x, name)` tags any other tensor.
Both tag only where autograd records (a serving forward runs the plain
product); neither changes a value. A `checkpoint_name` tag is a copy of
its input, so it tags only inside an `apply_remat` region whose policy
(or an enclosing one's) reads that name; elsewhere it returns `x`.
"""

import contextvars
from typing import Callable, FrozenSet, Optional, Sequence

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)
from torch.utils._python_dispatch import TorchDispatchMode

from dlrover_tpu_torch.ops.quantization import QuantizedWeight, matmul_any

# the names JAX's "proj" and "proj_mlp" save
PROJ_NAMES = ("qkv_proj", "attn_proj", "mlp_down")
PROJ_MLP_NAMES = PROJ_NAMES + ("mlp_gate", "mlp_up")


@torch.library.custom_op("dlrover_tpu::tagged_matmul", mutates_args=())
def _tagged_matmul(x: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
    return torch.matmul(x, w)


@_tagged_matmul.register_fake
def _(x, w, name):
    return x.new_empty((*x.shape[:-1], w.shape[-1]))


def _tagged_matmul_setup(ctx, inputs, output):
    x, w, _ = inputs
    ctx.save_for_backward(x, w)


def _tagged_matmul_bwd(ctx, g):
    # the products torch's own `x @ w` backward takes (x folded to 2-D)
    x, w = ctx.saved_tensors
    dx = g @ w.t() if ctx.needs_input_grad[0] else None
    dw = None
    if ctx.needs_input_grad[1]:
        dw = x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
    return dx, dw, None


_tagged_matmul.register_autograd(_tagged_matmul_bwd,
                                 setup_context=_tagged_matmul_setup)


@torch.library.custom_op("dlrover_tpu::checkpoint_name", mutates_args=())
def _checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()   # an op's output may not alias its input


@_checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


_checkpoint_name.register_autograd(lambda ctx, g: (g, None))

_TAGS = (torch.ops.dlrover_tpu.tagged_matmul.default,
         torch.ops.dlrover_tpu.checkpoint_name.default)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
         torch.ops.dlrover_tpu.tagged_matmul.default)
_DOTS_NO_BATCH = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                  torch.ops.dlrover_tpu.tagged_matmul.default)


def _records(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def tagged_matmul(x: torch.Tensor, w, name: str) -> torch.Tensor:
    """`matmul_any(x, w)` tagged `name` (JAX's `checkpoint_name` on a
    product's output) where autograd records; a QuantizedWeight, or a
    forward without autograd, takes `matmul_any` as it is."""
    if isinstance(w, QuantizedWeight) or not _records(x, w):
        return matmul_any(x, w)
    return _tagged_matmul(x, w, name)


# the names the policies of the enclosing apply_remat regions read
_READ_NAMES: contextvars.ContextVar = contextvars.ContextVar(
    "remat_read_names", default=frozenset())


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """`x` tagged `name` for the policies (JAX's `checkpoint_name`) where
    autograd records and an enclosing policy reads `name`; `x` itself
    elsewhere, which saves the tag's copy where no policy would see it."""
    if name in _READ_NAMES.get() and _records(x):
        return _checkpoint_name(x, name)
    return x


def _tag_name(func, args) -> Optional[str]:
    return args[-1] if func in _TAGS else None


def _saving(should_save: Callable[..., bool]) -> Callable:
    """The context_fn of a selective checkpoint that saves the outputs of
    the ops `should_save(func, args)` picks."""

    def policy(ctx, func, *args, **kwargs):
        del ctx, kwargs
        return (CheckpointPolicy.MUST_SAVE if should_save(func, args)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    def context_fn():
        return create_selective_checkpoint_contexts(policy)

    return context_fn


class _Offload(TorchDispatchMode):
    """Forward side of "offload_names": a tagged op in `names` runs, and
    a copy of its output goes to `store` in pinned host memory (for a
    tensor on the card; a CPU tensor is copied as it is)."""

    def __init__(self, names, store):
        super().__init__()
        self.names, self.store = names, store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _tag_name(func, args) in self.names:
            if out.is_cuda:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
            else:
                host = out.clone()
            self.store.append((host, out.device))
        return out


class _Reload(TorchDispatchMode):
    """Recompute side: a tagged op in `names` is not run again; its
    output comes back from host memory, in the forward's order."""

    def __init__(self, names, store):
        super().__init__()
        self.names, self.store, self.next = names, store, 0

    def __enter__(self):
        self.next = 0
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _tag_name(func, args) in self.names:
            host, device = self.store[self.next]
            self.next += 1
            return host.to(device, non_blocking=True)
        return func(*args, **(kwargs or {}))


def _offloading(names: FrozenSet[str]) -> Callable:
    def context_fn():
        store = []
        return _Offload(names, store), _Reload(names, store)

    return context_fn


def resolve_policy(
    name: str,
    save_names: Sequence[str] = (),
    offload_src: str = "device",
    offload_dst: str = "pinned_host",
) -> Optional[Callable]:
    """The checkpoint `context_fn` of a policy name (the module docstring
    lists them); None for "none". `offload_src` / `offload_dst` are JAX's
    memory kinds and take only their defaults: the card and pinned host
    memory."""
    if (offload_src, offload_dst) != ("device", "pinned_host"):
        raise ValueError(f"offload from {offload_src!r} to {offload_dst!r}:"
                         " only 'device' to 'pinned_host'")
    if name == "none":
        return None
    if name == "full":
        return noop_context_fn
    if name == "dots":
        return _saving(lambda func, args: func in _DOTS)
    if name == "dots_no_batch":
        return _saving(lambda func, args: func in _DOTS_NO_BATCH)
    names = _tag_names(name, save_names)
    if name == "offload_names":
        return _offloading(names)
    if names is not None:
        return _saving(lambda func, args: _tag_name(func, args) in names)
    raise ValueError(f"unknown remat policy: {name}")


def _tag_names(name: str,
               save_names: Sequence[str]) -> Optional[FrozenSet[str]]:
    """The tag names the policy `name` keeps (saved or offloaded); None
    for a policy that looks at no tag."""
    if name in ("save_names", "offload_names"):
        return frozenset(save_names)
    return {"proj": frozenset(PROJ_NAMES),
            "proj_mlp": frozenset(PROJ_MLP_NAMES)}.get(name)


def apply_remat(
    fn: Callable,
    policy_name: str = "full",
    save_names: Sequence[str] = (),
    prevent_cse: bool = True,
) -> Callable:
    """Wrap `fn` (a layer body, or a whole loss) with the chosen policy.
    `prevent_cse` is JAX's argument; eager PyTorch has no CSE to
    prevent."""
    del prevent_cse
    context_fn = resolve_policy(policy_name, save_names)
    if context_fn is None:
        return fn
    reads = _tag_names(policy_name, save_names) or frozenset()

    def wrapped(*args, **kwargs):
        # the names read in the forward, kept for the recompute, which
        # must tag exactly as the forward did
        names = _READ_NAMES.get() | reads

        def body(*a, **kw):
            token = _READ_NAMES.set(names)
            try:
                return fn(*a, **kw)
            finally:
                _READ_NAMES.reset(token)

        return checkpoint(
            body, *args, use_reentrant=False, context_fn=context_fn, **kwargs
        )

    return wrapped


def remat_every_n(
    fn: Callable, layer_index: int, n: int, policy_name: str = "full"
) -> Callable:
    """Selective layer checkpointing: remat layers where index % n == 0,
    leave the rest saved."""
    if n <= 0 or layer_index % n != 0:
        return fn
    return apply_remat(fn, policy_name)
