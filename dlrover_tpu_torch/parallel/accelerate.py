"""accelerate(): (model fns, strategy) -> init + train step, on one
device or data-parallel over a `torch.distributed` world.

Counterpart of dlrover_tpu/parallel/accelerate.py. The JAX version jits
one SPMD program over a mesh, with partition rules placing the state,
and GSPMD inserts the gradient all-reduce. Here each process holds the
whole state on its card (or CPU) and steps eagerly; in the world
`runtime.init()` joined (every rank a data shard, `MeshSpec(data=world
size)`) the ranks split the global batch:

- `place_batch` keeps this rank's rows: slice r of dim 1 of the folded
  `[accum, global/accum, ...]` batch (of dim 0 when not accumulating),
  the rows JAX's `shard_batch` gives the device at `P("data")` index r;
- the step forms G_r = sum_i w_ir g_ir, W_r = sum_i w_ir and L_r =
  sum_i w_ir loss_ir over the rank's microbatches (w the loss's
  `loss_weight`, else 1), SUM-reduces them in one flat f32 buffer, and
  steps on G/W with loss L/W: the gradient of JAX's masked mean over
  the global batch, also where ranks hold different valid-token counts;
- `init` broadcasts params and optimizer state once (`broadcast_state`),
  so every rank starts bit-identical, as JAX's one global array does,
  and the reduced gradient keeps them so.

What stays the same as JAX with or without a world: the precision
policy casts the params before the loss, grad accumulation walks a
leading microbatch axis and weights each microbatch's gradients by its
valid-token count (f32 sums of grad x weight, divided by the summed
weight), `grad_norm` is the global norm of the gradients the optimizer
sees, with loss scaling a step whose gradients are not finite changes
neither params nor optimizer state, and `Strategy.remat` wraps the
whole loss body in the named remat policy (`remat_save_names` for
"save_names" / "offload_names"), over the model's own per-layer
checkpoint (`LlamaConfig.remat`). With no world the step is the
one-device step it always was.

The train state is `{"params": tree, "opt_state": the optimizer,
"step": int[, "loss_scale"]}`, updated in place by each step (the
optimizer holds the param tensors); `trainer/flash_checkpoint` saves
it under the paths JAX's `flatten_state` gives the JAX state and
restores it in place. The optimizer is a factory `params ->
torch.optim.Optimizer`, called on the list of param leaves (the tree's
flatten order); a factory that sets `takes_params` (`models/lora.py`
`lora_optimizer`, which labels the leaves by their paths) is called
with the leaves and the param tree (`make_optimizer`). Gradients are
taken for every leaf, also those such an optimizer leaves frozen:
`grad_norm` is the norm over all of them, as JAX's is. The counterpart of
`optax.adamw(1e-4)` is `torch.optim.AdamW(params, lr=1e-4, betas=(0.9,
0.999), eps=1e-8, weight_decay=1e-4)`: torch's default weight decay is
1e-2, optax's 1e-4.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from dlrover_tpu_torch._device import DeviceLike, resolve_device
from dlrover_tpu_torch.parallel import amp, remat
from dlrover_tpu_torch.runtime import wire_tensor

TrainState = Dict[str, Any]
LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


@dataclass(frozen=True)
class Strategy:
    """Declarative acceleration strategy (the auto_accelerate analogue).

    grad_accum > 1 keeps the global batch fixed: the step walks a
    leading microbatch axis of the batch. precision / remat /
    loss_scale as in the JAX package; `device` (default: the card) is
    this process's device. The ranks are those of the world
    `runtime.init()` joined (`default_group()`), each a data shard."""

    device: DeviceLike = None
    grad_accum: int = 1
    precision: str = "f32"       # "f32" | "bf16" | "half" (amp.get_policy)
    remat: str = "none"          # remat.resolve_policy names
    remat_save_names: Tuple = ()
    loss_scale: bool = False


def default_group():
    """The world `runtime.init()` (or the caller) joined, else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


@dataclass
class Accelerated:
    """What accelerate() hands back to the trainer."""

    device: torch.device
    strategy: Strategy
    init: Callable[[torch.Generator], TrainState]
    train_step: Callable[[TrainState, Any], Tuple[TrainState, Dict]]
    eval_step: Optional[Callable] = None
    group: Any = None     # None: one process, no world
    rank: int = 0
    world_size: int = 1

    def place_batch(self, batch, shard: bool = True) -> Any:
        """A host batch (numpy arrays or tensors) on the device: JAX's
        `shard_batch`. In a world each rank keeps its rows, slice `rank`
        of dim 1 of a folded `[accum, global/accum, ...]` batch (of dim
        0 when not accumulating); `shard=False` keeps every row (eval:
        each rank evaluates the global batch on its whole state)."""
        if self.group is None or not shard:
            return tree_map(
                lambda x: torch.as_tensor(x, device=self.device), batch)
        dim = 1 if self.strategy.grad_accum > 1 else 0
        return tree_map(
            lambda x: torch.as_tensor(self._rows(x, dim),
                                      device=self.device), batch)

    def _rows(self, x, dim: int):
        """This rank's slice of `x` along `dim` (a leaf without that dim
        as it is)."""
        if getattr(x, "ndim", 0) <= dim:
            return x
        n = x.shape[dim]
        if n % self.world_size:
            raise ValueError(
                f"batch dim {dim} of size {n} does not split over "
                f"{self.world_size} data shards")
        per = n // self.world_size
        return x[(slice(None),) * dim
                 + (slice(self.rank * per, (self.rank + 1) * per),)]


def param_leaves(params) -> List[torch.Tensor]:
    """The floating tensors of a param tree, in flatten order: what
    the optimizer updates and the gradients are taken for."""
    return [x for x in tree_leaves(params)
            if isinstance(x, torch.Tensor) and x.is_floating_point()]


def make_optimizer(factory: OptimizerFactory, params) -> torch.optim.Optimizer:
    """The optimizer `factory` builds for `params`: called on the param
    leaves, and also on the tree where the factory sets `takes_params`
    (it needs the leaves' paths)."""
    leaves = param_leaves(params)
    if getattr(factory, "takes_params", False):
        return factory(leaves, params)
    return factory(leaves)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax
    `global_norm`)."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


def _broadcast_(t: torch.Tensor, src: int, group) -> None:
    """`t` := rank `src`'s `t`, in place."""
    import torch.distributed as dist

    t = t.detach()
    wire = wire_tensor(t, group)
    dist.broadcast(wire, src=src, group=group)
    if wire is not t:
        t.copy_(wire)


def _source_rank(step: int, group) -> int:
    """The global rank whose state the world takes: the rank of `group`
    furthest along (the highest `step`; of those, the lowest rank). A
    process that joined fresh (step 0, an optimizer without state) so
    takes the trained state and never gives its own; where every rank
    is at one step, as after `init`, it is rank 0."""
    import torch.distributed as dist

    steps = [None] * dist.get_world_size(group)
    dist.all_gather_object(steps, step, group=group)
    return dist.get_global_rank(group, steps.index(max(steps)))


def broadcast_state(state: TrainState, group) -> TrainState:
    """The source rank's (`_source_rank`) live train state into every
    rank's tensors, in place: params, the optimizer's state (this
    rank's entries made where the source has them and this rank has not,
    dropped where the source has not: a rank ends with the source's
    moments, whatever it held), `step`, the optimizer's own count and
    the loss scale. The optimizer object stays, so nothing is drawn
    again. Returns `state`."""
    import torch.distributed as dist

    src = _source_rank(state["step"], group)
    opt = state["opt_state"]
    opt_params = [p for g in opt.param_groups for p in g["params"]]
    # each state entry: (key, True, (shape, dtype, on the host)) for a
    # tensor, (key, False, value) for anything else
    layout = [[(k, True, (tuple(v.shape), v.dtype, v.device.type == "cpu"))
               if torch.is_tensor(v) else (k, False, v)
               for k, v in sorted(opt.state.get(p, {}).items())]
              for p in opt_params]
    ls = state.get("loss_scale")
    meta = [layout, state["step"], getattr(opt, "count", None)]
    dist.broadcast_object_list(meta, src=src, group=group)
    layout, step, count = meta
    tensors = [t for t in tree_leaves(state["params"]) if torch.is_tensor(t)]
    for p, entries in zip(opt_params, layout):
        if not entries:
            opt.state.pop(p, None)
            continue
        st = opt.state[p]
        for k in set(st) - {k for k, _, _ in entries}:
            del st[k]
        for k, is_tensor, v in entries:
            if not is_tensor:
                st[k] = v
                continue
            shape, dtype, on_host = v
            cur = st.get(k)
            if (not torch.is_tensor(cur) or tuple(cur.shape) != shape
                    or cur.dtype != dtype):
                cur = st[k] = torch.empty(
                    shape, dtype=dtype, device="cpu" if on_host else p.device)
            tensors.append(cur)
    if ls is not None:
        tensors += [ls.scale, ls.good_steps]
    for t in tensors:
        _broadcast_(t, src, group)
    state["step"] = step
    if count is not None:
        opt.count = count
    return state


def _flat_grads(leaves: List[torch.Tensor], device) -> Tuple[
        torch.Tensor, List[torch.Tensor]]:
    """One f32 buffer for every gradient and, in its last two entries,
    the summed weight W and the weighted loss L; and each gradient's
    view into it."""
    sizes = [p.numel() for p in leaves]
    flat = torch.empty(sum(sizes) + 2, dtype=torch.float32, device=device)
    views = [v.view(p.shape)
             for v, p in zip(torch.split(flat[:-2], sizes), leaves)]
    return flat, views


def accelerate(
    init_params: Callable[[torch.Generator], Any],
    loss_fn: LossFn,
    optimizer: OptimizerFactory,
    strategy: Optional[Strategy] = None,
) -> Accelerated:
    """Build the training program on this process's device, over the
    strategy's world where it has one.

    init_params(generator) -> params tree (drawn on the device; every
    rank draws from a generator of the same seed)
    loss_fn(params, batch) -> (loss, metrics)
    optimizer(list of param leaves) -> torch.optim.Optimizer
    """
    strategy = strategy or Strategy()
    device = resolve_device(strategy.device)
    policy = amp.get_policy(strategy.precision)
    group = default_group()
    rank, world = 0, 1
    if group is not None:
        import torch.distributed as dist

        rank, world = dist.get_rank(group), dist.get_world_size(group)

    def _loss_body(params, batch):
        return loss_fn(policy.cast_to_compute(params), batch)

    if strategy.remat != "none":
        _loss_body = remat.apply_remat(
            _loss_body, strategy.remat, strategy.remat_save_names
        )

    def _init(generator: torch.Generator) -> TrainState:
        params = init_params(generator)
        leaves = param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        state = {"params": params, "opt_state": make_optimizer(optimizer,
                                                               params),
                 "step": 0}
        if strategy.loss_scale:
            state["loss_scale"] = amp.init_loss_scale(device=device)
        if group is not None:
            broadcast_state(state, group)
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

    def _weighted_grads(params, batch, ls):
        """The microbatches' gradients weighted by their valid-token
        count (metrics["loss_weight"] where the loss provides one, else
        uniform), so a masked loss matches the single big-batch step:
        the sums G = sum w*g, W = sum w and L = sum w*loss in one flat
        f32 buffer, SUM-reduced over the world where there is one (one
        all-reduce), then G/W and L/W. Over one rank the reduction is a
        copy, so a world of one gives the one-process step's bits."""
        leaves = param_leaves(params)
        flat, views = _flat_grads(leaves, device)
        accum = strategy.grad_accum
        mbs = ([tree_map(lambda x, i=i: x[i], batch) for i in range(accum)]
               if accum > 1 else [batch])
        loss_sum, w_sum, metrics = 0.0, 0.0, {}
        for k, mb in enumerate(mbs):
            loss, metrics, g = _grads(params, mb, ls)
            w = metrics.get("loss_weight")
            w = torch.ones((), device=loss.device) if w is None else w
            w = w.float()
            for v, gi in zip(views, g):
                if k == 0:
                    v.copy_(gi * w)
                else:
                    v.add_(gi * w)
            loss_sum = loss_sum + loss * w
            w_sum = w_sum + w
            del g
        flat[-2] = w_sum
        flat[-1] = loss_sum
        if group is not None:
            import torch.distributed as dist

            dist.all_reduce(flat, group=group)
        inv = 1.0 / torch.clamp(flat[-2], min=1e-8)
        for v in views:
            v.mul_(inv)
        # JAX returns the loss function's metrics of the global batch
        # when not accumulating, only the loss when accumulating; the
        # loss and its weight are the world's, other metrics this rank's
        out = {"loss": flat[-1] * inv}
        if accum == 1:
            out = dict(metrics, **out)
            if "loss_weight" in metrics:
                out["loss_weight"] = flat[-2].clone()
        return views, out

    def _train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = state["params"]
        ls = state.get("loss_scale") if strategy.loss_scale else None
        if group is None and strategy.grad_accum == 1:
            # one process, one batch: the plain gradients
            loss, metrics, grads = _grads(params, batch, ls)
            metrics = dict(metrics, loss=loss)
        else:
            grads, metrics = _weighted_grads(params, batch, ls)
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
        group=group,
        rank=rank,
        world_size=world,
    )
