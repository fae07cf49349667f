"""accelerate(): (model fns, strategy, rules) -> init + train step, on
one device or over a `torch.distributed` world laid out by a MeshSpec.

Counterpart of dlrover_tpu/parallel/accelerate.py. The JAX version jits
one SPMD program over a mesh, with partition rules placing the state,
and GSPMD inserts the collectives. Here each process steps eagerly on
its card (or CPU); in the world `runtime.init()` joined, `Strategy.mesh`
(default `MeshSpec(data=world size)`) lays the ranks out
(`MeshSpec.build`: rank r at JAX's device r's coordinates) over
`data x fsdp x seq`:

- `place_batch` keeps this rank's rows: batch shard `data index x fsdp
  + fsdp index` of `data x fsdp` (JAX's BATCH_AXES), slice of dim 1 of
  the folded `[accum, global/accum, ...]` batch (of dim 0 when not
  accumulating); with seq > 1, of each [B, S] leaf (tokens, loss_mask)
  this seq rank's chunk of the S - 1 input positions plus the next
  token (its targets);
- with fsdp > 1 the rules (`rules`, JAX's `(regex, PartitionSpec)`
  table) cut each leaf they split over fsdp into pieces
  (`sharding.ShardPlan`): a rank stores and updates only its pieces,
  the optimizer is built over them (its moments are pieces too: Adam,
  AdamW and SGD, elementwise; any other optimizer raises), and the
  model gathers each piece before its use and reduce-scatters its
  gradient (`sharding.gathered`), one layer at a time;
- the step forms G = sum_i w_i g_i, W = sum_i w_i and L = sum_i w_i
  loss_i over the rank's microbatches (w the loss's `loss_weight`, else
  1) and reduces them over the world: the whole leaves' sums and W, L in
  one flat f32 buffer over every rank, the pieces' (summed over the
  fsdp group by the reduce-scatter) over the ranks holding the same
  piece; then it steps on G/W with loss L/W, the gradient of JAX's
  masked mean over the global batch;
- `grad_norm` is the global norm, each piece counted once (optax
  `global_norm` of the whole gradient); loss scaling's finite check is
  reduced over the world, so every rank skips the same step;
- `init` draws the whole tree on each rank, keeps its pieces and then
  makes the state the same on every rank (`sync_state`): the live
  state of the rank furthest along, so a fresh replacement takes the
  survivors' state; `ElasticTrainer.on_world_change` re-cuts it for a
  new layout the same way.

What stays the same as JAX with or without a world: the precision
policy casts the params before the loss, grad accumulation walks a
leading microbatch axis and weights each microbatch's gradients by its
valid-token count (f32 sums of grad x weight, divided by the summed
weight), with loss scaling a step whose gradients are not finite changes
neither params nor optimizer state, and `Strategy.remat` wraps the
whole loss body in the named remat policy (`remat_save_names` for
"save_names" / "offload_names"), over the model's own per-layer
checkpoint (`LlamaConfig.remat`). With no world the step is the
one-device step it always was.

The train state is `{"params": tree, "opt_state": the optimizer,
"step": int[, "loss_scale"][, "layout": ShardPlan]}`, updated in place
by each step (the optimizer holds the param tensors; "layout", in a
world, says which leaves are pieces); `trainer/flash_checkpoint` saves
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
from dlrover_tpu_torch.parallel import sharding
from dlrover_tpu_torch.parallel.mesh import MeshSpec, TrainMesh, rank_coords
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
    `runtime.init()` joined (`default_group()`), laid out by `mesh`
    (default: each a data shard, `MeshSpec(data=world size)`)."""

    device: DeviceLike = None
    grad_accum: int = 1
    precision: str = "f32"       # "f32" | "bf16" | "half" (amp.get_policy)
    remat: str = "none"          # remat.resolve_policy names
    remat_save_names: Tuple = ()
    loss_scale: bool = False
    mesh: Optional[MeshSpec] = None


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
    mesh: Optional[TrainMesh] = None
    rules: Tuple = ()
    plan: Optional[sharding.ShardPlan] = None   # the last init's

    @property
    def state_shardings(self) -> Optional[Dict[str, Any]]:
        """The PartitionSpec of each param leaf and of `step` (JAX
        :262-263; the moments take their param's), from the last
        `init`: {"params": {path: spec}, "step": PartitionSpec()}."""
        if self.plan is None:
            return None
        return {"params": self.plan.specs(),
                "step": sharding.PartitionSpec()}

    def place_batch(self, batch, shard: bool = True) -> Any:
        """A host batch (numpy arrays or tensors) on the device: JAX's
        `shard_batch`. In a world each rank keeps its batch shard's
        rows, slice `batch_index` of `batch_shards` along dim 1 of a
        folded `[accum, global/accum, ...]` batch (dim 0 when not
        accumulating), and where the mesh has seq > 1 the seq rank's
        chunk of each [.., B, S] leaf (`_seq_chunk`); `shard=False`
        keeps every row and position (eval: each rank evaluates the
        global batch)."""
        if self.group is None or not shard:
            return tree_map(
                lambda x: torch.as_tensor(x, device=self.device), batch)
        dim = 1 if self.strategy.grad_accum > 1 else 0
        return tree_map(
            lambda x: torch.as_tensor(self._seq_chunk(self._rows(x, dim),
                                                      dim + 1),
                                      device=self.device), batch)

    def _rows(self, x, dim: int):
        """This rank's batch shard of `x` along `dim` (a leaf without
        that dim as it is)."""
        if getattr(x, "ndim", 0) <= dim:
            return x
        n = x.shape[dim]
        shards = self.mesh.batch_shards
        if n % shards:
            raise ValueError(
                f"batch dim {dim} of size {n} does not split over "
                f"{shards} batch shards")
        per = n // shards
        i = self.mesh.batch_index
        return x[(slice(None),) * dim + (slice(i * per, (i + 1) * per),)]

    def _seq_chunk(self, x, dim: int):
        """This seq rank's chunk of a [.., B, S] leaf along `dim` (its
        last): the S - 1 input positions split over seq, plus the token
        after the chunk (the chunk's last target). Other leaves as they
        are."""
        sp = self.mesh.size("seq")
        if sp == 1 or getattr(x, "ndim", 0) != dim + 1:
            return x
        n, rem = divmod(x.shape[dim] - 1, sp)
        if rem:
            raise ValueError(
                f"sequence of {x.shape[dim]} tokens: its {x.shape[dim] - 1} "
                f"input positions do not split over seq={sp}")
        c = self.mesh.index("seq")
        return x[(slice(None),) * dim + (slice(c * n, (c + 1) * n + 1),)]


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


_PIECE_OPTIMIZERS = (torch.optim.Adam, torch.optim.AdamW, torch.optim.SGD)


def _check_piece_optimizer(opt: torch.optim.Optimizer) -> None:
    """An optimizer over fsdp pieces must update each element from its
    own gradient and moments alone: torch's Adam, AdamW and SGD do. The
    port's chain optimizers (int8_adam's blocks, agd, wsam) are not
    placed over pieces yet."""
    if not isinstance(opt, _PIECE_OPTIMIZERS):
        raise NotImplementedError(
            f"{type(opt).__name__} over fsdp pieces: only torch Adam, "
            "AdamW and SGD are placed over sharded state; int8_adam / agd "
            "/ wsam over pieces wait for ROADMAP queue 1 item 13")


def _layout_of(state: TrainState) -> Dict[str, Any]:
    """The state's placement as plain values: its ShardPlan's, or every
    leaf whole where it has none."""
    plan = state.get("layout")
    if plan is not None:
        return plan.describe()
    shapes = {p: tuple(x.shape) for p, x in sharding.flat_leaves(
        state["params"]) if torch.is_tensor(x)}
    return {"n": 1, "index": 0, "dims": {p: None for p in shapes},
            "shapes": shapes}


def _opt_entries(opt, path_of) -> Dict[str, List]:
    """{param path: [(state key, is tensor, (shape, dtype, on host) or
    the value)]} of the optimizer's state."""
    out = {}
    for g in opt.param_groups:
        for p in g["params"]:
            out[path_of[id(p)]] = [
                (k, True, (tuple(v.shape), v.dtype, v.device.type == "cpu"))
                if torch.is_tensor(v) else (k, False, v)
                for k, v in sorted(opt.state.get(p, {}).items())]
    return out


def sync_state(state: TrainState, group,
               plan: Optional[sharding.ShardPlan] = None) -> TrainState:
    """Make the live state the same on every rank of `group`, laid out
    by `plan` (default: the state's own layout): the state of the rank
    furthest along (`_source_rank`'s choice), in each rank's tensors.
    Where no rank holds pieces and `plan` cuts none, that is
    `broadcast_state`; otherwise `_reshard`. Returns `state`."""
    import torch.distributed as dist

    plan = plan if plan is not None else state.get("layout")
    info = {"step": int(state["step"]), "layout": _layout_of(state)}
    infos = [None] * dist.get_world_size(group)
    dist.all_gather_object(infos, info, group=group)
    if not any(i["layout"]["n"] > 1 and any(
            d is not None for d in i["layout"]["dims"].values())
            for i in infos) and not (plan is not None and plan.sharded):
        broadcast_state(state, group)
    else:
        _reshard(state, infos, plan, group)
    if plan is not None:
        state["layout"] = plan
    return state


def _reshard(state: TrainState, infos: List[Dict], plan, group) -> None:
    """`sync_state` for sharded layouts. The source is the layout of the
    lowest rank at the highest step; a holder of each of its pieces is
    the first rank at that step with that layout and piece. Where a
    piece has no live holder (its rank died), RuntimeError naming the
    leaves: restore those from the flash checkpoint. Where the layout
    stays and each piece's holder keeps its index, each rank takes its
    piece from its holder over the ranks sharing that piece (none move
    in a world of pieces alone); otherwise every leaf is assembled whole
    from the holders' pieces, one leaf at a time, and this rank's new
    piece cut from it. Whole leaves come from the source rank. The
    optimizer's state follows its param (an entry of the piece's shape
    is cut with it), entries made where this rank lacks them and
    dropped where the source lacks them; `step`, the optimizer's count
    and the loss scale are the source's."""
    import torch.distributed as dist

    me = dist.get_rank(group)
    max_step = max(i["step"] for i in infos)
    cands = [r for r, i in enumerate(infos) if i["step"] == max_step]
    src_layout = infos[cands[0]]["layout"]

    def same(lay):
        return lay["n"] == src_layout["n"] and lay["dims"] == src_layout["dims"]

    holders = {}
    for r in cands:
        lay = infos[r]["layout"]
        if same(lay):
            holders.setdefault(lay["index"], r)
    n_old, dims_old = src_layout["n"], src_layout["dims"]
    split = sorted(p for p, d in dims_old.items() if d is not None)
    missing = [f for f in range(n_old) if f not in holders]
    if missing and n_old > 1 and split:
        raise RuntimeError(
            f"pieces {missing} of {n_old} of the sharded state have no "
            f"live holder at step {max_step} (their ranks left): leaves "
            f"{split} cannot be re-cut; restore them from the flash "
            "checkpoint")
    primary = cands[0]
    new_index = {r: rank_coords(plan.mesh.spec, r)["fsdp"]
                 for r in range(len(infos))}
    fast = (plan.n == n_old and {p: plan.dim(p) for p in dims_old}
            == {p: (d if n_old > 1 else None) for p, d in dims_old.items()}
            and all(new_index[r] == f for f, r in holders.items()))
    replica = plan.mesh.group("replica")

    def bcast(t, src, g):
        if g is None:
            return t
        wire = wire_tensor(t, g)
        dist.broadcast(wire, src=src, group=g)
        if wire is not t:
            t.copy_(wire)
        return t

    def fetch(path, cur, piece_shape, dtype, device, cut):
        """This rank's tensor of a leaf (or a moment) `path` lays out:
        `cut` True where it is split like the param."""
        def mine(src, shape):
            # the source sends its own tensor; the others receive
            if me == src and cur is not None and tuple(cur.shape) == shape:
                return cur.detach()
            return torch.empty(shape, dtype=dtype, device=device)

        d = dims_old.get(path) if n_old > 1 else None
        if not cut or d is None:
            shape = tuple(src_layout["shapes"][path]) if cut else piece_shape
            t = bcast(mine(primary, shape), primary, group)
            return plan.cut(path, t) if cut else t
        if fast:
            f = plan.index
            return bcast(mine(holders[f], piece_shape), holders[f], replica)
        parts = [bcast(mine(holders[f], piece_shape), holders[f], group)
                 for f in range(n_old)]
        whole = torch.cat(parts, d)
        del parts
        return plan.cut(path, whole)

    params = dict(sharding.flat_leaves(state["params"]))
    opt = state["opt_state"]
    path_of = {id(t): p for p, t in params.items() if torch.is_tensor(t)}
    # the source's optimizer layout and counts, from the source rank
    meta = [_opt_entries(opt, path_of), getattr(opt, "count", None)]
    dist.broadcast_object_list(meta, src=primary, group=group)
    entries, count = meta
    with torch.no_grad():
        for path in sorted(params):
            p = params[path]
            if not torch.is_tensor(p):
                continue
            old_piece = list(src_layout["shapes"][path])
            if n_old > 1 and dims_old[path] is not None:
                old_piece[dims_old[path]] //= n_old
            new = fetch(path, p, tuple(old_piece), p.dtype, p.device, True)
            if new.data_ptr() != p.data_ptr():
                if tuple(new.shape) == tuple(p.shape):
                    p.copy_(new)
                else:
                    p.data = new
            del new
            if path not in entries:
                continue
            st = opt.state[p] if entries[path] else opt.state.pop(p, {})
            for k in set(st) - {k for k, _, _ in entries[path]}:
                del st[k]
            for k, is_tensor, v in entries[path]:
                if not is_tensor:
                    st[k] = v
                    continue
                shape, dtype, on_host = v
                dev = torch.device("cpu") if on_host else p.device
                with_param = tuple(shape) == tuple(old_piece)
                st[k] = fetch(path, st.get(k), tuple(shape), dtype, dev,
                              with_param)
    ls = state.get("loss_scale")
    if ls is not None:
        for t in (ls.scale, ls.good_steps):
            bcast(t, primary, group)
    state["step"] = max_step
    if count is not None:
        opt.count = count


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
    rules=None,
) -> Accelerated:
    """Build the training program on this process's device, over the
    strategy's mesh of the world where there is one.

    init_params(generator) -> params tree (drawn on the device; every
    rank draws from a generator of the same seed)
    loss_fn(params, batch) -> (loss, metrics)
    optimizer(list of param leaves) -> torch.optim.Optimizer
    rules: JAX's partition rules, (path regex, PartitionSpec) pairs
    (`llama.partition_rules(cfg)`); they place the state where the
    mesh has fsdp > 1 (none: every leaf whole)
    """
    strategy = strategy or Strategy()
    device = resolve_device(strategy.device)
    policy = amp.get_policy(strategy.precision)
    group = default_group()
    rank, world, mesh = 0, 1, None
    if group is not None:
        import torch.distributed as dist

        rank, world = dist.get_rank(group), dist.get_world_size(group)
        mesh = (strategy.mesh or MeshSpec(data=world)).build(group)
    elif strategy.mesh is not None:
        strategy.mesh.check_world(1)
    rules = tuple(rules or ())
    acc = Accelerated(device=device, strategy=strategy, init=None,
                      train_step=None, group=group, rank=rank,
                      world_size=world, mesh=mesh, rules=rules)

    def _loss_body(params, batch):
        return loss_fn(policy.cast_to_compute(params), batch)

    if strategy.remat != "none":
        _loss_body = remat.apply_remat(
            _loss_body, strategy.remat, strategy.remat_save_names
        )

    def _init(generator: torch.Generator) -> TrainState:
        params = init_params(generator)
        plan = None
        if mesh is not None:
            plan = sharding.ShardPlan.for_tree(mesh, rules, params)
            if plan.sharded:
                params = plan.cut_tree(params)
        leaves = param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        opt = make_optimizer(optimizer, params)
        if plan is not None and plan.sharded:
            _check_piece_optimizer(opt)
        state = {"params": params, "opt_state": opt, "step": 0}
        if strategy.loss_scale:
            state["loss_scale"] = amp.init_loss_scale(device=device)
        if mesh is not None:
            state["layout"] = plan
        if group is not None:
            sync_state(state, group)
        acc.plan = plan
        return state

    def _scope(state, seq: bool = True):
        """The step's StepScope (None where nothing is cut: the data
        step as it always was)."""
        plan = state.get("layout")
        if mesh is None or not ((plan is not None and plan.sharded)
                                or mesh.size("seq") > 1):
            return None
        return sharding.StepScope(mesh, plan, seq)

    def _grads(params, batch, ls=None, scope=None):
        """One microbatch's loss, metrics and gradients. In a step scope
        the backward runs on the loss times the microbatch's loss weight,
        so every gradient comes out weighted (see `_weighted_grads`)."""
        with sharding.step_scope(scope):
            loss, metrics = _loss_body(params, batch)
            scaled = loss
            if scope is not None:
                if scope.seq and not scope.seq_used:
                    raise ValueError(
                        f"the mesh cuts the sequence over seq="
                        f"{mesh.size('seq')} ranks, but the loss ran no "
                        "sequence-parallel attention (parallel/sequence.py; "
                        "LlamaConfig.seq_parallel)")
                w = metrics.get("loss_weight")
                w = (torch.ones((), device=loss.device) if w is None
                     else w.detach().float())
                # under seq the other ranks' losses reach this rank's
                # activations through the attention's collectives, and
                # under fsdp the pieces' gradients are summed over the
                # group in the backward: each loss is weighted before it
                scaled = loss * w
            if ls is not None:
                scaled = amp.scale_loss(scaled, ls)
            grads = torch.autograd.grad(
                scaled, param_leaves(params), allow_unused=True,
                materialize_grads=True,
            )
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def _split_of(state) -> List[bool]:
        """Per param leaf (flatten order): is it a piece?"""
        plan = state.get("layout")
        if plan is None or not plan.sharded:
            return [False] * len(param_leaves(state["params"]))
        return [plan.dim(p) is not None for p, x in
                sharding.flat_leaves(state["params"])
                if isinstance(x, torch.Tensor) and x.is_floating_point()]

    def _weighted_grads(params, batch, ls, scope, split):
        """The microbatches' gradients weighted by their valid-token
        count (metrics["loss_weight"] where the loss provides one, else
        uniform), so a masked loss matches the single big-batch step:
        the sums G = sum w*g, W = sum w and L = sum w*loss (in a step
        scope the backward runs on w*loss, so g comes out weighted). The
        whole leaves' sums, W and L go in one flat f32 buffer, SUM-reduced
        over the world where there is one (one all-reduce); the pieces'
        sums (already summed over the fsdp group by the gathers'
        backward) in another, SUM-reduced over the ranks holding the
        same piece. Then G/W and L/W. Over one rank the reduction is a
        copy, so a world of one gives the one-process step's bits."""
        leaves = param_leaves(params)
        whole = [p for p, sp in zip(leaves, split) if not sp]
        pieces = [p for p, sp in zip(leaves, split) if sp]
        flat, wviews = _flat_grads(whole, device)
        pflat, pviews = _flat_grads(pieces, device)
        it_w, it_p = iter(wviews), iter(pviews)
        views = [next(it_p) if sp else next(it_w) for sp in split]
        accum = strategy.grad_accum
        mbs = ([tree_map(lambda x, i=i: x[i], batch) for i in range(accum)]
               if accum > 1 else [batch])
        weighted = scope is not None
        loss_sum, w_sum, metrics = 0.0, 0.0, {}
        for k, mb in enumerate(mbs):
            loss, metrics, g = _grads(params, mb, ls, scope)
            w = metrics.get("loss_weight")
            w = torch.ones((), device=loss.device) if w is None else w
            w = w.float()
            for v, gi in zip(views, g):
                gw = gi if weighted else gi * w
                if k == 0:
                    v.copy_(gw)
                else:
                    v.add_(gw)
            loss_sum = loss_sum + loss * w
            w_sum = w_sum + w
            del g
        flat[-2] = w_sum
        flat[-1] = loss_sum
        if group is not None:
            import torch.distributed as dist

            dist.all_reduce(flat, group=group)
            if pieces and mesh.group("replica") is not None:
                dist.all_reduce(pflat[:-2], group=mesh.group("replica"))
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

    def _norm(grads, split) -> torch.Tensor:
        """The global norm, each piece counted once: the pieces' sums of
        squares all-reduced over the fsdp group."""
        if not any(split):
            return global_norm(grads)
        import torch.distributed as dist

        sq = sum(g.float().pow(2).sum() for g, sp in zip(grads, split) if sp)
        dist.all_reduce(sq, group=mesh.group("fsdp"))
        rest = [g for g, sp in zip(grads, split) if not sp]
        if rest:
            sq = sq + sum(g.float().pow(2).sum() for g in rest)
        return torch.sqrt(sq)

    def _train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = state["params"]
        ls = state.get("loss_scale") if strategy.loss_scale else None
        if group is None and strategy.grad_accum == 1:
            # one process, one batch: the plain gradients
            loss, metrics, grads = _grads(params, batch, ls)
            metrics = dict(metrics, loss=loss)
            split = [False] * len(grads)
        else:
            split = _split_of(state)
            grads, metrics = _weighted_grads(params, batch, ls,
                                             _scope(state), split)
        if ls is not None:
            grads = amp.unscale_grads(list(grads), ls)

        metrics["grad_norm"] = _norm(grads, split)
        finite = amp.all_finite(grads) if ls is not None else None
        if finite is not None and any(split):
            import torch.distributed as dist

            # the pieces differ by rank: every rank skips the same step
            bad = (~finite).float().reshape(1)
            dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=group)
            finite = bad[0] == 0
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
        # eval sees whole rows (`place_batch(shard=False)`): pieces are
        # gathered, the sequence is not cut
        with torch.no_grad(), sharding.step_scope(_scope(state, seq=False)):
            _, metrics = _loss_body(state["params"], batch)
        return metrics

    acc.init = _init
    acc.train_step = _train_step
    acc.eval_step = _eval_step
    return acc
