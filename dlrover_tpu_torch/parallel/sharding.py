"""Partition rules and placement — counterpart of
dlrover_tpu/parallel/sharding.py, both halves.

Serving: a param tree over a `ServingMesh` (`shard_tree` :93,
`replicated` :110). JAX places every leaf with a NamedSharding and
GSPMD keeps the pieces. Here a leaf that a rule splits becomes a
`Sharded`: one piece per shard, each on its shard's device (on a
colocated mesh, views of the one stored tensor; across devices,
contiguous copies, the unsplit tensor dropped); every other leaf is
replicated, held once on the mesh's home device, where the program
after the attention runs. The rules are JAX's: `serving/engine.py`'s
`_SERVING_PARAM_RULES` (wq/wk/wv split on their output columns) and
`parallel/mesh.serving_weight_quant_specs` (their int8 q8 / s8 on the
output axis).

Training: the rules over a `TrainMesh` (`path_str` :19,
`spec_for_path` :34, `tree_specs` :42, `_filter_spec` :49,
`tree_shardings` :79, `constrain` :101; JAX's `replicated` :110 is
the spec every unmatched leaf takes, `PartitionSpec()`) and the fsdp
pieces of a train state, ZeRO-3 style. `ShardPlan` says where each
leaf lives: a leaf whose filtered spec names "fsdp" on dim d is stored
as this rank's piece (slice `fsdp index` of dim d in equal parts, the
slice JAX's device at these coordinates holds), every other leaf whole.
While a train step runs, `step_scope` makes the plan visible to the
model, which gathers each piece just before its use (`gathered`,
`gathered_layer`): an autograd Function whose forward all-gathers
along d over the fsdp group and whose backward reduce-scatters the
gradient back onto the piece. Under `remat` the recompute gathers
again. `constrain` is a no-op on eager tensors: the models keep its
calls where JAX's have them.
"""

import contextlib
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_flatten_with_path, tree_map_with_path

from dlrover_tpu_torch.ops.quantization import QuantizedWeight
from dlrover_tpu_torch.parallel.mesh import PartitionSpec, ServingMesh

Rules = Sequence[Tuple[str, PartitionSpec]]


class Sharded:
    """A head-sharded leaf: `shards[i]` lives on shard i's device and
    holds its part of dim `dim` (a QuantizedWeight's q8 and s8 split
    together on that dim). Indexing the leading (layer) dim slices every
    piece, as a stacked leaf is sliced.

    Where every shard lives on one device (virtual shards on one card,
    or the CPU), the pieces are views of one tensor, `whole`: the leaf's
    bytes are stored once, and the shards of that device take their
    products over their adjacent columns in one call on `whole`
    (models/decode.py). Each output column depends on its own weight
    column only, so that IS the per-shard product, and it keeps the
    bits of the unsharded product, which a narrower matmul need not (on
    the card cuBLAS picks another split of the contraction for fewer
    columns). Without `whole`, each piece is its own tensor on its own
    device."""

    __slots__ = ("shards", "dim", "whole", "_slices")

    def __init__(self, shards: Sequence[Any], dim: int, whole=None):
        self.shards = list(shards)
        self.dim = int(dim)
        self.whole = whole
        self._slices = {}

    def __getitem__(self, idx) -> "Sharded":
        """One layer: an int drops the leading dim (the same object every
        time, as QuantizedWeight's layer slices are)."""
        if type(idx) is not int:
            raise TypeError("a Sharded leaf indexes one layer at a time")
        out = self._slices.get(idx)
        if out is None:
            out = Sharded([s[idx] for s in self.shards], self.dim - 1,
                          None if self.whole is None else self.whole[idx])
            self._slices[idx] = out
        return out

    def map(self, fn: Callable[[Any], Any]) -> "Sharded":
        """`fn` on every piece (on `whole` once, the pieces its views)."""
        if self.whole is None:
            return Sharded([fn(s) for s in self.shards], self.dim)
        whole = fn(self.whole)
        if whole is self.whole:
            return self
        return Sharded(_views(whole, self.dim, self.widths()), self.dim,
                       whole)

    def widths(self) -> List[int]:
        """Each piece's extent along the split dim."""
        return [_storage(s).shape[self.dim] for s in self.shards]

    def gather(self, device: Optional[torch.device] = None):
        """The whole leaf on `device` (default: shard 0's)."""
        dev = device or _storage(self.shards[0]).device
        if self.whole is not None:
            return _move(self.whole, dev)
        if isinstance(self.shards[0], QuantizedWeight):
            return QuantizedWeight(
                torch.cat([s.q8.to(dev) for s in self.shards], self.dim),
                torch.cat([s.s8.to(dev) for s in self.shards], self.dim),
                self.shards[0].block,
            )
        return torch.cat([s.to(dev) for s in self.shards], self.dim)

    def nbytes_per_shard(self) -> int:
        """Bytes of shard 0's piece (q8 and s8 for an int8 weight)."""
        s = self.shards[0]
        if isinstance(s, QuantizedWeight):
            return (s.q8.numel() * s.q8.element_size()
                    + s.s8.numel() * s.s8.element_size())
        return s.numel() * s.element_size()

    def __repr__(self) -> str:
        return f"Sharded(tp={len(self.shards)}, dim={self.dim}, {self.shards[0]!r})"


def _storage(leaf) -> torch.Tensor:
    return leaf.q8 if isinstance(leaf, QuantizedWeight) else leaf


def _move(leaf, dev):
    if isinstance(leaf, QuantizedWeight):
        if leaf.q8.device == dev:
            return leaf
        return QuantizedWeight(leaf.q8.to(dev), leaf.s8.to(dev), leaf.block)
    return leaf.to(dev)


def _views(leaf, dim: int, widths: Sequence[int]) -> List[Any]:
    """`leaf` cut along `dim` into views of the given widths."""
    if isinstance(leaf, QuantizedWeight):
        return [QuantizedWeight(q, s, leaf.block) for q, s in zip(
            torch.split(leaf.q8, list(widths), dim),
            torch.split(leaf.s8, list(widths), dim))]
    return list(torch.split(leaf, list(widths), dim))


def split_leaf(leaf, mesh: ServingMesh, dim: int) -> Sharded:
    """`leaf` (a tensor or a QuantizedWeight, whole or Sharded) cut into
    `mesh.tp` equal parts along `dim`, part i on devices[i]: views of the
    one stored tensor where the mesh is colocated, contiguous copies on
    their devices otherwise."""
    if isinstance(leaf, Sharded):
        leaf = leaf.gather()
    if mesh.colocated:
        whole = _move(leaf, mesh.home)
        n = _storage(whole).shape[dim]
        if n % mesh.tp:
            raise ValueError(
                f"dim {dim} of {tuple(_storage(whole).shape)} does not "
                f"split over tp={mesh.tp}")
        return Sharded(_views(whole, dim, [n // mesh.tp] * mesh.tp), dim,
                       whole)
    if isinstance(leaf, QuantizedWeight):
        q8 = mesh.split(leaf.q8, dim)
        s8 = mesh.split(leaf.s8, dim)
        return Sharded([QuantizedWeight(q, s, leaf.block)
                        for q, s in zip(q8, s8)], dim)
    return Sharded(mesh.split(leaf, dim), dim)


def spec_for_path(path: str, rules: Rules) -> PartitionSpec:
    """The first rule whose regex matches `path` (JAX's `spec_for_path`);
    replicated when none does."""
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return PartitionSpec()


def _shard_node(node, path, mesh, rules):
    if isinstance(node, dict):
        return {k: _shard_node(v, f"{path}/{k}", mesh, rules)
                for k, v in node.items()}
    if mesh is None:
        return node.gather() if isinstance(node, Sharded) else node
    probe = f"{path}/q8" if _is_quant(node) else path
    dim = spec_for_path(probe, rules).split_dim()
    if dim is None or mesh.tp == 1:
        return replicated(node, mesh)
    return split_leaf(node, mesh, dim)


def _is_quant(node) -> bool:
    if isinstance(node, Sharded):
        return isinstance(node.shards[0], QuantizedWeight)
    return isinstance(node, QuantizedWeight)


def replicated(leaf, mesh: ServingMesh):
    """A leaf replicated over `mesh`: whole, on `mesh.home` (the one
    device the replicated program runs on)."""
    if isinstance(leaf, Sharded):
        leaf = leaf.gather(mesh.home)
    if isinstance(leaf, QuantizedWeight):
        if leaf.q8.device == mesh.home:
            return leaf
        return QuantizedWeight(leaf.q8.to(mesh.home), leaf.s8.to(mesh.home),
                               leaf.block)
    return leaf.to(mesh.home) if torch.is_tensor(leaf) else leaf


# ---------------------------------------------------------------------------
# Training: the rules over a TrainMesh, and the fsdp pieces of a state


def path_str(path) -> str:
    """A pytree key path -> 'layers/attn/wq' style string (JAX's
    `path_str`)."""
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


def tree_specs(tree: Any, rules: Rules) -> Any:
    """A PartitionSpec tree matching `tree`'s structure."""
    return tree_map_with_path(
        lambda path, _: spec_for_path(path_str(path), rules), tree)


def _axis_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a MeshSpec, a TrainMesh or None (no mesh)."""
    if mesh is None:
        return {}
    return getattr(mesh, "spec", mesh).axis_sizes


def _filter_spec(spec: PartitionSpec, mesh, shape) -> PartitionSpec:
    """Drop axes of size 1 or absent, and dims their axes' product does
    not divide: one rule table holds for every mesh shape (JAX's
    `_filter_spec`)."""
    sizes = _axis_sizes(mesh)
    out = []
    for dim_idx, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        kept = [a for a in axes if sizes.get(a, 1) > 1]
        prod = 1
        for a in kept:
            prod *= sizes[a]
        if (not kept or dim_idx >= len(shape) or prod <= 0
                or shape[dim_idx] % prod != 0):
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def tree_shardings(tree: Any, mesh, rules: Rules) -> Any:
    """The filtered PartitionSpec of every leaf of `tree` under `mesh`
    (JAX's NamedSharding tree: the spec is what the port places by)."""
    return tree_map_with_path(
        lambda path, leaf: _filter_spec(
            spec_for_path(path_str(path), rules), mesh,
            tuple(getattr(leaf, "shape", ()))), tree)


def constrain(x, mesh=None, *spec_entries):
    """JAX's `with_sharding_constraint` wrapper: eager tensors carry no
    layout, so `x` as it is."""
    del mesh, spec_entries
    return x


def fsdp_dim(spec: PartitionSpec) -> Optional[int]:
    """The dim a filtered spec splits over "fsdp", None when it is
    replicated. A training world spans data x fsdp x seq, and the rules
    name fsdp alone of those: any other live axis in a param spec raises
    NotImplementedError (ROADMAP queue 1 item 13)."""
    dim = None
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            if a is None:
                continue
            if a != "fsdp":
                raise NotImplementedError(
                    f"a leaf split over {a!r} ({spec}): training pieces "
                    "split over fsdp only (ROADMAP queue 1 item 13)")
            dim = d
    return dim


def flat_leaves(tree) -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf of `tree`, in its flatten order."""
    leaves, _ = tree_flatten_with_path(tree)
    return [(path_str(p), x) for p, x in leaves]


class ShardPlan:
    """Where each leaf of a param tree lives on a `TrainMesh`: `dims`
    {path: the dim split over fsdp, or None}, `shapes` {path: the
    global shape}. A rank stores slice `index` of dim d in `n` equal
    parts (JAX's device at those coordinates holds the same slice)."""

    def __init__(self, mesh, dims: Dict[str, Optional[int]],
                 shapes: Dict[str, Tuple[int, ...]]):
        self.mesh = mesh
        self.n = mesh.size("fsdp")
        self.index = mesh.index("fsdp")
        self.dims = dict(dims)
        self.shapes = {p: tuple(s) for p, s in shapes.items()}

    @classmethod
    def from_shapes(cls, mesh, rules: Rules,
                    shapes: Dict[str, Tuple[int, ...]]) -> "ShardPlan":
        dims = {p: fsdp_dim(_filter_spec(spec_for_path(p, rules), mesh,
                                         tuple(s)))
                for p, s in shapes.items()}
        return cls(mesh, dims, shapes)

    @classmethod
    def for_tree(cls, mesh, rules: Rules, tree) -> "ShardPlan":
        return cls.from_shapes(mesh, rules, {
            p: tuple(x.shape) for p, x in flat_leaves(tree)
            if torch.is_tensor(x)})

    @property
    def sharded(self) -> bool:
        """True where some leaf is stored as pieces."""
        return self.n > 1 and any(d is not None for d in self.dims.values())

    def dim(self, path: str) -> Optional[int]:
        return self.dims.get(path) if self.n > 1 else None

    def index_of(self, path: str):
        """The slices of the global leaf this rank's piece holds, one
        per dim."""
        shape = self.shapes[path]
        d = self.dim(path)
        ix = [slice(0, n) for n in shape]
        if d is not None:
            w = shape[d] // self.n
            ix[d] = slice(self.index * w, (self.index + 1) * w)
        return tuple(ix)

    def cut(self, path: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a global leaf (a contiguous copy; the
        leaf itself where it is replicated)."""
        if self.dim(path) is None:
            return whole
        return whole[self.index_of(path)].contiguous()

    def cut_tree(self, tree):
        """Every leaf of a global tree as this rank's piece (a new tree:
        the caller drops the global one)."""
        return tree_map_with_path(
            lambda p, x: self.cut(path_str(p), x) if torch.is_tensor(x)
            else x, tree)

    def specs(self) -> Dict[str, PartitionSpec]:
        """{path: the filtered PartitionSpec} (fsdp on the split dim)."""
        out = {}
        for p in self.dims:
            d = self.dim(p)
            out[p] = (PartitionSpec() if d is None else
                      PartitionSpec(*([None] * d + ["fsdp"])))
        return out

    def describe(self) -> Dict[str, Any]:
        """The plan as plain values (it crosses processes by
        all_gather_object)."""
        return {"n": self.n, "index": self.index, "dims": dict(self.dims),
                "shapes": dict(self.shapes)}


def shard_tree(tree, mesh, rules: Rules):
    """A nested-dict tree placed by `rules`: over a `ServingMesh` (or
    None) as serving places it (`Sharded` leaves); over a `TrainMesh`,
    every leaf as this rank's fsdp piece (`ShardPlan.cut_tree`)."""
    if mesh is not None and not isinstance(mesh, ServingMesh):
        return ShardPlan.for_tree(mesh, rules, tree).cut_tree(tree)
    if isinstance(tree, dict):
        return {k: _shard_node(v, k, mesh, rules) for k, v in tree.items()}
    return _shard_node(tree, "", mesh, rules)


class StepScope:
    """What a train step shows the model while it runs: the mesh, the
    plan of its params (None where nothing is split), whether the
    sequence is cut over the seq group (`seq`: False for eval, which
    sees whole rows). `seq_used` records that the model ran sequence-parallel
    attention."""

    def __init__(self, mesh, plan: Optional[ShardPlan], seq: bool):
        self.mesh = mesh
        self.plan = plan if plan is not None and plan.sharded else None
        self.seq = seq and mesh is not None and mesh.size("seq") > 1
        self.seq_used = False


# a module global, not a context variable: the recompute of a
# checkpointed layer and the backward run on autograd's own threads
_SCOPE: Optional[StepScope] = None


@contextlib.contextmanager
def step_scope(scope: Optional[StepScope]):
    """Make `scope` the active one for the forward and backward inside."""
    global _SCOPE
    prev, _SCOPE = _SCOPE, scope
    try:
        yield scope
    finally:
        _SCOPE = prev


def active_scope() -> Optional[StepScope]:
    return _SCOPE


class _GatherPiece(torch.autograd.Function):
    """Forward: the piece (cast to `dtype` first where one is given)
    all-gathered along `dim` over the fsdp group. Backward: the
    gradient in f32, reduce-scattered
    (SUM) back onto the piece in its own dtype."""

    @staticmethod
    def forward(ctx, piece, dim, scope, dtype):
        from dlrover_tpu_torch import runtime

        ctx.dim, ctx.scope, ctx.dtype = dim, scope, piece.dtype
        x = piece.detach()
        if dtype is not None:
            x = x.to(dtype)
        return runtime.all_gather_dim(x, dim, scope.mesh.group("fsdp"))

    @staticmethod
    def backward(ctx, g):
        from dlrover_tpu_torch import runtime

        g = g.float()
        out = runtime.reduce_scatter_dim(g, ctx.dim,
                                         ctx.scope.mesh.group("fsdp"))
        return out.to(ctx.dtype), None, None, None


def gathered(t: torch.Tensor, path: str, stacked: bool = False,
             dtype: Optional[torch.dtype] = None):
    """The whole leaf of `path` for this use: `t` itself outside a train
    step or where the leaf is whole, else its piece all-gathered (the
    gradient reduce-scattered back). `stacked`: `t` is one layer's
    slice of a stacked leaf, so the split dim is one lower. `dtype`: the
    dtype the caller casts the leaf to before any use; the piece is
    cast before the gather (the same values, half the bytes for bf16),
    and its gradient, the cast's gradient, is reduced in f32."""
    scope = _SCOPE
    if scope is None or scope.plan is None:
        return t
    d = scope.plan.dim(path)
    if d is None:
        return t
    if stacked:
        d -= 1
    return _GatherPiece.apply(t, d, scope, dtype)


def gathered_layer(layer_params: Dict[str, Any], prefix: str = "layers",
                   dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """One layer's slices (`llama.layer_slices`) with every piece
    gathered (`gathered`, cast to `dtype`): the whole layer for its use,
    inside the layer body, so a checkpointed layer gathers again in its
    recompute."""
    if _SCOPE is None or _SCOPE.plan is None:
        return layer_params
    return {k: gathered(v, f"{prefix}/{k}", stacked=True, dtype=dtype)
            if torch.is_tensor(v) else v for k, v in layer_params.items()}


class _EmbedPieces(torch.autograd.Function):
    """Rows of a [V, D] table whose pieces split D over the fsdp group,
    looked up without gathering the table (the activation-sized
    exchange JAX's embedding rule keeps, llama.py:206-214): the group's
    tokens are all-gathered, each rank looks all of them up in its
    piece, and an all-to-all returns to each rank its tokens' columns
    from every piece. Backward: the gradient in f32, its columns sent back by the inverse all-to-all, and each
    rank sums the rows of every token into its piece's gradient."""

    @staticmethod
    def forward(ctx, piece, tokens, scope):
        import torch.nn.functional as F

        from dlrover_tpu_torch import runtime

        group = scope.mesh.group("fsdp")
        n = scope.mesh.size("fsdp")
        toks = runtime.all_gather_dim(tokens.contiguous(), 0, group)
        rows = F.embedding(toks, piece.detach())       # [n*B, S, D/n]
        rows = rows.reshape((n,) + tuple(tokens.shape) + (piece.shape[1],))
        got = runtime.all_to_all_dim0(rows, group)     # got[j]: piece j's
        ctx.save_for_backward(toks)
        ctx.scope, ctx.n, ctx.shape = scope, n, tuple(piece.shape)
        ctx.dtype = piece.dtype
        return got.movedim(0, -2).reshape(tuple(tokens.shape)
                                          + (n * piece.shape[1],))

    @staticmethod
    def backward(ctx, g):
        from dlrover_tpu_torch import runtime

        (toks,) = ctx.saved_tensors
        g = g.float()
        n, cols = ctx.n, ctx.shape[1]
        parts = g.reshape(tuple(g.shape[:-1]) + (n, cols)).movedim(-2, 0)
        got = runtime.all_to_all_dim0(parts, ctx.scope.mesh.group("fsdp"))
        grad = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        grad.index_add_(0, toks.reshape(-1), got.reshape(-1, cols))
        return grad.to(ctx.dtype), None, None


def embed_rows(table: torch.Tensor, tokens: torch.Tensor, path: str):
    """`F.embedding(tokens, table)` of the leaf `path`: where a train
    step holds it as fsdp pieces split along D (JAX's embedding rule),
    the rows are exchanged (`_EmbedPieces`) instead of the table;
    otherwise the whole table's (gathered where it is split another
    way)."""
    import torch.nn.functional as F

    scope = _SCOPE
    if scope is not None and scope.plan is not None:
        d = scope.plan.dim(path)
        if d == 1 and table.dim() == 2:
            return _EmbedPieces.apply(table, tokens, scope)
    return F.embedding(tokens, gathered(table, path))
