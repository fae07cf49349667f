"""Serving placement of a param tree over a `ServingMesh` — the part of
dlrover_tpu/parallel/sharding.py (`shard_tree` :93, `replicated` :110)
that tensor-parallel serving needs.

JAX places every leaf with a NamedSharding and GSPMD keeps the pieces.
Here a leaf that a rule splits becomes a `Sharded`: one piece per shard,
each on its shard's device (on a colocated mesh, views of the one stored
tensor; across devices, contiguous copies, the unsplit tensor dropped);
every other leaf is replicated, held once on the mesh's home device,
where the program after the attention runs. The rules are
JAX's: `serving/engine.py`'s `_SERVING_PARAM_RULES` (wq/wk/wv split on
their output columns) and `parallel/mesh.serving_weight_quant_specs`
(their int8 q8 / s8 on the output axis). The rest of JAX's sharding
module (FSDP rules, training constraints) waits for ROADMAP queue 1
item 13.
"""

import re
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

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


def shard_tree(tree, mesh: Optional[ServingMesh], rules: Rules):
    """A nested-dict tree placed over `mesh` by `rules`: a leaf whose
    path (a QuantizedWeight's as `<path>/q8`) matches a split rule
    becomes a `Sharded`, every other leaf is replicated on `mesh.home`
    (`replicated`). A Sharded input is gathered first, so the same call
    re-places a tree at another tp. `mesh=None` gathers every Sharded
    leaf back to one device (the tp=1 tree)."""
    if isinstance(tree, dict):
        return {k: _shard_node(v, k, mesh, rules) for k, v in tree.items()}
    return _shard_node(tree, "", mesh, rules)


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
