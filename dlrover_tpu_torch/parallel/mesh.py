"""The parallel layouts — counterpart of dlrover_tpu/parallel/mesh.py:
a training job's (`MeshSpec` :36, `local_mesh_spec` :235) and a serving
replica's tensor slice (`serving_mesh_spec` :252 and the helpers after
it).

In JAX a `MeshSpec` builds one `jax.sharding.Mesh` over every process's
devices, and GSPMD places the state and inserts the collectives. The
port runs one process a card (or a CPU under DLROVER_TPU_FORCE_CPU=1)
in a `torch.distributed` world, with the train state whole on every
rank: the `data` axis is the world, and `check_world` holds a spec to
it. The other axes shard state or compute, which the port's replicated
state does not do yet: `fsdp` (sharded state, ROADMAP queue 1 item 13)
and `tensor`, `seq`, `expert` and `pipe` (item 13) above 1 raise
NotImplementedError in a training world.

A serving replica is one controller over a list of devices, as JAX's
1-D ("tp",) mesh is: `ServingMesh` holds `tp` and the ordered devices,
shard i living on devices[i]. Only the attention's head axis splits
(wq/wk/wv columns, the KV banks' KV-head axis, the adapters' B
columns); a head-sharded tensor is a list of per-shard tensors (the
models keep them as `parallel/sharding.Sharded`), and everything
replicated lives once on `home` (devices[0]), where the program after
the attention runs. `PartitionSpec` here is a plain tuple naming the
split axis, the port's form of JAX's layout records.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from dlrover_tpu_torch._device import DeviceLike, local_devices

AXIS_ORDER: Tuple[str, ...] = (
    "pipe",
    "data",
    "fsdp",
    "expert",
    "seq",
    "tensor",
)

# Axes over which the global batch is split.
BATCH_AXES: Tuple[str, ...] = ("data", "fsdp")

# the item of ROADMAP queue 1 each axis the port does not take waits for
_NOT_PORTED = {
    "fsdp": "queue 1 item 13 (sharded state: ZeRO / FSDP)",
    "tensor": "queue 1 item 13 (training; serving slices are ServingMesh)",
    "seq": "queue 1 item 13",
    "expert": "queue 1 item 13",
    "pipe": "queue 1 item 13",
}


@dataclass(frozen=True)
class MeshSpec:
    """Declarative parallelism layout. Sizes multiply to the device
    count; any axis may be 1 (present but inert)."""

    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1
    pipe: int = 1

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return {
            "pipe": self.pipe,
            "data": self.data,
            "fsdp": self.fsdp,
            "expert": self.expert,
            "seq": self.seq,
            "tensor": self.tensor,
        }

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.axis_sizes.values():
            n *= s
        return n

    @property
    def batch_shards(self) -> int:
        return self.data * self.fsdp

    def with_updates(self, **kw) -> "MeshSpec":
        cur = {
            "data": self.data,
            "fsdp": self.fsdp,
            "tensor": self.tensor,
            "seq": self.seq,
            "expert": self.expert,
            "pipe": self.pipe,
        }
        cur.update(kw)
        return MeshSpec(**cur)

    @classmethod
    def fit(
        cls,
        n_devices: int,
        tensor: int = 1,
        seq: int = 1,
        expert: int = 1,
        pipe: int = 1,
        data: int = 1,
    ) -> "MeshSpec":
        """Fill the fsdp axis with whatever devices remain (JAX's
        default strategy)."""
        used = tensor * seq * expert * pipe * data
        if n_devices % used:
            raise ValueError(
                f"{n_devices} devices not divisible by {used} "
                f"(tensor*seq*expert*pipe*data)"
            )
        return cls(
            data=data,
            fsdp=n_devices // used,
            tensor=tensor,
            seq=seq,
            expert=expert,
            pipe=pipe,
        )

    def check_world(self, world_size: int) -> "MeshSpec":
        """The counterpart of JAX's `build`: one card (or CPU) a process,
        the state whole on each, so every axis but `data` must be 1 and
        `data` must equal the world size. Returns the spec."""
        for axis, item in _NOT_PORTED.items():
            if self.axis_sizes[axis] > 1:
                raise NotImplementedError(
                    f"MeshSpec {axis}={self.axis_sizes[axis]}: the port "
                    f"keeps the whole train state on every rank; the "
                    f"{axis} axis waits for ROADMAP {item}"
                )
        if self.data != world_size:
            raise ValueError(
                f"MeshSpec data={self.data} needs a world of {self.data} "
                f"processes (one card each), this world has {world_size}"
            )
        return self


def local_mesh_spec(n_devices: Optional[int] = None) -> MeshSpec:
    """JAX's default mesh over `n_devices` (default: this process's one
    device): all of them on the fsdp axis."""
    return MeshSpec.fit(1 if n_devices is None else n_devices)


# --------------------------------------------------------------------------
# Serving replica slices: a replica is a 1-D tensor slice of the LOCAL
# devices (heartbeats count chips = replicas x slice size). Serving code
# builds its slices through these helpers, as JAX's does.

SERVING_TP_AXIS = "tp"


class PartitionSpec(tuple):
    """JAX's PartitionSpec as a plain tuple: entry d names the mesh axis
    dim d splits over, None keeps it whole. `PartitionSpec()` is
    replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def split_dim(self) -> Optional[int]:
        """The dim split over "tp", or None when replicated."""
        for d, ax in enumerate(self):
            if ax == SERVING_TP_AXIS:
                return d
        return None


class ServingMesh:
    """A serving replica's ("tp",) slice: one controller over `devices`,
    shard i on devices[i]. On one card under
    DLROVER_TPU_TORCH_FORCE_DEVICE_COUNT the devices repeat (virtual
    shards): every per-shard piece then lives on that card and the
    moves below are no-ops. On several cards shard i runs on card i;
    the layer input reaches each card by `broadcast` and the attention
    output comes back to `home` by `gather`."""

    axis_names = (SERVING_TP_AXIS,)

    def __init__(self, devices: Sequence[torch.device]):
        if not devices:
            raise ValueError("a serving mesh needs at least one device")
        self.devices: List[torch.device] = list(devices)

    @property
    def tp(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """Where the replicated program (wo, MLP, logits) runs."""
        return self.devices[0]

    @property
    def colocated(self) -> bool:
        """True when every shard lives on one device (virtual shards on
        one card or the CPU)."""
        return len(set(self.devices)) == 1

    def split(self, t: torch.Tensor, dim: int) -> List[torch.Tensor]:
        """`t` cut into tp equal contiguous pieces along `dim`, piece i
        on devices[i]."""
        if t.shape[dim] % self.tp:
            raise ValueError(
                f"dim {dim} of {tuple(t.shape)} does not split over "
                f"tp={self.tp}")
        return [p.to(d).contiguous()
                for p, d in zip(torch.chunk(t, self.tp, dim), self.devices)]

    def shards(self, x, dim: int) -> List[torch.Tensor]:
        """`x` as per-shard pieces: a per-shard list as it is, a global
        tensor `split` along `dim`."""
        if not isinstance(x, (list, tuple)):
            return self.split(x, dim)
        if len(x) != self.tp:
            raise ValueError(f"{len(x)} shards for a tp={self.tp} mesh")
        return list(x)

    def split_pool(self, pool, dim: int) -> List[Dict[str, torch.Tensor]]:
        """A pool dict (k, v and any scales) as per-shard dicts: a
        per-shard list as it is, a global dict's arrays `split` along
        `dim`."""
        if isinstance(pool, (list, tuple)):
            return self.shards(pool, dim)
        cut = {name: self.split(t, dim) for name, t in pool.items()}
        return [{name: cut[name][i] for name in pool}
                for i in range(self.tp)]

    def gather(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """The per-shard pieces concatenated along `dim` on `home`."""
        return torch.cat([p.to(self.home) for p in parts], dim)

    def broadcast(self, t: torch.Tensor) -> List[torch.Tensor]:
        """`t` on every shard's device: one copy per distinct device (the
        same tensor where shards share a device)."""
        copies: Dict[torch.device, torch.Tensor] = {}
        out = []
        for d in self.devices:
            if d not in copies:
                copies[d] = t.to(d)
            out.append(copies[d])
        return out

    def __repr__(self) -> str:
        return f"ServingMesh(tp={self.tp}, devices={self.devices})"


def serving_mesh_spec(
    tp: int = 1,
    n_kv_heads: Optional[int] = None,
    n_devices: Optional[int] = None,
) -> MeshSpec:
    """Validated spec of a serving replica: a pure tensor slice
    (``MeshSpec(tensor=tp)``) of the local devices. Raises ValueError
    when the host has fewer devices than the slice or when `n_kv_heads`
    (if given) does not divide over `tp` (the KV banks shard the head
    axis). `n_devices` defaults to the card's `local_devices()`."""
    if n_devices is None:
        n_devices = len(local_devices())
    if tp < 1:
        raise ValueError(f"serving mesh tp must be >= 1, got {tp}")
    if tp > n_devices:
        raise ValueError(
            f"serving mesh needs tp={tp} local devices, host has only "
            f"{n_devices} — shrink mesh_spec or run on a larger slice"
        )
    if n_kv_heads is not None and n_kv_heads % tp != 0:
        raise ValueError(
            f"n_kv_heads={n_kv_heads} is not divisible by tp={tp}: the "
            f"KV cache shards the head axis, so tp must divide the KV "
            f"head count — use tp in "
            f"{[t for t in range(1, n_kv_heads + 1) if n_kv_heads % t == 0]}"
        )
    return MeshSpec(tensor=tp)


def serving_mesh(
    tp: int = 1,
    devices: Optional[Sequence[torch.device]] = None,
    n_kv_heads: Optional[int] = None,
    device: DeviceLike = None,
) -> ServingMesh:
    """The ("tp",) slice over the first `tp` of `devices` (default:
    `local_devices(device)`, the card's), validated by
    `serving_mesh_spec`."""
    if devices is None:
        devices = local_devices(device)
    serving_mesh_spec(tp, n_kv_heads=n_kv_heads, n_devices=len(devices))
    return ServingMesh(list(devices)[:tp])


def serving_kv_spec() -> PartitionSpec:
    """The serving KV banks' layout: dense slot bank
    [L, slots, cells, KV, hd], page pool [L, pages, page_size, KV, hd]
    and prefix pool all split the KV head axis (dim 3); int8 scales
    share it with hd == 1. Rows and cells are host-planned and stay
    whole on every shard."""
    return PartitionSpec(None, None, None, SERVING_TP_AXIS)


def serving_mesh_tp(mesh: Optional[ServingMesh]) -> int:
    """Size of the serving "tp" axis (1 without a mesh): the ops
    wrappers and models/decode.py key their dispatch on it."""
    if mesh is None:
        return 1
    return dict(zip(mesh.axis_names, (mesh.tp,))).get(SERVING_TP_AXIS, 1)


def _check_serving_axis(mesh, what: str) -> None:
    if SERVING_TP_AXIS not in getattr(mesh, "axis_names", ()):
        raise ValueError(
            f"{what} needs a mesh with a {SERVING_TP_AXIS!r} axis "
            f"(serving_mesh builds one); got axes "
            f"{getattr(mesh, 'axis_names', None)}"
        )


def serving_head_specs(mesh: ServingMesh) -> Dict[str, PartitionSpec]:
    """The per-shard layouts of the sharded attention sites, the ONE
    source the ops wrappers read: "qkv" (prefill activations
    [B, S, H, D], heads at dim 2), "q1" (the decode query [B, H, hd],
    heads at dim 1), "pool" (one layer's page pool [pages, page_size,
    KV, hd], KV heads at dim 2) and "replicated" (page tables and
    lengths, whole on every shard). Attention is per head, so no
    collective runs inside; the gather before the out-projection stays
    with models/decode.py."""
    _check_serving_axis(mesh, "serving_head_specs")
    ax = SERVING_TP_AXIS
    return {
        "qkv": PartitionSpec(None, None, ax, None),
        "q1": PartitionSpec(None, ax, None),
        "pool": PartitionSpec(None, None, ax, None),
        "replicated": PartitionSpec(),
    }


def serving_adapter_specs(mesh: ServingMesh) -> Dict[str, PartitionSpec]:
    """The stacked adapter bank's layout (serving/adapters.py: `t_a`
    [L, S, in, r], `t_b` [L, S, r, out], `scale` [S]): wq/wk/wv's B
    banks split their output columns as the base projections do, so
    each shard's delta lands on its own columns; the A banks, the wo
    pair and the scales are replicated."""
    _check_serving_axis(mesh, "serving_adapter_specs")
    col = PartitionSpec(None, None, None, SERVING_TP_AXIS)
    rep = PartitionSpec()
    return {
        "wq_b": col, "wk_b": col, "wv_b": col,
        "wq_a": rep, "wk_a": rep, "wv_a": rep,
        "wo_a": rep, "wo_b": rep,
        "scale": rep,
    }


def serving_weight_quant_specs() -> Tuple[Tuple[str, PartitionSpec], ...]:
    """(path regex, PartitionSpec) rules of the int8 serving tree:
    quantized weights are output-major ([L, O, K] q8, [L, O, K/block]
    s8), so wq/wk/wv's column split lands on axis 1, scales with their
    blocks: a shard boundary never cuts a quant block, and a resize
    re-places q8 + s8 at any tp without requantizing."""
    col = PartitionSpec(None, SERVING_TP_AXIS, None)
    return (
        (r"layers/wq/(q8|s8)$", col),
        (r"layers/wk/(q8|s8)$", col),
        (r"layers/wv/(q8|s8)$", col),
    )


def largest_serving_tp(
    n_chips: int,
    n_kv_heads: Optional[int] = None,
    n_devices: Optional[int] = None,
) -> int:
    """The largest tp a shrunk or grown replica can re-form at: the
    biggest t <= n_chips that divides `n_kv_heads` and fits the local
    devices (`n_devices`, default the card's `local_devices()`). The one
    resize policy of serving/elastic.py. Always >= 1."""
    if n_devices is None:
        n_devices = len(local_devices())
    cap = max(1, min(int(n_chips), int(n_devices)))
    for t in range(cap, 0, -1):
        if n_kv_heads is None or n_kv_heads % t == 0:
            return t
    return 1
