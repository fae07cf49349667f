"""The parallel layout of a training job — counterpart of
dlrover_tpu/parallel/mesh.py (`MeshSpec` :36, `local_mesh_spec` :235).

In JAX a `MeshSpec` builds one `jax.sharding.Mesh` over every process's
devices, and GSPMD places the state and inserts the collectives. The
port runs one process a card (or a CPU under DLROVER_TPU_FORCE_CPU=1)
in a `torch.distributed` world, with the train state whole on every
rank: the `data` axis is the world, and `check_world` holds a spec to
it. The other axes shard state or compute, which the port's replicated
state does not do yet: `fsdp` (sharded state, ROADMAP queue 1 item 13)
and `tensor`, `seq`, `expert` and `pipe` (item 13, and item 11 (i) for
serving) above 1 raise NotImplementedError. The serving helpers
(`serving_mesh_spec` and the rest) wait for item 11 (i).
"""

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

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
    "tensor": "queue 1 item 13 (training) and item 11 (i) (serving)",
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
