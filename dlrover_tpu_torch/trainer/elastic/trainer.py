"""ElasticTrainer: a fixed global batch size across world resizes.

Counterpart of dlrover_tpu/trainer/elastic/trainer.py (reference
dlrover/trainer/torch/elastic/trainer.py:48-132). The wrapper owns the
`accelerate()` build and picks (per_replica_batch, grad_accum) from
`elastic_batch_plan` over the mesh's batch shards, so the global batch
stays fixed as ranks come and go. A replica is a rank of the
`torch.distributed` world `runtime.init()` joined (one process a card),
or the one process where there is no world. After the agent restarts
the job into a new world, `on_world_change` rebuilds the plan and the
step for it and broadcasts the live state of the rank furthest along
(rank 0 where all are at one step; never a fresh replacement) into
every rank: the counterpart of JAX re-sharding the state onto the new
mesh.
"""

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._pytree import tree_map

from dlrover_tpu_torch._device import DeviceLike
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.parallel.accelerate import (
    Accelerated,
    OptimizerFactory,
    Strategy,
    accelerate,
    broadcast_state,
    default_group,
)
from dlrover_tpu_torch.parallel.mesh import MeshSpec
from dlrover_tpu_torch.trainer.elastic.data import elastic_batch_plan


class ElasticTrainer:
    """Keeps ``global_batch_size`` fixed by gradient accumulation.

    Usage::

        et = ElasticTrainer(init_params, loss_fn, optimizer,
                            global_batch_size=64,
                            max_per_replica_batch=8)
        state = et.init_state(torch.Generator("cuda").manual_seed(0))
        for batch in loader:          # batch leading dim == 64 always
            state, metrics = et.step(state, batch)
        # after the agent restarted us into a new world (runtime.init):
        state = et.on_world_change(state)
    """

    def __init__(
        self,
        init_params: Callable[[torch.Generator], Any],
        loss_fn: Callable,
        optimizer: OptimizerFactory,
        global_batch_size: int,
        max_per_replica_batch: int,
        device: DeviceLike = None,
        mesh_spec: Optional[MeshSpec] = None,
    ):
        self._init_params = init_params
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self.global_batch_size = global_batch_size
        self.max_per_replica_batch = max_per_replica_batch
        self._device = device
        self._mesh_spec = mesh_spec
        self.acc: Optional[Accelerated] = None
        self.plan: Dict[str, int] = {}
        self._build()

    # -- build -------------------------------------------------------------

    def _current_spec(self) -> MeshSpec:
        """The given spec held to the world (`MeshSpec.check_world`),
        else every rank of the world a data shard (JAX's default,
        `local_mesh_spec`, puts them on fsdp, which the port's
        replicated state does not take: the same batch shards)."""
        group = default_group()
        world = 1
        if group is not None:
            import torch.distributed as dist

            world = dist.get_world_size(group)
        if self._mesh_spec is None:
            return MeshSpec(data=world)
        return self._mesh_spec.check_world(world)

    def _build(self):
        spec = self._current_spec()
        replicas = spec.batch_shards
        self.plan = elastic_batch_plan(
            self.global_batch_size, replicas, self.max_per_replica_batch
        )
        strategy = Strategy(
            device=self._device, grad_accum=self.plan["grad_accum"],
        )
        self.acc = accelerate(
            self._init_params, self._loss_fn, self._optimizer,
            strategy=strategy,
        )
        logger.info(
            "ElasticTrainer: %d replicas, per-replica batch %d, "
            "grad-accum %d (global %d)",
            replicas,
            self.plan["per_replica_batch"],
            self.plan["grad_accum"],
            self.global_batch_size,
        )

    @property
    def grad_accum(self) -> int:
        return self.plan["grad_accum"]

    @property
    def device(self) -> torch.device:
        return self.acc.device

    def init_state(self, generator: torch.Generator) -> Any:
        return self.acc.init(generator)

    # -- stepping ----------------------------------------------------------

    def _fold_microbatches(self, batch):
        """[global, ...] -> [accum, global/accum, ...] when accumulating."""
        accum = self.plan["grad_accum"]
        if accum == 1:
            return batch

        def _fold(x):
            if getattr(x, "ndim", 0) == 0:
                return x
            if x.shape[0] != self.global_batch_size:
                raise ValueError(
                    f"batch dim {x.shape[0]} != global batch "
                    f"{self.global_batch_size}"
                )
            return x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:]))

        return tree_map(_fold, batch)

    def step(self, state: Any, batch: Any) -> Tuple[Any, Dict]:
        batch = self.acc.place_batch(self._fold_microbatches(batch))
        return self.acc.train_step(state, batch)

    def eval_step(self, state: Any, batch: Any) -> Dict:
        return self.acc.eval_step(state,
                                  self.acc.place_batch(batch, shard=False))

    # -- elasticity --------------------------------------------------------

    def on_world_change(
        self, state: Any, mesh_spec: Optional[MeshSpec] = None
    ) -> Any:
        """Rebuild for the world this process is in now (call it after
        `runtime.init()` joined it) and make the live state the same on
        every rank: the plan and the step are built anew, then the
        params, optimizer moments, step and loss scale of the rank at
        the highest step (`broadcast_state`) are broadcast into each
        rank's own tensors. A replacement process that instead builds
        its trainer and calls `init_state` meets this broadcast and
        takes the survivors' state. The optimizer objects stay, so
        nothing is drawn again. Returns the state."""
        if mesh_spec is not None:
            self._mesh_spec = mesh_spec
        self._build()
        if self.acc.group is not None:
            broadcast_state(state, self.acc.group)
        return state
