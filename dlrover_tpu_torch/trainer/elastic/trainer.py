"""ElasticTrainer: a fixed global batch size across world resizes.

Counterpart of dlrover_tpu/trainer/elastic/trainer.py (reference
dlrover/trainer/torch/elastic/trainer.py:48-132). The wrapper owns the
`accelerate()` build and picks (per_replica_batch, grad_accum) from
`elastic_batch_plan` over the mesh's batch shards, so the global batch
stays fixed as ranks come and go. The ranks are those of the
`torch.distributed` world `runtime.init()` joined (one process a card),
laid out by `mesh_spec` over data x fsdp x seq (a replica is a batch
shard: data x fsdp of them), or the one process where there is no
world. After the agent restarts the job into a new world,
`on_world_change` rebuilds the plan and the step for it and makes the
live state of the rank furthest along (rank 0 where all are at one
step; never a fresh replacement) every rank's, re-cut for the new
layout: the counterpart of JAX re-sharding the state onto the new
mesh. A piece that died with its rank cannot be re-cut: that raises,
and the state comes back through the flash checkpoint.
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
    default_group,
    sync_state,
)
from dlrover_tpu_torch.parallel.mesh import MeshSpec
from dlrover_tpu_torch.parallel.sharding import ShardPlan, flat_leaves
from dlrover_tpu_torch.trainer.elastic.data import elastic_batch_plan


class ElasticTrainer:
    """Keeps ``global_batch_size`` fixed by gradient accumulation.

    Usage::

        et = ElasticTrainer(init_params, loss_fn, optimizer,
                            global_batch_size=64,
                            max_per_replica_batch=8,
                            rules=llama.partition_rules(cfg),
                            mesh_spec=MeshSpec(fsdp=world))
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
        rules=None,
    ):
        self._init_params = init_params
        self._rules = tuple(rules or ())
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
        else every rank of the world a data shard. JAX's default,
        `local_mesh_spec`, puts them on fsdp: the same batch shards, the
        state cut into pieces; the port keeps data until fsdp has run on
        NCCL across cards (ROADMAP queue 1 item 13)."""
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
            mesh=self._mesh_spec,
        )
        self.acc = accelerate(
            self._init_params, self._loss_fn, self._optimizer,
            strategy=strategy, rules=self._rules,
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
        every rank, laid out for the new mesh: the plan and the step are
        built anew, then the params, optimizer moments, step and loss
        scale of the rank at the highest step are taken by each rank
        (`accelerate.sync_state`): broadcast where the state is whole;
        where it is in pieces, the old pieces gathered from their live
        holders (the old layout crosses by `all_gather_object`) and the
        new pieces cut (RuntimeError naming the leaves where a piece has
        no live holder). A replacement process that instead builds its
        trainer and calls `init_state` takes part in the same exchange
        and takes the survivors' state. The optimizer objects stay, so
        nothing is drawn again. Returns the state."""
        if mesh_spec is not None:
            self._mesh_spec = mesh_spec
        old = state.get("layout")
        self._build()
        mesh = self.acc.mesh
        if mesh is None:
            if old is not None and old.sharded:
                raise RuntimeError(
                    "on_world_change into a world of one process without "
                    "a process group: the other pieces of the sharded "
                    "state are out of reach; restore from the flash "
                    "checkpoint")
            state.pop("layout", None)
            return state
        shapes = (old.shapes if old is not None else {
            p: tuple(x.shape) for p, x in flat_leaves(state["params"])
            if torch.is_tensor(x)})
        plan = ShardPlan.from_shapes(mesh, self._rules, shapes)
        sync_state(state, self.acc.group, plan)
        self.acc.plan = plan
        return state
