"""ElasticTrainer: a fixed global batch size, on one device.

Counterpart of dlrover_tpu/trainer/elastic/trainer.py (reference
dlrover/trainer/torch/elastic/trainer.py:48-132). The wrapper owns the
`accelerate()` build and picks (per_replica_batch, grad_accum) from
`elastic_batch_plan`, so a global batch larger than one replica can
hold is walked in microbatches. One device is one replica; a world
change (`on_world_change`) needs the multi-GPU port.
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
)
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
    """

    def __init__(
        self,
        init_params: Callable[[torch.Generator], Any],
        loss_fn: Callable,
        optimizer: OptimizerFactory,
        global_batch_size: int,
        max_per_replica_batch: int,
        device: DeviceLike = None,
    ):
        self._init_params = init_params
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self.global_batch_size = global_batch_size
        self.max_per_replica_batch = max_per_replica_batch
        self._device = device
        self.acc: Optional[Accelerated] = None
        self.plan: Dict[str, int] = {}
        self._build()

    # -- build -------------------------------------------------------------

    def _build(self):
        replicas = 1
        self.plan = elastic_batch_plan(
            self.global_batch_size, replicas, self.max_per_replica_batch
        )
        strategy = Strategy(
            device=self._device, grad_accum=self.plan["grad_accum"]
        )
        self.acc = accelerate(
            self._init_params, self._loss_fn, self._optimizer,
            strategy=strategy,
        )
        logger.info(
            "ElasticTrainer: %d replica, per-replica batch %d, "
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
        return self.acc.eval_step(state, self.acc.place_batch(batch))

    # -- elasticity --------------------------------------------------------

    def on_world_change(self, state: Any, *args, **kwargs) -> Any:
        raise NotImplementedError(
            "a world change needs the multi-GPU port (ROADMAP queue 1, "
            "item 9: runtime and multi-GPU)"
        )
