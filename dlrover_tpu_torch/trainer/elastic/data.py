"""Elastic data helpers — counterpart of dlrover_tpu/trainer/elastic/data.py.

Only the batch plan is ported; the sharding client, samplers and
loaders come later (ROADMAP)."""

from typing import Dict


def elastic_batch_plan(
    global_batch_size: int,
    num_replicas: int,
    max_per_replica_batch: int,
) -> Dict[str, int]:
    """Fixed-global-batch elasticity (reference ElasticTrainer
    trainer/torch/elastic/trainer.py:48): given the current world, pick
    (per_replica_batch, grad_accum) with per*accum*replicas ==
    global_batch_size. Raises if the global batch isn't divisible."""
    if global_batch_size % num_replicas:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{num_replicas} replicas"
        )
    per_world = global_batch_size // num_replicas
    accum = 1
    per = per_world
    while per > max_per_replica_batch:
        accum += 1
        if per_world % accum:
            continue
        per = per_world // accum
    return {
        "per_replica_batch": per,
        "grad_accum": accum,
        "num_replicas": num_replicas,
    }
