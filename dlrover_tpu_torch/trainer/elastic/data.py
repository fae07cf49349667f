"""Elastic data pipeline: sharding client, sampler, dataloader, dataset.

Reference parity (SURVEY.md §2.2/§2.3):
- `ShardingClient`/`IndexShardingClient` (dlrover/python/elastic_agent/
  sharding/client.py:29,:234) — worker-side dynamic-shard consumption
  against the master TaskManager, with shard checkpoint/restore.
- `ElasticDistributedSampler` (dlrover/trainer/torch/elastic/
  sampler.py:25, state_dict :118) — resumes at completed_num and
  re-shards mid-epoch when the world size changes.
- `ElasticDataLoader` (elastic/dataloader.py:26, update_batch_size :133)
  — live batch-size reconfig pushed by the master.
- atorch `ElasticDataset` (atorch/atorch/data/elastic_dataset.py) —
  map-style dataset fed by master-issued shards.

The port's copy of dlrover_tpu/trainer/elastic/data.py: batches are
host numpy, as in JAX, and the port's `ElasticTrainer` places them on
the card (`Accelerated.place_batch`). The "world" is the data-parallel
replica count. The sharding clients speak to the port's master through
its `MasterClient`. What drives them through a world change (the agent
and its rendezvous) waits for ROADMAP queue 1, item 9: the agent,
runtime and multi-GPU.
"""

import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from dlrover_tpu_torch.common.log import default_logger as logger


class ShardingClient:
    """Worker-side dynamic data sharding against the master TaskManager.

    fetch_shard() pulls [start, end) ranges; report_done() acks them so
    the master can recover unfinished shards of dead workers
    (master/shard/task_manager.py `recover_tasks`).
    """

    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        master_client=None,
        node_id: int = 0,
        num_epochs: int = 1,
        shuffle: bool = False,
        storage_type: str = "text",
    ):
        if master_client is None:
            from dlrover_tpu_torch.agent.master_client import MasterClient

            master_client = MasterClient.singleton()
        self._mc = master_client
        self._name = dataset_name
        self._node_id = node_id
        self._current = None
        self._lock = threading.Lock()
        # kept for master-restart recovery: a restarted master has no
        # datasets; the client re-registers with these params and
        # restores the last pulled shard checkpoint (shards acked since
        # the last pull are replayed — the same at-least-once semantics
        # shard recovery gives dead workers). The pull is TIME-bounded,
        # not per-ack: the snapshot serializes the whole remaining todo
        # list under the master's dataset lock, so per-ack pulls would
        # scale master load with fleet size for a rarely-read value.
        self._params = dict(
            dataset_name=dataset_name,
            dataset_size=dataset_size,
            shard_size=shard_size,
            num_epochs=num_epochs,
            shuffle=shuffle,
            storage_type=storage_type,
        )
        self.checkpoint_interval_s = 30.0  # min seconds between pulls
        self._last_ckpt_pull = 0.0
        self._cached_checkpoint = ""
        self._mc.report_dataset_params(**self._params)

    def _recover_master_state(self):
        """The master lost this dataset (restart): re-register and
        restore the last pulled shard checkpoint."""
        self._mc.report_dataset_params(**self._params)
        if self._cached_checkpoint:
            self._mc.restore_shard_checkpoint(
                self._name, self._cached_checkpoint
            )

    def fetch_shard(self):
        """Next shard task or None when the dataset is exhausted."""
        task = self._mc.get_task(self._name)
        if not getattr(task, "dataset_known", True):
            self._recover_master_state()
            task = self._mc.get_task(self._name)
        if not task.exists:
            return None
        with self._lock:
            self._current = task
        return task

    def report_done(self, task_id: Optional[int] = None, success=True):
        with self._lock:
            if task_id is None and self._current is not None:
                task_id = self._current.task_id
            self._current = None
        if task_id is not None and task_id >= 0:
            self._mc.report_task_result(self._name, task_id, success)
            now = time.monotonic()
            if now - self._last_ckpt_pull >= self.checkpoint_interval_s:
                self._last_ckpt_pull = now
                try:
                    self._cached_checkpoint = (
                        self._mc.get_shard_checkpoint(self._name)
                    )
                except Exception:  # noqa: BLE001 — stale cache is fine
                    pass

    def shard_checkpoint(self) -> str:
        return self._mc.get_shard_checkpoint(self._name)

    def restore_shard_checkpoint(self, content: str):
        self._mc.restore_shard_checkpoint(self._name, content)

    def iter_shards(self):
        while True:
            task = self.fetch_shard()
            if task is None:
                return
            yield task
            self.report_done(task.task_id)


class IndexShardingClient(ShardingClient):
    """Per-sample index stream over master-issued shards
    (reference sharding/client.py:234). fetch_index() returns one dataset
    index at a time; shards are acked when fully consumed."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._pending: List[int] = []
        self._pending_task_id = -1

    def fetch_index(self) -> Optional[int]:
        with self._lock:
            if self._pending:
                idx = self._pending.pop(0)
                if not self._pending:
                    done = self._pending_task_id
                    self._pending_task_id = -1
                else:
                    done = None
                if done is not None and done >= 0:
                    self._mc.report_task_result(self._name, done, True)
                return idx
        task = self.fetch_shard()
        if task is None:
            return None
        with self._lock:
            self._pending = list(range(task.shard_start, task.shard_end))
            self._pending_task_id = task.task_id
        return self.fetch_index()


class ElasticDistributedSampler:
    """Shards [0, dataset_size) across data-parallel replicas; resumable
    and re-shardable mid-epoch.

    state_dict() records `completed_num` — total samples consumed across
    ALL replicas — so training resumed on a DIFFERENT world size skips
    exactly the consumed prefix (reference sampler.py:118).
    """

    def __init__(
        self,
        dataset_size: int,
        num_replicas: int,
        rank: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ):
        if rank >= num_replicas:
            raise ValueError(f"rank {rank} >= num_replicas {num_replicas}")
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.completed_num = 0
        self.drop_last = drop_last

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.completed_num = 0

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(self.dataset_size)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[int]:
        indices = self._epoch_indices()
        # skip the globally-consumed prefix, then round-robin the rest
        rest = indices[self.completed_num:]
        if self.drop_last:
            usable = len(rest) - len(rest) % self.num_replicas
            rest = rest[:usable]
        for i, idx in enumerate(rest):
            if i % self.num_replicas == self.rank:
                yield int(idx)

    def __len__(self) -> int:
        n = self.dataset_size - self.completed_num
        if self.drop_last:
            n -= n % self.num_replicas
        return max(0, n) // self.num_replicas + (
            0 if self.drop_last else int(n % self.num_replicas > self.rank)
        )

    def record_batch(self, batch_size: int):
        """Advance the global progress counter by one consumed batch
        (batch_size PER replica)."""
        self.completed_num += batch_size * self.num_replicas

    def state_dict(self) -> Dict:
        return {
            "epoch": self.epoch,
            "completed_num": int(self.completed_num),
        }

    def load_state_dict(
        self,
        state: Dict,
        num_replicas: Optional[int] = None,
        rank: Optional[int] = None,
    ):
        """Restore progress; pass new num_replicas/rank to re-shard the
        remainder of the epoch onto a resized world."""
        self.epoch = state.get("epoch", 0)
        self.completed_num = int(state.get("completed_num", 0))
        if num_replicas is not None:
            self.num_replicas = num_replicas
        if rank is not None:
            self.rank = rank
        if self.rank >= self.num_replicas:
            raise ValueError(
                f"rank {self.rank} >= num_replicas {self.num_replicas}"
            )


class ElasticDataLoader:
    """Batching iterator with master-driven live reconfig.

    Pulls indices from a sampler, materializes batches through
    `fetch_fn(indices) -> batch dict of np arrays` (or a map-style
    dataset), and re-reads the batch size from the master's
    ParallelConfig at epoch boundaries or when poll_config() is called
    (reference dataloader.py:133 `update_batch_size`; config push path
    common/grpc.py ParallelConfig → ParalConfigTuner file).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        sampler: Optional[ElasticDistributedSampler] = None,
        collate_fn: Optional[Callable] = None,
        master_client=None,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or ElasticDistributedSampler(
            len(dataset), 1, 0, shuffle=False
        )
        self.collate_fn = collate_fn or _default_collate
        self._mc = master_client
        self.drop_last = drop_last
        self._config_version = -1

    def poll_config(self):
        """Adopt a newer master ParallelConfig if present."""
        if self._mc is None:
            return
        try:
            cfg = self._mc.get_paral_config()
        except Exception:  # master gone: keep current config
            return
        if cfg.version > self._config_version:
            self._config_version = cfg.version
            if cfg.dataloader_batch_size > 0 and (
                cfg.dataloader_batch_size != self.batch_size
            ):
                logger.info(
                    "ElasticDataLoader: batch_size %s -> %s (config v%s)",
                    self.batch_size, cfg.dataloader_batch_size, cfg.version,
                )
                self.batch_size = cfg.dataloader_batch_size

    def __iter__(self):
        self.poll_config()
        buf: List[int] = []
        for idx in self.sampler:
            buf.append(idx)
            if len(buf) == self.batch_size:
                yield self._materialize(buf)
                self.sampler.record_batch(len(buf))
                buf = []
        if buf and not self.drop_last:
            yield self._materialize(buf)
            self.sampler.record_batch(len(buf))

    def _materialize(self, indices: Sequence[int]):
        samples = [self.dataset[i] for i in indices]
        return self.collate_fn(samples)


def _default_collate(samples):
    """list of dict-of-arrays → dict of stacked np arrays (or a stacked
    array for non-dict samples)."""
    first = samples[0]
    if isinstance(first, dict):
        return {
            k: np.stack([np.asarray(s[k]) for s in samples])
            for k in first
        }
    return np.stack([np.asarray(s) for s in samples])


class ElasticDataset:
    """Map-style dataset whose index stream comes from master shards
    (reference atorch/data/elastic_dataset.py). `read_sample(index)` is
    user-provided; iteration order and fault recovery are owned by the
    master TaskManager via IndexShardingClient."""

    def __init__(
        self,
        name: str,
        dataset_size: int,
        shard_size: int,
        read_sample: Callable[[int], Dict[str, np.ndarray]],
        master_client=None,
        num_epochs: int = 1,
        shuffle: bool = False,
    ):
        self._read = read_sample
        self.client = IndexShardingClient(
            name,
            dataset_size,
            shard_size,
            master_client=master_client,
            num_epochs=num_epochs,
            shuffle=shuffle,
        )
        self.dataset_size = dataset_size

    def __len__(self):
        return self.dataset_size

    def __iter__(self):
        while True:
            idx = self.client.fetch_index()
            if idx is None:
                return
            yield self._read(idx)

    def batches(self, batch_size: int, drop_last: bool = True):
        buf = []
        for sample in self:
            buf.append(sample)
            if len(buf) == batch_size:
                yield _default_collate(buf)
                buf = []
        if buf and not drop_last:
            yield _default_collate(buf)


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
