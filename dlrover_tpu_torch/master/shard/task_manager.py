"""Dynamic data sharding: per-dataset task queues with failure recovery.

Reference parity: dlrover/python/master/shard/task_manager.py:37
(`TaskManager`, `recover_tasks` :169) + batch_dataset_manager.py. Shards
become numbered tasks handed to workers on request; tasks a dead worker
held go back on the queue; finished counts drive epoch rollover; the whole
splitter+queue state checkpoints to JSON so a restarted master resumes
mid-epoch.

The port's copy of dlrover_tpu/master/shard/task_manager.py (host
Python, no torch); it imports nothing of the JAX package.
"""

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import DatasetTask
from dlrover_tpu_torch.master.shard.dataset_splitter import (
    DatasetSplitter,
    Shard,
    new_dataset_splitter,
)


@dataclass
class _PendingTask:
    task: DatasetTask
    node_id: int
    start_time: float


class DatasetManager:
    """Task queue for one dataset (reference BatchDatasetManager)."""

    def __init__(self, splitter: DatasetSplitter, task_type: str = "train"):
        self.splitter = splitter
        self.task_type = task_type
        self._todo: List[DatasetTask] = []
        self._doing: Dict[int, _PendingTask] = {}
        self._next_task_id = 0
        self._completed = 0
        # restore bookkeeping: tasks issued since the last applied
        # restore + whether any restore ever applied (see
        # restore_checkpoint's staleness rule)
        self._tasks_issued = 0
        self._restore_count = 0
        self._lock = threading.Lock()

    # ---- queue ops -------------------------------------------------------

    def _refill(self):
        if self._todo or self._doing:
            return
        if self.splitter.epoch_finished():
            return
        self.splitter.create_shards()
        for shard in self.splitter.get_shards():
            self._todo.append(
                DatasetTask(
                    task_id=self._next_task_id,
                    shard_start=shard.start,
                    shard_end=shard.end,
                    task_type=self.task_type,
                    epoch=self.splitter.epoch,
                )
            )
            self._next_task_id += 1

    def get_task(self, node_id: int) -> DatasetTask:
        with self._lock:
            self._refill()
            if not self._todo:
                return DatasetTask()  # task_id=-1: nothing (yet)
            task = self._todo.pop(0)
            self._doing[task.task_id] = _PendingTask(
                task, node_id, time.time()
            )
            self._tasks_issued += 1
            return task

    def report_task(self, task_id: int, success: bool) -> bool:
        with self._lock:
            pending = self._doing.pop(task_id, None)
            if pending is None:
                return False
            if success:
                self._completed += 1
            else:
                self._todo.insert(0, pending.task)
            return True

    def recover_tasks(self, node_id: int):
        """Requeue all tasks a dead worker was holding.

        Reference: TaskManager.recover_tasks task_manager.py:169.
        """
        with self._lock:
            lost = [
                tid
                for tid, p in self._doing.items()
                if p.node_id == node_id
            ]
            for tid in lost:
                self._todo.insert(0, self._doing.pop(tid).task)
            if lost:
                logger.info(
                    "recovered %d tasks of dataset %s from node %d",
                    len(lost),
                    self.splitter.dataset_name,
                    node_id,
                )

    # ---- state -----------------------------------------------------------

    @property
    def completed(self) -> int:
        return self._completed

    def finished(self) -> bool:
        with self._lock:
            self._refill()
            return (
                not self._todo
                and not self._doing
                and self.splitter.epoch_finished()
            )

    def epoch(self) -> int:
        return self.splitter.epoch

    def checkpoint(self) -> Dict:
        """JSON-able snapshot: uncompleted shards (todo + doing) so a new
        master can resume. Reference: dataset shard checkpoints
        (master/shard/task_manager.py + sharding client)."""
        with self._lock:
            shards = [
                [t.shard_start, t.shard_end]
                for t in self._todo
            ] + [
                [p.task.shard_start, p.task.shard_end]
                for p in self._doing.values()
            ]
            return {
                "dataset_name": self.splitter.dataset_name,
                "epoch": self.splitter.epoch,
                "completed": self._completed,
                "todo_shards": shards,
            }

    def restore_checkpoint(self, state: Dict) -> bool:
        """Rebuild the queues from a snapshot. The FIRST restore always
        applies (requeues in-flight shards — the roundtrip/resume use).
        After that, a restore only applies while no tasks have been
        issued since the last applied one: after a master restart the
        first recovering worker's restore wins, and peers' stale
        restores are ignored — otherwise each would wipe `_doing` and
        re-issue everything the others just processed. Returns whether
        the restore was applied."""
        with self._lock:
            if self._restore_count and self._tasks_issued:
                return False
            self._restore_count += 1
            self._tasks_issued = 0
            self._todo = []
            self._doing = {}
            self.splitter.epoch = state.get("epoch", 0)
            self._completed = state.get("completed", 0)
            for start, end in state.get("todo_shards", []):
                self._todo.append(
                    DatasetTask(
                        task_id=self._next_task_id,
                        shard_start=start,
                        shard_end=end,
                        task_type=self.task_type,
                        epoch=self.splitter.epoch,
                    )
                )
                self._next_task_id += 1
            return True


class TaskManager:
    """All datasets of a job + worker-death hook.

    Reference parity: master/shard/task_manager.py:37.
    """

    def __init__(self):
        self._datasets: Dict[str, DatasetManager] = {}
        self._lock = threading.Lock()
        self.speed_monitor = None  # wired by the master

    def new_dataset(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        storage_type: str = "table",
        task_type: str = "train",
    ):
        with self._lock:
            if dataset_name in self._datasets:
                return  # idempotent: every worker reports params
            splitter = new_dataset_splitter(
                dataset_name,
                dataset_size,
                shard_size,
                num_epochs,
                shuffle,
                storage_type,
            )
            self._datasets[dataset_name] = DatasetManager(
                splitter, task_type
            )
            logger.info(
                "created dataset %s: size=%d shard=%d epochs=%d",
                dataset_name,
                dataset_size,
                shard_size,
                num_epochs,
            )

    def get_dataset(self, name: str) -> Optional[DatasetManager]:
        return self._datasets.get(name)

    def get_task(self, node_id: int, dataset_name: str) -> DatasetTask:
        ds = self._datasets.get(dataset_name)
        if ds is None:
            return DatasetTask()
        return ds.get_task(node_id)

    def report_task(
        self, dataset_name: str, task_id: int, success: bool
    ) -> bool:
        ds = self._datasets.get(dataset_name)
        return ds.report_task(task_id, success) if ds else False

    def recover_tasks(self, node_id: int):
        for ds in self._datasets.values():
            ds.recover_tasks(node_id)

    def finished(self) -> bool:
        with self._lock:
            return bool(self._datasets) and all(
                ds.finished() for ds in self._datasets.values()
            )

    def has_datasets(self) -> bool:
        return bool(self._datasets)

    # ---- shard checkpoint ------------------------------------------------

    def checkpoint_dataset(self, dataset_name: str) -> str:
        ds = self._datasets.get(dataset_name)
        return json.dumps(ds.checkpoint()) if ds else ""

    def restore_dataset(self, dataset_name: str, content: str):
        ds = self._datasets.get(dataset_name)
        if ds and content:
            ds.restore_checkpoint(json.loads(content))
