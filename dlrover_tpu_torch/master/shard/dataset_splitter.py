"""Dataset splitters: global dataset → ordered shard list.

Reference parity: dlrover/python/master/shard/dataset_splitter.py —
`DatasetSplitter` ABC (:90), `TableDatasetSplitter` (:144),
`TextDatasetSplitter` (:257), `StreamingDatasetSplitter` (:359). A shard is
an index range [start, end) over samples; splitters hand out per-epoch
batches of shards, optionally shuffled, until num_epochs are exhausted.

The port's copy of dlrover_tpu/master/shard/dataset_splitter.py (host
Python, no torch); it imports nothing of the JAX package.
"""

import random
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Shard:
    """Half-open sample range; `record_indices` optionally pins exact
    sample ids inside the range (TextDatasetSplitter semantics)."""

    start: int
    end: int
    record_indices: Optional[List[int]] = None

    @property
    def size(self) -> int:
        return self.end - self.start


class DatasetSplitter:
    """Base splitter: create_shards() per epoch until epochs exhausted."""

    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
    ):
        if shard_size <= 0:
            raise ValueError("shard_size must be positive")
        self.dataset_name = dataset_name
        self.dataset_size = dataset_size
        self.shard_size = shard_size
        self.num_epochs = num_epochs
        self.shuffle = shuffle
        self.epoch = 0
        self._shards: List[Shard] = []

    def get_shards(self) -> List[Shard]:
        return self._shards

    def create_shards(self):
        raise NotImplementedError

    def epoch_finished(self) -> bool:
        return self.epoch >= self.num_epochs


class TableDatasetSplitter(DatasetSplitter):
    """Contiguous range shards (table rows / sample indices).

    Reference: TableDatasetSplitter dataset_splitter.py:144 — shards are
    [i*shard_size, min((i+1)*shard_size, size)); shuffle permutes shard
    order, not intra-shard order.
    """

    def create_shards(self):
        shards = [
            Shard(start, min(start + self.shard_size, self.dataset_size))
            for start in range(0, self.dataset_size, self.shard_size)
        ]
        if self.shuffle:
            random.shuffle(shards)
        self._shards = shards
        self.epoch += 1


class TextDatasetSplitter(DatasetSplitter):
    """Shards carrying explicit (optionally shuffled) sample indices —
    for line-indexed text files where workers seek exact records.

    Reference: TextDatasetSplitter dataset_splitter.py:257.
    """

    def create_shards(self):
        indices = list(range(self.dataset_size))
        if self.shuffle:
            random.shuffle(indices)
        shards = []
        for start in range(0, self.dataset_size, self.shard_size):
            chunk = indices[start : start + self.shard_size]
            shards.append(Shard(start, start + len(chunk), chunk))
        self._shards = shards
        self.epoch += 1


@dataclass
class StreamingShard:
    start: int
    end: int


class StreamingDatasetSplitter(DatasetSplitter):
    """Unbounded stream: shards are generated as data arrives; the
    producer reports new sample counts via `add_records`.

    Reference: StreamingDatasetSplitter dataset_splitter.py:359 (the
    streaming-data-splitter design doc).
    """

    def __init__(
        self,
        dataset_name: str,
        shard_size: int,
        max_pending_shards: int = 1024,
    ):
        super().__init__(
            dataset_name,
            dataset_size=0,
            shard_size=shard_size,
            num_epochs=1,
        )
        self._next_start = 0
        self._pending_records = 0
        self.max_pending_shards = max_pending_shards
        self._ended = False

    def add_records(self, count: int):
        self._pending_records += count
        self.dataset_size += count

    def end_stream(self):
        self._ended = True

    def create_shards(self):
        shards = []
        while (
            self._pending_records >= self.shard_size
            and len(shards) < self.max_pending_shards
        ):
            shards.append(
                Shard(self._next_start, self._next_start + self.shard_size)
            )
            self._next_start += self.shard_size
            self._pending_records -= self.shard_size
        if self._ended and self._pending_records > 0:
            shards.append(
                Shard(
                    self._next_start,
                    self._next_start + self._pending_records,
                )
            )
            self._next_start += self._pending_records
            self._pending_records = 0
        self._shards = shards
        if self._ended and self._pending_records == 0:
            self.epoch = self.num_epochs

    def epoch_finished(self) -> bool:
        return self._ended and self._pending_records == 0


def new_dataset_splitter(
    dataset_name: str,
    dataset_size: int,
    shard_size: int,
    num_epochs: int = 1,
    shuffle: bool = False,
    storage_type: str = "table",
) -> DatasetSplitter:
    """Factory mirroring the reference's splitter selection."""
    if storage_type in ("table", ""):
        return TableDatasetSplitter(
            dataset_name, dataset_size, shard_size, num_epochs, shuffle
        )
    if storage_type == "text":
        return TextDatasetSplitter(
            dataset_name, dataset_size, shard_size, num_epochs, shuffle
        )
    if storage_type == "stream":
        return StreamingDatasetSplitter(dataset_name, shard_size)
    raise ValueError(f"unknown storage_type {storage_type!r}")
