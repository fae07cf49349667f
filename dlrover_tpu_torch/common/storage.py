"""Checkpoint storage and deletion strategies — the port's copy of
dlrover_tpu/common/storage.py (reference dlrover/python/common/storage.py:
`CheckpointStorage` :24, `PosixDiskStorage` :128, the deletion strategies
:189-258).

One addition: `write` also takes a callable that writes into the open
binary file, so the saver streams a multi-GB .npz to disk instead of
building it in memory first.
"""

import os
import shutil
import threading
from typing import Callable, List, Optional, Union

Content = Union[bytes, bytearray, memoryview, str, Callable]


class CheckpointDeletionStrategy:
    def clean_up(self, step: int, delete_func):
        raise NotImplementedError


class KeepLatestStepStrategy(CheckpointDeletionStrategy):
    """Keep only the newest `max_to_keep` step directories.

    Step dirs already on disk are counted from construction (a resumed
    job after a saver restart must still converge to the limit)."""

    def __init__(self, max_to_keep: int = 3, checkpoint_dir: str = ""):
        self.max_to_keep = max(1, max_to_keep)
        self.checkpoint_dir = checkpoint_dir
        self._steps: List[int] = []
        if checkpoint_dir and os.path.isdir(checkpoint_dir):
            self._steps = sorted(
                int(d) for d in os.listdir(checkpoint_dir) if d.isdigit()
            )

    def clean_up(self, step: int, delete_func):
        if step in self._steps:
            return
        self._steps.append(step)
        self._steps.sort()
        while len(self._steps) > self.max_to_keep:
            victim = self._steps.pop(0)
            delete_func(os.path.join(self.checkpoint_dir, str(victim)))


class CheckpointStorage:
    """write/read/listdir/exists/commit: the saver and the engines speak
    only this interface, so other backends drop in."""

    # retention policy applied on successful commits (the saver installs
    # it from the trainer's config, see ckpt_saver._handle_event)
    deletion_strategy: Optional[CheckpointDeletionStrategy] = None

    def write(self, content: Content, path: str):
        raise NotImplementedError

    def read(self, path: str, mode: str = "rb"):
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def makedirs(self, path: str):
        raise NotImplementedError

    def delete(self, path: str):
        raise NotImplementedError

    def commit(self, step: int, success: bool):
        """Called after a step's files are fully persisted: applies the
        retention policy."""
        if success and self.deletion_strategy is not None:
            self.deletion_strategy.clean_up(step, self.delete)


class PosixDiskStorage(CheckpointStorage):
    def __init__(
        self,
        deletion_strategy: Optional[CheckpointDeletionStrategy] = None,
    ):
        self.deletion_strategy = deletion_strategy

    def write(self, content: Content, path: str):
        """Write `content` (bytes, str, or a callable `f(binary_file)`)
        to `path` atomically: a per-writer tmp file, fsync, rename."""
        os.makedirs(os.path.dirname(path), exist_ok=True)
        mode = "w" if isinstance(content, str) else "wb"
        # per-writer tmp name: shared targets (the tracker file, written
        # by every committing host) must not interleave in one ".tmp"
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, mode) as f:
                if callable(content):
                    content(f)
                else:
                    f.write(content)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):  # failed mid-write: don't litter
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    def read(self, path: str, mode: str = "rb"):
        if not os.path.exists(path):
            return None
        with open(path, mode) as f:
            return f.read()

    def listdir(self, path: str) -> List[str]:
        try:
            return sorted(os.listdir(path))
        except FileNotFoundError:
            return []

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def makedirs(self, path: str):
        os.makedirs(path, exist_ok=True)

    def delete(self, path: str):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.unlink(path)


def get_checkpoint_storage(deletion_strategy=None) -> CheckpointStorage:
    return PosixDiskStorage(deletion_strategy)
