"""Flash checkpoint saver (agent side) and the shared-memory handler — the
port's copy of dlrover_tpu/agent/ckpt_saver.py (reference
dlrover/python/elastic_agent/torch/ckpt_saver.py: `SharedMemoryHandler`
:210, `AsyncCheckpointSaver` :345, `CommonDirCheckpointSaver` :774).

The staged state is a flat {path: array} in a shm segment (files in the
shm directory that outlive a crashed trainer), described by a
`CheckpointMeta` in the IPC server's shared dict. The saver persists it
as `<dir>/<step>/host_<rank>.npz` + `aux_<rank>.pkl` and commits the
step by done files and the tracker file, as the JAX saver does: the
same leaf layout and the same files on disk.

What the port adds: `SharedMemoryHandler.reserve` / `publish` (the two
halves of `save_flat_state`) so the trainer can copy device tensors
straight into the segment, `pin_for_cuda` to page-lock the segment for
those copies, reads by `pread` instead of through a mapping, a persist
that streams the .npz to storage, a saver loop that stops at
`STOP_EVENT` only after the events queued before it, and two slots in
the segment: JAX's one buffer is overwritten in place, so a trainer
that dies while an async staging is in flight leaves the published
step's meta over torn bytes, which the agent would persist and the
next trainer restore; here the write goes to the other slot.
"""

import mmap
import os
import pickle
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from dlrover_tpu_torch.common.constants import CheckpointConstant
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.multi_process import (
    SharedDict,
    SharedLock,
    SharedMemorySegment,
    SharedQueue,
    shm_dir,
)
from dlrover_tpu_torch.common.storage import (
    CheckpointStorage,
    KeepLatestStepStrategy,
    get_checkpoint_storage,
)

CKPT_META_NAME = "ckpt_meta"
CKPT_QUEUE_NAME = "ckpt_save_events"
CKPT_LOCK_NAME = "ckpt_shm_lock"
# the event an in-process saver's owner queues last: the saver handles
# every event before it, then stops
STOP_EVENT = {"stop": True}
# slots of the staging segment (one file each): a write never touches
# the slot of the published step
SLOTS = 2
# fan-out of a checkpoint file's extraction on restore
RESTORE_THREADS = int(os.environ.get("DLROVER_TPU_RESTORE_THREADS", "8"))


class ShmIntegrityError(RuntimeError):
    """The shm segment does not cover the staged metadata (a stale
    mapping across a writer resize, or a torn write). Restore treats it
    as "no usable memory checkpoint"; the saver skips the persist."""


class ShmCapacityError(RuntimeError):
    """The shm directory has no room for a slot of the staged state."""


@dataclass
class TensorMeta:
    path: str  # flattened state path, "params/layers/wq"
    shape: Tuple[int, ...]
    dtype: str  # numpy dtype name of the staged bytes
    offset: int
    nbytes: int


@dataclass
class CheckpointMeta:
    step: int = -1
    save_path: str = ""
    tensors: List[TensorMeta] = field(default_factory=list)
    aux: bytes = b""  # the state's own description (engine.flatten_state)
    total_bytes: int = 0
    slot: int = 0  # the segment slot that holds the bytes


def pread_full(fd: int, view: memoryview, offset: int, what: str = ""):
    """Fill `view` from the file at `offset`. One read returns at most
    ~2 GiB (Linux caps a transfer at 0x7ffff000 bytes), so this loops
    until the view is whole; a file that ends first is a torn segment."""
    done = 0
    while done < len(view):
        got = os.preadv(fd, [view[done:]], offset + done)
        if got <= 0:
            raise ShmIntegrityError(
                f"short read of {what}: {done} of {len(view)} bytes at "
                f"{offset}"
            )
        done += got


def shm_segment_name(job_name: str, node_rank: int, slot: int = 0) -> str:
    base = f"dlrover_tpu_ckpt_{job_name}_{node_rank}"
    return base if slot == 0 else f"{base}_slot{slot}"


def shm_segment_paths(job_name: str, node_rank: int = 0) -> List[str]:
    """The files of every slot of a host's staging segment."""
    return [
        os.path.join(shm_dir(),
                     shm_segment_name(job_name, node_rank, slot).replace(
                         "/", "_"))
        for slot in range(SLOTS)
    ]


def _check_room(path: str, size: int):
    """Raise ShmCapacityError where the shm directory cannot hold a slot
    file of `size` bytes (the bytes the file holds already count as
    room; a rank of sharded state stages its own pieces only, so `size`
    is its share). The file is sparse, so without this check a host short of
    memory would fail only at the write, by SIGBUS."""
    try:
        held = os.stat(path).st_blocks * 512
    except FileNotFoundError:
        held = 0
    st = os.statvfs(os.path.dirname(path))
    free = st.f_bavail * st.f_frsize + held
    if size > free:
        raise ShmCapacityError(
            f"staging slot {os.path.basename(path)} needs {size} bytes; "
            f"{os.path.dirname(path)} has {free} free (a host holds "
            f"{SLOTS} slots of the staged state)"
        )


def layout(
    specs: Iterable[Tuple[str, Tuple[int, ...], str, int]],
) -> Tuple[List[TensorMeta], int]:
    """(path, shape, dtype, nbytes) of each leaf -> their TensorMetas,
    packed back to back in order, and the total bytes."""
    tensors, offset = [], 0
    for path, shape, dtype, nbytes in specs:
        tensors.append(TensorMeta(path, tuple(shape), dtype, offset, nbytes))
        offset += nbytes
    return tensors, offset


class SharedMemoryHandler:
    """Write/read a flat {path: ndarray} state into the shm segment.

    The segment has SLOTS slots, each a file of its own: a write goes
    into a slot that does not hold the published step, and `publish`
    names the slot it wrote. A writer that dies mid-write (a trainer
    crashing while an async staging is in flight) so leaves the last
    published step whole; with one buffer it would leave that step's
    meta over half-overwritten bytes."""

    def __init__(self, job_name: str, node_rank: int = 0):
        self.job_name = job_name
        self.node_rank = node_rank
        self._segments: List[Optional[SharedMemorySegment]] = [None] * SLOTS
        # address of each slot registered with CUDA
        self._pinned: List[Optional[int]] = [None] * SLOTS
        self._slot = 0  # the slot the last reserve returned
        self.meta_dict = SharedDict(f"{CKPT_META_NAME}_{node_rank}", job_name)
        self.lock = SharedLock(f"{CKPT_LOCK_NAME}_{node_rank}", job_name)

    @property
    def _segment(self) -> Optional[SharedMemorySegment]:
        """The segment of the slot last reserved."""
        return self._segments[self._slot]

    # ---- write path (trainer) -------------------------------------------

    def _ensure(self, slot: int, total_bytes: int) -> SharedMemorySegment:
        seg = self._segments[slot]
        if seg is None or seg.size < total_bytes or seg.is_stale():
            self._drop_segment(slot)
            size = -(-max(total_bytes, 1) // mmap.PAGESIZE) * mmap.PAGESIZE
            _check_room(
                shm_segment_paths(self.job_name, self.node_rank)[slot], size)
            seg = self._segments[slot] = SharedMemorySegment(
                shm_segment_name(self.job_name, self.node_rank, slot),
                size=size, create=True,
            )
        return seg

    def reserve(self, total_bytes: int) -> mmap.mmap:
        """The buffer of a slot that does not hold the published step,
        (re)created to hold `total_bytes` (a whole number of pages, so
        the buffer can be page-locked). Call under `lock`."""
        meta = self.get_meta()
        published = meta.slot if meta is not None and meta.step >= 0 else -1
        self._slot = (published + 1) % SLOTS
        return self._ensure(self._slot, total_bytes).buf

    def publish(
        self,
        step: int,
        tensors: List[TensorMeta],
        total_bytes: int,
        save_path: str = "",
        aux: bytes = b"",
    ):
        """Make the bytes written after `reserve` the staged state."""
        meta = CheckpointMeta(
            step=step,
            save_path=save_path,
            tensors=tensors,
            aux=aux,
            total_bytes=total_bytes,
            slot=self._slot,
        )
        self.meta_dict.set("meta", pickle.dumps(meta))

    def save_flat_state(
        self,
        step: int,
        flat: Dict[str, np.ndarray],
        save_path: str = "",
        aux: bytes = b"",
    ):
        flat = {p: np.asarray(a) for p, a in flat.items()}
        tensors, total = layout(
            (p, a.shape, str(a.dtype), a.nbytes) for p, a in flat.items()
        )
        buf = self.reserve(total)
        for tm, arr in zip(tensors, flat.values()):
            if tm.nbytes == 0:
                continue
            # copy straight into the mapping (tobytes() would make a
            # second host copy of every tensor)
            dst = np.frombuffer(
                buf, dtype=np.uint8, count=tm.nbytes, offset=tm.offset
            )
            src = np.ascontiguousarray(arr)
            np.copyto(dst, src.reshape(-1).view(np.uint8))
        self.publish(step, tensors, total, save_path, aux)

    def pin_for_cuda(self) -> bool:
        """Page-lock the slot last reserved for the CUDA driver (once per
        segment), so device-to-host copies into it are DMA at the link's
        rate. False where the driver refuses: copies then stage through
        pageable memory, correct and slower."""
        return self._pin(self._slot)

    def _pin(self, slot: int) -> bool:
        import torch

        if self._pinned[slot] is not None:
            return True
        seg = self._segments[slot]
        addr = np.frombuffer(seg.buf, dtype=np.uint8, count=1).ctypes.data
        err = torch.cuda.cudart().cudaHostRegister(addr, seg.size, 0)
        if int(err) != 0:
            logger.warning(
                "cudaHostRegister of %d bytes of %s failed (%s); copies "
                "into it stay pageable", seg.size, seg.path, err,
            )
            # the failed call stays the runtime's last error on this
            # thread, which the check after the thread's next kernel
            # launch would raise: take it here (a launch that raises it)
            try:
                torch.zeros(1, device="cuda")
            except Exception:  # noqa: BLE001 - the error just logged
                pass
            return False
        self._pinned[slot] = addr
        return True

    def _drop_segment(self, slot: int):
        if self._pinned[slot] is not None:
            import torch

            torch.cuda.cudart().cudaHostUnregister(self._pinned[slot])
            self._pinned[slot] = None
        if self._segments[slot] is not None:
            self._segments[slot].close()
            self._segments[slot] = None

    # ---- read path (agent saver / trainer restore) ----------------------

    def get_meta(self) -> Optional[CheckpointMeta]:
        raw = self.meta_dict.get("meta")
        return pickle.loads(raw) if raw else None

    def open_staged(self) -> Tuple[Optional[CheckpointMeta], Optional[int]]:
        """(meta, a read-only fd of the published slot's file) of the
        staged step, or (None, None) where nothing is staged or the file
        is gone; the caller closes the fd. Reads go by `pread_full` on
        the current file, whatever this handler has mapped, and take no
        page fault per 4 KB page (a read through a fresh mapping pays
        one each, which on a virtualized host can cost many times the
        copy)."""
        meta = self.get_meta()
        if meta is None or meta.step < 0:
            return None, None
        path = shm_segment_paths(self.job_name, self.node_rank)[meta.slot]
        try:
            fd = os.open(path, os.O_RDONLY)
        except FileNotFoundError:
            # unlinked between staging and this read
            return None, None
        size = os.fstat(fd).st_size
        if size < meta.total_bytes:
            os.close(fd)
            raise ShmIntegrityError(
                f"shm segment {os.path.basename(path)} holds {size} bytes "
                f"but meta for step {meta.step} claims {meta.total_bytes}"
            )
        return meta, fd

    def load_flat_state(
        self,
    ) -> Tuple[Optional[CheckpointMeta], Dict[str, np.ndarray]]:
        """The staged (meta, {path: owned array})."""
        meta, fd = self.open_staged()
        if meta is None:
            return None, {}
        flat = {}
        try:
            # one reader: on the card's host more threads read slower
            for tm in meta.tensors:
                arr = np.empty(tm.shape, dtype=np.dtype(tm.dtype))
                pread_full(fd, memoryview(arr).cast("B"), tm.offset,
                           tm.path)
                flat[tm.path] = arr
        finally:
            os.close(fd)
        return meta, flat

    def close(self, unlink: bool = False):
        for slot in range(SLOTS):
            seg = self._segments[slot]
            if seg is None:
                continue
            self._drop_segment(slot)
            if unlink:
                seg.unlink()

    def close_thread_conns(self):
        """Close the calling thread's IPC connections (for short-lived
        staging threads)."""
        self.meta_dict.close_thread()
        self.lock.close_thread()


class AsyncCheckpointSaver:
    """Agent-resident daemon: drains save events, persists shm to
    storage, runs the done-file commit protocol. One saver per host;
    `node_rank` / `num_nodes` drive the commit barrier; with a
    `master_client`, rank 0 reports each committed step to the master
    (`report_ckpt_saved`), as JAX's saver does. The agent re-points it
    after each rendezvous (`update_topology`)."""

    def __init__(
        self,
        job_name: str = "default",
        node_rank: int = 0,
        num_nodes: int = 1,
        storage: Optional[CheckpointStorage] = None,
        master_client=None,
    ):
        self.job_name = job_name
        self.master_client = master_client
        self.node_rank = node_rank
        self.num_nodes = num_nodes
        self.storage = storage or get_checkpoint_storage()
        self.shm_handler = SharedMemoryHandler(job_name, node_rank)
        self.event_queue = SharedQueue(CKPT_QUEUE_NAME, job_name)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # serializes the commit phase: the saver loop and the agent's
        # crash persist may race on the tracker's check-then-write
        self._commit_lock = threading.Lock()
        # (checkpoint_dir, max_to_keep) of the installed retention
        self._retention = (None, 0)
        self.last_persisted_step = -1

    # ---- lifecycle -------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(
            target=self._saver_loop, name="ckpt-saver", daemon=True
        )
        self._thread.start()

    def update_topology(self, node_rank: int, num_nodes: int):
        """Re-point the saver after a rendezvous round changed this
        host's rank or the world size (commit barrier + shm name)."""
        if node_rank != self.node_rank:
            self.shm_handler.close()
            self.shm_handler = SharedMemoryHandler(
                self.job_name, node_rank
            )
        self.node_rank = node_rank
        self.num_nodes = num_nodes

    def stop(self):
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the saver thread to end; True if it did."""
        t = self._thread
        if t is not None:
            t.join(timeout)
            return not t.is_alive()
        return True

    # ---- persist path ----------------------------------------------------

    def _saver_loop(self):
        while not self._stop.is_set():
            try:
                event = self.event_queue.get(timeout=1.0)
            except queue.Empty:
                continue
            except (ConnectionError, OSError):
                time.sleep(1.0)
                continue
            if event == STOP_EVENT:
                break
            try:
                self._handle_event(event)
            except Exception:  # noqa: BLE001 — saver must survive
                logger.exception("checkpoint persist failed")
        self.shm_handler.close_thread_conns()
        self.event_queue.close_thread()

    def _handle_event(self, event: dict):
        step = event["step"]
        path = event["path"]
        # the retention policy rides the event (the trainer owns the
        # config, this saver owns the storage that commits); re-install
        # whenever the dir or limit changes
        max_to_keep = int(event.get("max_to_keep", 0) or 0)
        if self._retention != (path, max_to_keep):
            if max_to_keep > 0:
                self.storage.deletion_strategy = KeepLatestStepStrategy(
                    max_to_keep, path
                )
            else:
                self.storage.deletion_strategy = None
            self._retention = (path, max_to_keep)
        t0 = time.monotonic()
        self.save_step_checkpoint(step, path)
        logger.info(
            "persisted checkpoint step=%d to %s in %.2fs",
            step,
            path,
            time.monotonic() - t0,
        )

    def save_step_checkpoint(
        self, step: int, path: str, commit_timeout: float = None
    ):
        """Persist the current shm state for `step` under `path/step/`."""
        # hold the shm lock only for the copy-out: a restarting
        # trainer's restore must not wait behind the (slow) storage write
        with self.shm_handler.lock:
            try:
                meta, flat = self.shm_handler.load_flat_state()
            except ShmIntegrityError as e:
                logger.warning("skipping persist of step %d: %s", step, e)
                return
        if meta is None or meta.step != step:
            logger.warning(
                "shm holds step %s, wanted %d — skipping persist",
                meta.step if meta else None,
                step,
            )
            return
        step_dir = os.path.join(path, str(step))
        self.storage.makedirs(step_dir)
        self.persist_to_storage(step_dir, meta, flat)
        del flat
        self.commit_checkpoint(step, path, timeout=commit_timeout)
        self.last_persisted_step = step

    def persist_to_storage(
        self, step_dir: str, meta: CheckpointMeta, flat: dict
    ):
        """One .npz per host, streamed to storage, + the aux bytes."""
        shard_file = os.path.join(step_dir, f"host_{self.node_rank}.npz")
        self.storage.write(lambda f: np.savez(f, **flat), shard_file)
        aux_file = os.path.join(step_dir, f"aux_{self.node_rank}.pkl")
        self.storage.write(meta.aux, aux_file)

    # ---- commit protocol -------------------------------------------------

    def commit_checkpoint(
        self, step: int, path: str, timeout: float = None
    ):
        """Two-phase: every host writes `.done_{rank}`; rank 0 waits for
        all, then atomically updates the tracker file and notifies the
        master."""
        timeout = timeout or CheckpointConstant.SAVE_TIMEOUT_SECS
        step_dir = os.path.join(path, str(step))
        done_file = os.path.join(
            step_dir,
            f"{CheckpointConstant.DONE_FILE_PREFIX}{self.node_rank}",
        )
        self.storage.write(b"1", done_file)

        def _coverage() -> int:
            return len(
                [
                    f
                    for f in self.storage.listdir(step_dir) or []
                    if f.startswith(CheckpointConstant.DONE_FILE_PREFIX)
                ]
            )

        if self.node_rank != 0:
            # a survivor that sees full coverage promotes the tracker
            # itself (rank 0 may be the host leaving on a scale-down)
            if _coverage() >= self.num_nodes:
                self._promote_tracker(step, path)
            return
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            done = _coverage()
            if done >= self.num_nodes:
                break
            time.sleep(0.1)
        else:
            logger.error(
                "commit timeout: %d/%d done files for step %d",
                done,
                self.num_nodes,
                step,
            )
            self.storage.commit(step, False)
            return
        self._promote_tracker(step, path)
        if self.master_client is not None:
            try:
                self.master_client.report_ckpt_saved(step, path)
            except Exception:  # noqa: BLE001
                logger.warning("ckpt step report failed", exc_info=True)

    def _promote_tracker(self, step: int, path: str):
        """Advance the tracker to `step` unless it already points past
        it (under _commit_lock: concurrent commits in this process must
        not regress it)."""
        with self._commit_lock:
            if step > read_tracker_step(self.storage, path):
                tracker = os.path.join(path, CheckpointConstant.TRACKER_FILE)
                self.storage.write(str(step), tracker)
            self.storage.commit(step, True)

    # ---- crash path ------------------------------------------------------

    def save_shm_to_storage(self, commit_timeout: float = 15.0):
        """Called by the agent when the trainer dies or restarts: persist
        whatever step is staged in shm if newer than the last persisted
        one (short commit timeout: peers may already be gone)."""
        meta = self.shm_handler.get_meta()
        if meta is None or meta.step < 0 or not meta.save_path:
            return
        if meta.step <= self.last_persisted_step:
            return
        logger.info(
            "trainer gone — persisting staged shm checkpoint step=%d",
            meta.step,
        )
        self.save_step_checkpoint(
            meta.step, meta.save_path, commit_timeout=commit_timeout
        )


def read_tracker_step(storage: CheckpointStorage, path: str) -> int:
    raw = storage.read(
        os.path.join(path, CheckpointConstant.TRACKER_FILE), "r"
    )
    try:
        return int(raw)
    except (TypeError, ValueError):
        return -1
