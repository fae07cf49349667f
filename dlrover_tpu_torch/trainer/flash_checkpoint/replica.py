"""Cross-host in-memory checkpoint replicas — counterpart of
dlrover_tpu/trainer/flash_checkpoint/replica.py (`CkptReplicaManager`
:50; reference dlrover/trainer/torch/flash_checkpoint/replica.py:28),
so a node replacement (not just a process restart) restores from
memory instead of storage.

As in JAX, a replica lives in the job master's DRAM, in the KV store
every agent reaches (`MasterClient.kv_set` / `kv_get`, the port's
stdlib transport), keyed by the owner's rank and chunked so a large
state fits under a frame. A blob is the same bytes in both packages
for the same flat dict: zlib (level 1) over a pickle of
`{"npz": np.savez of the arrays, "aux": aux}`. Reading one unpickles
plain values only and loads the arrays with `allow_pickle=False`.
"""

import hashlib
import io
import pickle
import zlib
from typing import List, Optional, Tuple

import numpy as np

from dlrover_tpu_torch._device import DeviceLike
from dlrover_tpu_torch.common.log import default_logger as logger

_CHUNK = 64 * 1024 * 1024


class _PlainUnpickler(pickle.Unpickler):
    """The blob's envelope and meta are dicts of builtins: refuse any
    class (nothing a peer wrote can run code here)."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"{module}.{name} is not a plain value")


def _plain_loads(raw: bytes):
    return _PlainUnpickler(io.BytesIO(raw)).load()


def _pack(flat: dict, aux: bytes) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **flat)
    payload = pickle.dumps(
        {"npz": buf.getvalue(), "aux": aux},
        protocol=pickle.HIGHEST_PROTOCOL,
    )
    return zlib.compress(payload, level=1)


def _unpack(blob: bytes) -> Tuple[dict, bytes]:
    payload = _plain_loads(zlib.decompress(blob))
    with np.load(io.BytesIO(payload["npz"])) as npz:
        flat = {k: npz[k] for k in npz.files}
    return flat, payload["aux"]


class CkptReplicaManager:
    """Replicate a host's staged checkpoint; restore after its loss.

    backup(step, flat, aux) pushes this host's flat state dict to the
    master's KV store; restore(step) pulls it back: used by a new node
    taking over a dead node's rank, whose shm is empty.
    """

    def __init__(
        self,
        master_client=None,
        node_rank: Optional[int] = None,
        replica_count: int = 1,
    ):
        if master_client is None:
            from dlrover_tpu_torch.agent.master_client import MasterClient

            master_client = MasterClient.singleton()
        self._mc = master_client
        self.node_rank = (
            node_rank
            if node_rank is not None
            else getattr(master_client, "node_id", 0)
        )
        self.replica_count = replica_count

    def _key(self, rank: int, part: str) -> str:
        return f"ckpt_replica/{rank}/{part}"

    # -- backup ------------------------------------------------------------

    def backup(self, step: int, flat: dict, aux: bytes) -> int:
        """Push this host's replica; returns the bytes shipped."""
        if self.replica_count <= 0:
            return 0
        blob = _pack(flat, aux)
        digest = hashlib.sha1(blob).hexdigest()
        n_chunks = (len(blob) + _CHUNK - 1) // _CHUNK
        for i in range(n_chunks):
            self._mc.kv_set(
                self._key(self.node_rank, f"chunk{i}"),
                blob[i * _CHUNK:(i + 1) * _CHUNK],
            )
        meta = pickle.dumps(
            {
                "step": step,
                "n_chunks": n_chunks,
                "sha1": digest,
                "size": len(blob),
            }
        )
        # meta written last = commit point (readers validate the hash)
        self._mc.kv_set(self._key(self.node_rank, "meta"), meta)
        logger.info(
            "replicated ckpt step %d (%.1f MB) for node %d",
            step,
            len(blob) / 1e6,
            self.node_rank,
        )
        return len(blob)

    # -- restore -----------------------------------------------------------

    def peek_step(self, node_rank: Optional[int] = None) -> int:
        """Step held by the stored replica: the meta only, no chunk
        read, so the engine can order replica against storage before
        paying for either."""
        rank = self.node_rank if node_rank is None else node_rank
        raw_meta = self._mc.kv_get(self._key(rank, "meta"))
        if not raw_meta:
            return -1
        try:
            return int(_plain_loads(raw_meta)["step"])
        except Exception:  # noqa: BLE001 — torn meta = no replica
            return -1

    def restore(
        self, node_rank: Optional[int] = None
    ) -> Tuple[int, Optional[dict], Optional[bytes]]:
        """Fetch the replica of `node_rank` (default: this rank).
        Returns (step, flat, aux) or (-1, None, None)."""
        rank = self.node_rank if node_rank is None else node_rank
        raw_meta = self._mc.kv_get(self._key(rank, "meta"))
        if not raw_meta:
            return -1, None, None
        meta = _plain_loads(raw_meta)

        # the chunk reads fan out over the client's pooled connections:
        # a restore is the recovery stall, and serial round trips would
        # add up
        def _get(i: int):
            return self._mc.kv_get(self._key(rank, f"chunk{i}"))

        n = meta["n_chunks"]
        if n > 1:
            from concurrent.futures import ThreadPoolExecutor

            from dlrover_tpu_torch.agent.ckpt_saver import RESTORE_THREADS

            with ThreadPoolExecutor(min(RESTORE_THREADS, n)) as pool:
                parts: List[bytes] = list(pool.map(_get, range(n)))
        else:
            parts = [_get(0)] if n else []
        for i, chunk in enumerate(parts):
            if not chunk:
                logger.warning(
                    "replica chunk %d missing for node %d", i, rank
                )
                return -1, None, None
        blob = b"".join(parts)
        if (
            len(blob) != meta["size"]
            or hashlib.sha1(blob).hexdigest() != meta["sha1"]
        ):
            logger.warning("replica for node %d failed checksum", rank)
            return -1, None, None
        flat, aux = _unpack(blob)
        return meta["step"], flat, aux

    def restore_state(
        self, node_rank: Optional[int] = None, target=None,
        device: DeviceLike = None,
    ):
        """Replica -> (step, state): into `target` (a train state) in
        place, or a nested dict of tensors on `device` (engine
        `unflatten_state`); (-1, None) where there is none."""
        from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
            unflatten_state,
        )

        step, flat, aux = self.restore(node_rank)
        if flat is None:
            return -1, None
        return step, unflatten_state(flat, aux, target, device)
