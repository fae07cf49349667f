"""Checkpointer frontends over the flash checkpoint engine — counterpart
of dlrover_tpu/trainer/flash_checkpoint/formats.py (reference
dlrover/trainer/torch/flash_checkpoint/fsdp.py:152
`FsdpFullCheckpointer`, full_ckpt_engine.py:33).

- `ShardedCheckpointer`: the shm engine (`Checkpointer`).
- `FullCheckpointer`: the whole state to host, one file per step.
- `OrbaxCheckpointer`: the JAX package's wraps orbax, a JAX library;
  its counterpart (a `torch.distributed.checkpoint` format) waits for
  the multi-GPU port (ROADMAP queue 1, item 9) and raises.
"""

import os
import pickle
import time
from typing import Any, Optional, Tuple

from dlrover_tpu_torch._device import DeviceLike
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
    Checkpointer,
    StorageType,
    flatten_state,
    unflatten_state,
)

ShardedCheckpointer = Checkpointer  # the shm engine


class FullCheckpointer:
    """Gather the whole state to host and save one portable file,
    `full_<step>.pkl` with `latest.txt` beside it. The file holds
    {"step", "state": {JAX flatten_state path: ndarray}, "aux"}: the
    JAX package's holds its pytree of optax classes, which the port
    does not import."""

    def __init__(self, checkpoint_dir: str):
        self.checkpoint_dir = checkpoint_dir
        os.makedirs(checkpoint_dir, exist_ok=True)

    def save_checkpoint(
        self, step: int, state: Any, storage_type: str = StorageType.DISK
    ) -> float:
        if storage_type != StorageType.DISK:
            # no shm fast path: refusing beats stalling the step loop on
            # a gather the caller believed was a memory stage
            raise ValueError(
                "FullCheckpointer only supports StorageType.DISK; use "
                "ShardedCheckpointer for the in-memory fast path"
            )
        t0 = time.monotonic()
        flat, aux = flatten_state(state)
        path = os.path.join(self.checkpoint_dir, f"full_{step}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump({"step": step, "state": flat, "aux": aux}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(path + ".tmp", path)
        latest = os.path.join(self.checkpoint_dir, "latest.txt")
        with open(latest + ".tmp", "w") as f:
            f.write(str(step))
        os.replace(latest + ".tmp", latest)
        return time.monotonic() - t0

    def load_checkpoint(
        self, target: Any = None, step: Optional[int] = None,
        device: DeviceLike = None,
    ) -> Tuple[int, Optional[Any]]:
        if step is None:
            latest = os.path.join(self.checkpoint_dir, "latest.txt")
            if not os.path.exists(latest):
                return -1, None
            with open(latest) as f:
                step = int(f.read().strip())
        path = os.path.join(self.checkpoint_dir, f"full_{step}.pkl")
        if not os.path.exists(path):
            return -1, None
        with open(path, "rb") as f:
            payload = pickle.load(f)  # a file this class wrote
        return payload["step"], unflatten_state(
            payload["state"], payload["aux"], target, device)

    def close(self):
        pass


class OrbaxCheckpointer:
    """Not ported: see the module docstring."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "OrbaxCheckpointer wraps a JAX library; its counterpart (a "
            "torch.distributed.checkpoint format) is not ported yet "
            "(ROADMAP queue 1, item 9)"
        )
