"""Trainer-side publishers for the agent's monitors — counterpart of
`write_step_metrics` and `publish_chip_metrics` in
dlrover_tpu/agent/monitor.py. The trainer writes its step and the
card's memory to small JSON files (paths from `ConfigPath`); the agent
relays them, so step reporting survives a wedged trainer (the silence
itself is the signal). The agent side is not ported yet."""

import json
import os
import time
from typing import Optional

import torch

from dlrover_tpu_torch.common.constants import ConfigPath


def _write_json(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def write_step_metrics(step: int, path: Optional[str] = None, **extra):
    """Publish the current step for the agent."""
    path = path or os.environ.get(
        ConfigPath.ENV_RUNTIME_METRICS, ConfigPath.DEFAULT_RUNTIME_METRICS
    )
    _write_json(path, {"step": step, "timestamp": time.time(), **extra})


def publish_chip_metrics(path: Optional[str] = None):
    """Publish this process's card memory for the agent's chip
    collector: the bytes PyTorch's allocator holds in tensors against
    the card's total memory, for the current CUDA device (none where
    CUDA is not available)."""
    path = path or os.environ.get(
        ConfigPath.ENV_CHIP_METRICS, ConfigPath.DEFAULT_CHIP_METRICS
    )
    chips = []
    if torch.cuda.is_available():
        dev = torch.cuda.current_device()
        in_use = int(torch.cuda.memory_stats(dev).get(
            "allocated_bytes.all.current", 0))
        limit = int(torch.cuda.mem_get_info(dev)[1])
        chips.append({
            "device": str(dev),
            "platform": "gpu",
            "hbm_bytes_in_use": in_use,
            "hbm_bytes_limit": limit,
            "hbm_utilization": round(in_use / limit, 4) if limit else 0.0,
        })
    _write_json(path, {"ts": time.time(), "chips": chips})
