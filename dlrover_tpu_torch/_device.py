"""Device choice for the port's entry points.

Entry points take `device=None`, which means the card. There is no
quiet move to the CPU: asking for CUDA where there is none raises, and
the CPU runs only when the caller names it (the tests do).
"""

import os
from typing import List, Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]

# N > 0 makes `local_devices` report N entries of the one device
FORCE_DEVICE_COUNT_ENV = "DLROVER_TPU_TORCH_FORCE_DEVICE_COUNT"


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> "cuda". Raises when CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


def local_devices(device: DeviceLike = None) -> List[torch.device]:
    """The devices a serving slice may span, `device` first: every CUDA
    card for a CUDA device (`device`, then the others in index order),
    the one CPU for the CPU.

    DLROVER_TPU_TORCH_FORCE_DEVICE_COUNT=N returns N entries of `device`
    itself: N virtual shards on one card (or the CPU), which run one
    after another on its stream. It is the counterpart of XLA's
    `--xla_force_host_platform_device_count` that the JAX package's
    tests set to get eight CPU devices; set it where a test or a smoke
    run wants a tp > 1 slice on a machine with fewer devices."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    forced = os.environ.get(FORCE_DEVICE_COUNT_ENV, "").strip()
    if forced:
        n = int(forced)
        if n < 1:
            raise ValueError(
                f"{FORCE_DEVICE_COUNT_ENV} must be >= 1, got {forced!r}")
        return [dev] * n
    if dev.type != "cuda":
        return [dev]
    return [dev] + [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())
                    if i != dev.index]


def upload(arr, device: torch.device) -> torch.Tensor:
    """A host numpy array on `device`. On the card it goes through a
    page-locked copy and a non-blocking transfer, so the stream is not
    synchronized; the page-locked block returns to torch's host
    allocator, which reuses it only after the event of the transfer
    that reads it has completed."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
