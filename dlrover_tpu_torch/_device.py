"""Device choice for the port's entry points.

Entry points take `device=None`, which means the card. There is no
quiet move to the CPU: asking for CUDA where there is none raises, and
the CPU runs only when the caller names it (the tests do).
"""

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> "cuda". Raises when CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev
