"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` unless the caller names another device.  Asking for CUDA on
    a machine without it raises: the port never carries on quietly on the
    CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def generator(seed: int, device: Optional[torch.device]) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
