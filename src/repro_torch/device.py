"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. There is no
silent fallback: with no visible CUDA device and no explicit device, they
raise.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """None → the first CUDA device (raises if there is none); anything
    else → `torch.device(device)` as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)

