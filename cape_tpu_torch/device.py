"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default is `cuda`, and a machine without CUDA raises instead of carrying
on silently on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means `cuda`; a CUDA device on a machine without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev

