"""Device resolution shared by the port's public entry points.

Entry points default to the GPU. They run on the CPU only when the caller
passes `device="cpu"`; asking for CUDA (explicitly or by default) on a
machine without it raises instead of carrying on silently on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> cuda. Raises if CUDA is asked for but not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "contouring_uncertainty_torch runs on the GPU by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU explicitly."
        )
    return dev
