"""Segmentation metrics on the device.

Counterpart of contouring_uncertainty_tpu/utils/metrics.py, the part the
DSNT-AL validation uses (`dice_binary`).
"""

from __future__ import annotations

import torch


def dice_binary(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Binary Dice over trailing (H, W); broadcasts over leading axes."""
    pred = pred.to(torch.float32)
    target = target.to(torch.float32)
    inter = (pred * target).sum(dim=(-2, -1))
    denom = pred.sum(dim=(-2, -1)) + target.sum(dim=(-2, -1))
    return (2.0 * inter + eps) / (denom + eps)
