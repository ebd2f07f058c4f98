"""Segmentation metrics on the device.

Counterpart of contouring_uncertainty_tpu/utils/metrics.py: `dice_binary`
(the DSNT-AL validation), `dice_multiclass`, the differentiable `soft_dice`
of the segmentation baselines' loss, and `pixel_entropy`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dice_binary(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Binary Dice over trailing (H, W); broadcasts over leading axes."""
    pred = pred.to(torch.float32)
    target = target.to(torch.float32)
    inter = (pred * target).sum(dim=(-2, -1))
    denom = pred.sum(dim=(-2, -1)) + target.sum(dim=(-2, -1))
    return (2.0 * inter + eps) / (denom + eps)


def dice_multiclass(pred: torch.Tensor, target: torch.Tensor, labels) -> torch.Tensor:
    """Mean Dice over non-background labels. pred/target: (..., H, W) int maps."""
    scores = [dice_binary(pred == int(lab), target == int(lab))
              for lab in labels if int(lab) != 0]
    return torch.stack(scores, dim=-1).mean(dim=-1)


def soft_dice(probs: torch.Tensor, target: torch.Tensor, n_channels: int,
              eps: float = 1e-8) -> torch.Tensor:
    """Differentiable Dice over the foreground channels, pooled over the
    batch: probs (N, C, H, W), target (N, H, W) int labels -> (C',), one
    value per foreground class (C' = 1 when n_channels is 1)."""
    if n_channels == 1:
        tgt = (target > 0).to(torch.float32)[:, None]
        p = probs
    else:
        tgt = F.one_hot(target.long(), n_channels).permute(0, 3, 1, 2)[:, 1:].to(torch.float32)
        p = probs[:, 1:]
    inter = (p * tgt).sum(dim=(0, 2, 3))
    denom = p.sum(dim=(0, 2, 3)) + tgt.sum(dim=(0, 2, 3))
    return (2.0 * inter + eps) / (denom + eps)


def pixel_entropy(probs: torch.Tensor, axis: int = 1, eps: float = 1e-12) -> torch.Tensor:
    """Shannon entropy of per-pixel class probabilities along `axis`."""
    return -(probs * torch.log(probs + eps)).sum(dim=axis)
