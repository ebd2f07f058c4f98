"""The plain reference of the first training steps: the published DSNT-AL
training step in float32 (TF32 off unless the control turns it on), with
plain autograd and a written-out AdamW.

One step on a batch {img (B, 1, H, W) in [0, 1], contour (B, K, 2)}:

1. augmentation, per item uniform in its range: rotation +-3 degrees about
   the image centre and translation +-5 px (the image resampled bilinearly
   at the inverse map, zero outside; the landmarks rotated by the angle
   the other way on screen, then shifted), contrast and brightness +-0.2
   (x (1 + c) + b, clipped to [0, 1]), then gamma in [0.8, 1.2];
2. the backbone with dropout on (reference/<model_name>.py `forward`),
   each heatmap's Gaussian (head.py, f32), the loss: the mean over points
   of log|Sigma| + the Mahalanobis distance of the landmark;
3. gradients by autograd, then AdamW (lr 1e-3, betas 0.9 and 0.999, eps
   1e-8, decoupled weight decay 1e-3).

The random numbers are the run's, from a generator seeded as the
trainer seeds its own, drawn in the published order: per step the angle,
the shift in x and in y, the brightness, the contrast and the gamma, each
(B,) uniforms, then the dropout uniforms of the forward.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from . import head

DEG = math.pi / 180.0


def _warp_bilinear(img, angle, shift):
    """img (B, C, H, W) sampled at the source of each output pixel: the
    translation undone, then the rotation about the centre."""
    b, c, h, w = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    th = angle * DEG
    cos, sin = torch.cos(th)[:, None, None], torch.sin(th)[:, None, None]
    yy = torch.arange(h, dtype=img.dtype, device=img.device)[None, :, None]
    xx = torch.arange(w, dtype=img.dtype, device=img.device)[None, None, :]
    xs = xx - shift[:, 0, None, None] - cx
    ys = yy - shift[:, 1, None, None] - cy
    sx = cos * xs - sin * ys + cx
    sy = sin * xs + cos * ys + cy
    x0, y0 = torch.floor(sx), torch.floor(sy)
    out = torch.zeros_like(img)
    flat = img.reshape(b, c, h * w)
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            wgt = (1 - (sx - x0) if dx == 0 else sx - x0) * (1 - (sy - y0) if dy == 0 else sy - y0)
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long().reshape(b, 1, h * w)
            val = torch.gather(flat, 2, idx.expand(b, c, h * w)).reshape(b, c, h, w)
            out = out + torch.where(inside[:, None], val, 0.0) * wgt[:, None]
    return out


def augment(batch, g):
    """The augmented image and landmarks of a batch, drawing from g."""
    img, contour = batch["img"], batch["contour"]
    n, _, h, w = img.shape
    u = lambda lo, hi: lo + (hi - lo) * torch.rand((n,), generator=g, device=g.device)
    angle, sx, sy = u(-3.0, 3.0), u(-5.0, 5.0), u(-5.0, 5.0)
    bright, contrast, gamma = u(-0.2, 0.2), u(-0.2, 0.2), u(0.8, 1.2)
    shift = torch.stack([sx, sy], -1)
    warped = _warp_bilinear(img, angle, shift)
    warped = torch.clamp(warped * (1 + contrast)[:, None, None, None]
                         + bright[:, None, None, None], 0.0, 1.0)
    img = torch.pow(torch.clamp(warped, min=1e-8), gamma[:, None, None, None])
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    th = angle[:, None] * DEG
    ax, ay = contour[..., 0] - cx, contour[..., 1] - cy
    qx = cx + torch.cos(th) * ax + torch.sin(th) * ay
    qy = cy - torch.sin(th) * ax + torch.cos(th) * ay
    return img, torch.stack([qx, qy], -1) + shift[:, None, :]


def steps(weights: Dict[str, torch.Tensor], batches: List[Dict[str, torch.Tensor]], seed: int,
          forward: Callable, lr: float = 1e-3, weight_decay: float = 1e-3) -> Dict[str, object]:
    """The reference's steps over `batches` from `weights` -> per-step
    losses, the first step's gradients and the parameters after the last.
    `forward(params, img, drop)` is the backbone's logits, `drop(shape)`
    the uniforms of a dropout layer."""
    device = next(iter(weights.values())).device
    g = torch.Generator(device=device).manual_seed(int(seed))
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grad = [], None
    b1, b2, eps = 0.9, 0.999, 1e-8
    for t, batch in enumerate(batches, start=1):
        img, target = augment(batch, g)
        logits = forward(params, img, lambda s: torch.rand(s, generator=g, device=device))
        mu, cov = head.gaussians(logits, torch.float32)
        loss = head.gaussian_nll(mu, cov, target).mean()
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            grads = {k: torch.zeros_like(p) if gr is None else gr
                     for (k, p), gr in zip(params.items(), grads)}
            if first_grad is None:
                first_grad = {k: gr.clone() for k, gr in grads.items()}
            for k, p in params.items():
                p.mul_(1 - lr * weight_decay)
                m[k].mul_(b1).add_(grads[k], alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(grads[k], grads[k], value=1 - b2)
                denom = (v2[k] / (1 - b2 ** t)).sqrt_().add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
    return {"losses": losses, "first_grad": first_grad,
            "params": {k: p.detach() for k, p in params.items()}}


def leaf_gap(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             scale: Dict[str, torch.Tensor]) -> float:
    """The worst leaf's |‖got‖ - ‖ref‖| over the larger of ‖ref‖ and the
    median leaf's ‖ref‖, leaving out the leaves whose `scale` (the
    reference's first gradient) is under a thousandth of the median
    leaf's: their change is round-off alone."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    gnorm = {k: float(torch.linalg.vector_norm(v.double())) for k, v in scale.items()}
    med = sorted(norms.values())[len(norms) // 2]
    gmed = sorted(gnorm.values())[len(gnorm) // 2]
    kept = [k for k in ref if gnorm[k] >= 1e-3 * gmed]
    return max(abs(float(torch.linalg.vector_norm(got[k].double())) - norms[k])
               / max(norms[k], med) for k in kept)
