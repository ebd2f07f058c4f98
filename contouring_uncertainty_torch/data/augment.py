"""On-device training augmentations over {image, mask, keypoints}.

Counterpart of contouring_uncertainty_tpu/data/augment.py (`AugmentParams`,
`AugmentConfig`, `sample_params`, `identity_params`, `apply`,
`un_apply_logits`, `un_apply_keypoints`): per-item rotation about the
image centre and translation (bilinear for images, nearest for masks, zero
outside), contrast, brightness and gamma on [0, 1] images, and the matching
keypoint transform, for a whole batch at once; and the inverses of the
geometric part that test-time augmentation applies to logits and
keypoints.

The warp reproduces `jax.scipy.ndimage.map_coordinates` (order 0 and 1,
mode "constant") in its own formula order: source coordinates computed as
the JAX module computes them, nearest lookups rounded half away from zero
(`lax.round`; `torch.round` rounds half to even), each out-of-range
neighbour zeroed on its own, the four bilinear terms summed in the same
order. `F.grid_sample` is not used: its [-1, 1] normalisation moves
half-pixel lookups.

Convention: img (N, C, H, W) float; gt (N, H, W) mask; contour (N, K, 2) in
(x, y) pixels. The image grid rotates with R(a), keypoints with R(-a) (y
axis down).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from contouring_uncertainty_torch.rng import draw_uniform

_DEG2RAD = float(np.float32(np.pi / 180.0))  # jnp.deg2rad's f32 constant


class AugmentParams(NamedTuple):
    angle_deg: torch.Tensor  # (N,)
    shift: torch.Tensor  # (N, 2) (dx, dy)
    brightness: torch.Tensor  # (N,)
    contrast: torch.Tensor  # (N,)
    gamma: torch.Tensor  # (N,)


class AugmentConfig(NamedTuple):
    degrees: float = 3.0
    translate: Tuple[float, float] = (5.0, 5.0)
    brightness: float = 0.2
    contrast: float = 0.2
    gamma: Tuple[float, float] = (0.8, 1.2)


def sample_params(generator: Optional[torch.Generator], n: int,
                  cfg: AugmentConfig = AugmentConfig()) -> AugmentParams:
    """Per-item parameters, uniform in the configured ranges, drawn from
    `generator` on its device (the CPU without one); a `rng.RowBlock` of n
    rows draws the whole batch's and keeps its rows."""

    def uniform(lo, hi, shape=(n,)):
        return lo + (hi - lo) * draw_uniform(generator, shape)

    angle = uniform(-cfg.degrees, cfg.degrees)
    shift = torch.stack([uniform(-cfg.translate[0], cfg.translate[0]),
                         uniform(-cfg.translate[1], cfg.translate[1])], dim=-1)
    brightness = uniform(-cfg.brightness, cfg.brightness)
    contrast = uniform(-cfg.contrast, cfg.contrast)
    gamma = uniform(cfg.gamma[0], cfg.gamma[1])
    return AugmentParams(angle, shift, brightness, contrast, gamma)


def identity_params(n: int, device=None) -> AugmentParams:
    z = torch.zeros(n, device=device)
    return AugmentParams(z, torch.zeros(n, 2, device=device), z, z, torch.ones(n, device=device))


def _round_half_away(c: torch.Tensor) -> torch.Tensor:
    t = torch.trunc(c)
    return torch.where((c - t).abs() >= 0.5, t + torch.sign(c), t)


def _source_coords(n: int, h: int, w: int, angle_deg, shift, dtype, device):
    """(src_y, src_x), each (N, H, W): output pixel -> source pixel of the
    inverse map (undo the translation, then the rotation about the centre)."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    th = angle_deg.to(dtype) * _DEG2RAD
    cos, sin = torch.cos(th)[:, None, None], torch.sin(th)[:, None, None]
    yy = torch.arange(h, dtype=dtype, device=device)[None, :, None]
    xx = torch.arange(w, dtype=dtype, device=device)[None, None, :]
    xs = xx - shift[:, 0, None, None].to(dtype) - cx
    ys = yy - shift[:, 1, None, None].to(dtype) - cy
    src_x = cos * xs - sin * ys + cx
    src_y = sin * xs + cos * ys + cy
    return src_y, src_x


def _warp(img: torch.Tensor, angle_deg, shift, order: int) -> torch.Tensor:
    """Rotate about the centre and translate (N, C, H, W) images by inverse
    mapping, order 0 (nearest) or 1 (bilinear), zero outside."""
    n, c, h, w = img.shape
    src_y, src_x = _source_coords(n, h, w, angle_deg, shift, img.dtype, img.device)
    if order == 0:
        nodes_y = [(_round_half_away(src_y).to(torch.int32), None)]
        nodes_x = [(_round_half_away(src_x).to(torch.int32), None)]
    else:
        def linear(coord):
            lower = torch.floor(coord)
            upper_w = coord - lower
            index = lower.to(torch.int32)
            return [(index, 1 - upper_w), (index + 1, upper_w)]

        nodes_y, nodes_x = linear(src_y), linear(src_x)
    flat = img.reshape(n, c, h * w)
    out = None
    for iy, wy in nodes_y:
        for ix, wx in nodes_x:
            valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).to(torch.int64)
            val = torch.gather(flat, 2, idx.reshape(n, 1, h * w).expand(n, c, h * w))
            val = torch.where(valid.reshape(n, 1, h * w), val, torch.zeros((), dtype=img.dtype,
                                                                           device=img.device))
            term = val if wy is None else (wy * wx).reshape(n, 1, h * w) * val
            out = term if out is None else out + term
    return out.reshape(n, c, h, w).to(img.dtype)


def _rotate_keypoints(kp: torch.Tensor, angle_deg, center) -> torch.Tensor:
    """Screen-space keypoint rotation by R(-a) about `center`."""
    th = angle_deg * _DEG2RAD
    cos, sin = torch.cos(th), torch.sin(th)
    ax = kp[..., 0] - center[0]
    ay = kp[..., 1] - center[1]
    qx = center[0] + cos * ax + sin * ay
    qy = center[1] - sin * ax + cos * ay
    return torch.stack([qx, qy], dim=-1)


def apply(batch: Dict[str, torch.Tensor], params: AugmentParams) -> Dict[str, torch.Tensor]:
    """Geometric and intensity augmentation of a batch dict: "img"
    (N, C, H, W), "gt" (N, H, W) mask and "contour" (N, K, 2); other keys
    pass through untouched."""
    out = dict(batch)
    img = batch["img"]
    _, _, h, w = img.shape
    center = ((w - 1) / 2.0, (h - 1) / 2.0)

    warped = _warp(img, params.angle_deg, params.shift, order=1)
    # Intensity: contrast and brightness, then gamma (on [0, 1] images).
    ctr = (1.0 + params.contrast)[:, None, None, None]
    br = params.brightness[:, None, None, None]
    warped = torch.clamp(warped * ctr + br, 0.0, 1.0)
    out["img"] = torch.pow(torch.clamp(warped, min=1e-8), params.gamma[:, None, None, None])

    if batch.get("gt") is not None:
        gt = batch["gt"][:, None].to(torch.float32)
        out["gt"] = _warp(gt, params.angle_deg, params.shift, order=0)[:, 0].to(batch["gt"].dtype)

    if batch.get("contour") is not None:
        kp = _rotate_keypoints(batch["contour"], params.angle_deg[:, None], center)
        out["contour"] = kp + params.shift[:, None, :]
    return out


def un_apply_logits(logits: torch.Tensor, params: AugmentParams) -> torch.Tensor:
    """Invert the geometric transform on (N, C, H, W) logits (the TTA
    path): first remove the translation, then rotate back, each a bilinear
    warp with zeros outside."""
    unshifted = _warp(logits, torch.zeros_like(params.angle_deg), -params.shift, order=1)
    return _warp(unshifted, -params.angle_deg, torch.zeros_like(params.shift), order=1)


def un_apply_keypoints(kp: torch.Tensor, params: AugmentParams,
                       image_shape=(256, 256)) -> torch.Tensor:
    """Invert the keypoint transform of `apply` on (N, K, 2) keypoints."""
    center = ((image_shape[1] - 1) / 2.0, (image_shape[0] - 1) / 2.0)
    kp = kp - params.shift[:, None, :]
    return _rotate_keypoints(kp, -params.angle_deg[:, None], center)
