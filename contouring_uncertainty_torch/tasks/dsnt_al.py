"""DSNT-AL task: U-Net heatmaps -> DSNT -> per-point bivariate Gaussians.

Counterpart of contouring_uncertainty_tpu/tasks/dsnt_al.py, serving half:
`build_model`, `forward_gaussians`, `predict` and `mc_dropout_apply`
(the training `loss` and `val_metrics` come with the training slice).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from contouring_uncertainty_torch.data.config import DataParams
from contouring_uncertainty_torch.device import DeviceLike, resolve_device
from contouring_uncertainty_torch.models.unet import UNet
from contouring_uncertainty_torch.ops import dsnt as dsnt_ops


def mc_dropout_apply(model: UNet, img: torch.Tensor, t_e: int,
                     generator: Optional[torch.Generator]) -> Dict:
    """One batched MC-dropout forward at batch T_e*N -> raw output dict,
    T_e-major ordering (sample e of frame i at batch index e*N + i).

    With `drop_block`, the deterministic encoder prefix (stem + every stage
    before the first dropout stage, the FLOP-heavy high-resolution part) runs
    ONCE at batch N and is tiled T_e times; only the stochastic tail runs at
    batch T_e*N. Exact against tiling the input: the prefix has no dropout,
    instance norm is per sample, and the tail draws the same masks from the
    generator in the same order."""
    tile = lambda a: a.repeat((t_e,) + (1,) * (a.ndim - 1))
    if isinstance(model, UNet) and model.drop_block:
        prefix = model(img, mode="encode_prefix")
        tiled = {"skips": [tile(s) for s in prefix["skips"]]}
        return model(None, deterministic=False, generator=generator,
                     mode="decode_from_prefix", prefix=tiled)
    return model(tile(img), deterministic=False, generator=generator)


@dataclass
class DSNTAleatoric:
    """Config + step functions for the DSNT aleatoric contour task."""

    data_params: DataParams
    covar: bool = True
    mse_weight: float = 1.0
    log_penalty_weight: float = 1.0
    t_a: int = 25
    t_e: int = 1
    model_kwargs: Dict[str, Any] = field(default_factory=dict)
    model_name: str = "unet2"
    task_name: str = "dsnt-al"

    def build_model(self, device: DeviceLike = None,
                    generator: Optional[torch.Generator] = None) -> UNet:
        """The backbone on `device` (default cuda), initialised from
        `generator` (a CPU generator gives the same weights on any device)."""
        from contouring_uncertainty_torch.models import build_backbone

        device = resolve_device(device)
        c, h, w = self.data_params.in_shape
        k = self.data_params.out_shape[0]
        model = build_backbone(self.model_name, (c, h, w), (k, h, w), **self.model_kwargs)
        model.reset_parameters(generator)
        return model.to(device).eval()

    def _gaussians_from_out(self, out):
        return dsnt_ops.logits_to_pixel_gaussians(out["out"], use_covar=self.covar)

    def forward_gaussians(self, model, img, generator=None, mc_dropout=False):
        """img (N, C, H, W) -> (mu (N,K,2), sigma (N,K,2,2)) in pixel space."""
        return self._gaussians_from_out(
            model(img, deterministic=not mc_dropout, generator=generator))

    def predict(self, model, img, generator: Optional[torch.Generator] = None):
        """Epistemic-sampling forward: (N, C, H, W) -> mu (N, T_e, K, 2),
        cov (N, T_e, K, 2, 2). T_e > 1 uses one MC-dropout forward at batch
        T_e*N with the encoder prefix shared; T_e == 1 is deterministic."""
        t_e = self.t_e
        if t_e > 1:
            n = img.shape[0]
            mu, sigma = self._gaussians_from_out(mc_dropout_apply(model, img, t_e, generator))
            mu = mu.reshape((t_e, n) + mu.shape[1:]).transpose(0, 1)
            sigma = sigma.reshape((t_e, n) + sigma.shape[1:]).transpose(0, 1)
            return mu, sigma
        mu, sigma = self.forward_gaussians(model, img)
        return mu[:, None], sigma[:, None]
