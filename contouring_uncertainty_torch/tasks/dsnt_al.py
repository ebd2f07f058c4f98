"""DSNT-AL task: U-Net heatmaps -> DSNT -> per-point bivariate Gaussians.

Counterpart of contouring_uncertainty_tpu/tasks/dsnt_al.py: `build_model`
(every backbone; the Resnet regressor's coordinates go through
`regression_gaussians` instead of DSNT),
`forward_gaussians`, `predict` and `mc_dropout_apply` (serving; `predict`
takes one model or a deep ensemble, a list of models), `loss` and
`val_metrics` (training: the per-point Gaussian NLL, and the validation Dice
of the linear contour reconstruction, rasterized through the crossing
selection). `val_figure` (matplotlib) is not ported (ROADMAP.md Queue 1,
item 13): it raises.

Where the JAX task takes `variables` and an rng key, the port takes the
model (its parameters are the module's) and a `torch.Generator` for the
dropout masks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from contouring_uncertainty_torch.data.config import DataParams, Label, Tags
from contouring_uncertainty_torch.device import DeviceLike, resolve_device
from contouring_uncertainty_torch.models.unet import UNet
from contouring_uncertainty_torch.ops import dsnt as dsnt_ops
from contouring_uncertainty_torch.ops.rasterize import rasterize_batch
from contouring_uncertainty_torch.rng import Generators
from contouring_uncertainty_torch.utils.metrics import dice_binary


def regression_gaussians(mu: torch.Tensor, sigma_params: torch.Tensor,
                         use_covar: bool = True):
    """Per-point bivariate Gaussians from a coordinate-regression head (the
    Resnet backbone's (N, K, 2) coordinates and (N, K, sigma_out) sigma
    parameters): (log sigma_x, log sigma_y[, atanh-rho logit]) -> (mu, 2x2
    cov), log sigmas clipped to [-6, 8] and rho to 0.99 tanh."""
    log_s = torch.clamp(sigma_params[..., :2], -6.0, 8.0)
    sx, sy = torch.exp(log_s[..., 0]), torch.exp(log_s[..., 1])
    if use_covar and sigma_params.shape[-1] >= 3:
        rho = 0.99 * torch.tanh(sigma_params[..., 2])
    else:
        rho = torch.zeros_like(sx)
    off = rho * sx * sy
    cov = torch.stack([torch.stack([sx * sx, off], dim=-1),
                       torch.stack([off, sy * sy], dim=-1)], dim=-2)
    return mu, cov


def mc_dropout_apply(model: torch.nn.Module, img: torch.Tensor, t_e: int,
                     generator: Optional[torch.Generator]) -> Dict:
    """One batched MC-dropout forward at batch T_e*N -> raw output dict,
    T_e-major ordering (sample e of frame i at batch index e*N + i).

    For a UNet (or a model that wraps one as `model.unet`, SkewUNet, whose
    modes pass through to it) with `drop_block`, the deterministic encoder
    prefix (stem + every stage before the first dropout stage, the
    FLOP-heavy high-resolution part) runs ONCE at batch N and is tiled T_e
    times; only the stochastic tail runs at batch T_e*N. Exact against
    tiling the input: the prefix has no dropout, instance norm is per
    sample, and the tail draws the same masks from the generator in the
    same order. Any other model, or a UNet without `drop_block`, runs the
    tiled input."""
    inner = getattr(model, "unet", model)
    tile = lambda a: a.repeat((t_e,) + (1,) * (a.ndim - 1))
    if isinstance(inner, UNet) and inner.drop_block:
        prefix = model(img, mode="encode_prefix")
        tiled = {"skips": [tile(s) for s in prefix["skips"]]}
        return model(None, deterministic=False, generator=generator,
                     mode="decode_from_prefix", prefix=tiled)
    return model(tile(img), deterministic=False, generator=generator)


def is_ensemble(model) -> bool:
    """True for a deep ensemble: a list or tuple of member models."""
    return isinstance(model, (list, tuple))


def epistemic_samples(model, t_e: int) -> int:
    """T_e of a forward: the ensemble's member count, else the task's t_e."""
    return len(model) if is_ensemble(model) else t_e


def forward_views(model, img: torch.Tensor, t_e: int, generator: Generators) -> Dict:
    """The raw output dict of one view (N, C, H, W) or of V views
    (V, N, C, H, W) with one generator per view: per view the MC-dropout
    forward (`mc_dropout_apply`) at T_e > 1, the deterministic forward at
    T_e == 1, or, for a deep ensemble (a list of models; T_e its length),
    each member's deterministic forward in the list's order (dropout off,
    no generator drawn from); V views one forward each (per member),
    concatenated view-major (sample e of frame i of view v at
    (v*T_e + e)*N + i). A view's logits are then bitwise the ones it gets
    alone: a convolution's algorithm and a reduction's summation order may
    change with the batch size, and on a flat (untrained) heatmap bf16
    rounding of that size moves mu by tenths of a pixel."""
    if img.dim() == 4:
        img, generator = img[None], [generator]
    if is_ensemble(model):
        outs = [member(v) for v in img for member in model]
    else:
        outs = [mc_dropout_apply(model, v, t_e, g) if t_e > 1 else model(v)
                for v, g in zip(img, generator)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def per_frame_samples(a: torch.Tensor, lead, t_e: int) -> torch.Tensor:
    """(V*T_e*N, ...) outputs of `forward_views` -> (*lead, T_e, ...),
    lead = (N,) for one view or (V, N) for V views."""
    n = lead[-1]
    a = a.reshape(-1, t_e, n, *a.shape[1:]).transpose(1, 2)
    return a.reshape(*lead, t_e, *a.shape[3:])


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
                    generator: Optional[torch.Generator] = None) -> torch.nn.Module:
        """The backbone on `device` (default cuda), initialised from
        `generator` (a CPU generator gives the same weights on any device).
        `resnet` regresses (K, 2) coordinates with a sigma branch of 3
        parameters per point (2 without `covar`) unless the config sets
        `sigma_out`."""
        from contouring_uncertainty_torch.models import build_backbone

        device = resolve_device(device)
        c, h, w = self.data_params.in_shape
        k = self.data_params.out_shape[0]
        if self.model_name == "resnet":
            kwargs = {"sigma_out": 3 if self.covar else 2, **self.model_kwargs}
            model = build_backbone("resnet", (c, h, w), (k, 2), **kwargs)
        else:
            model = build_backbone(self.model_name, (c, h, w), (k, h, w), **self.model_kwargs)
        model.reset_parameters(generator)
        return model.to(device).eval()

    def _gaussians_from_out(self, out):
        """Model output dict -> (mu, cov): DSNT on heatmaps, or
        `regression_gaussians` on a regressor's (N, K, 2) coordinates."""
        o = out["out"]
        if o.dim() == 3:
            return regression_gaussians(o, out["sigma"], use_covar=self.covar)
        return dsnt_ops.logits_to_pixel_gaussians(o, use_covar=self.covar)

    def forward_gaussians(self, model, img, generator=None, mc_dropout=False):
        """img (N, C, H, W) -> (mu (N,K,2), sigma (N,K,2,2)) in pixel space."""
        return self._gaussians_from_out(
            model(img, deterministic=not mc_dropout, generator=generator))

    def _forward_loss(self, model, batch, generator: Optional[torch.Generator], train: bool):
        """One forward -> (loss, logs, mu); loss and validation share it.
        `train` turns the dropout on, its masks drawn from `generator`."""
        y = batch[Tags.contour]
        out = model(batch[Tags.img], deterministic=not train, generator=generator)
        mu, sigma = self._gaussians_from_out(out)
        point_loss, logdet, maha = dsnt_ops.gaussian_nll(
            mu, sigma, y, log_penalty_weight=self.log_penalty_weight,
            mse_weight=self.mse_weight)
        loss = point_loss.mean()
        logs = {
            "loss": loss,
            "distance_loss": dsnt_ops.euclidean_error(mu, y).mean(),
            "loss_term1": (self.log_penalty_weight * logdet).mean(),
            "loss_term2": (self.mse_weight * maha).mean(),
        }
        return loss, logs, mu

    def loss(self, model, batch, generator: Optional[torch.Generator] = None,
             train: bool = True):
        """(loss, logs) of one batch; logs hold `loss`, `distance_loss`,
        `loss_term1` (log|Sigma|) and `loss_term2` (Mahalanobis)."""
        loss, logs, _ = self._forward_loss(model, batch, generator, train)
        return loss, logs

    def val_metrics(self, model, batch) -> Dict[str, torch.Tensor]:
        """Validation loss and the Dice of the linear contour reconstruction
        against the LV label, from one deterministic forward.

        As in the JAX task, the Dice rasterizes the whole landmark vector as
        one closed polygon: exact for single-structure data (CAMUS LV)."""
        _, logs, mu = self._forward_loss(model, batch, None, train=False)
        h, w = batch[Tags.img].shape[-2:]
        pred = rasterize_batch(mu, h, w, linear=True)
        gt_bin = (batch[Tags.gt] == int(Label.LV)).to(torch.float32)
        return {**logs, "dice": dice_binary(pred, gt_bin).mean()}

    def predict(self, model, img, generator: Generators = None):
        """Epistemic-sampling forward of one view (N, C, H, W) -> mu
        (N, T_e, K, 2), cov (N, T_e, K, 2, 2), or of V views (V, N, C, H, W),
        with one generator per view, -> (V, N, T_e, ...). T_e > 1 uses one
        MC-dropout forward per view at batch T_e*N with the encoder prefix
        shared; T_e == 1 is deterministic; a deep ensemble (a list of
        models) gives T_e = its length, sample e from member e. The DSNT
        head runs once on all views' (and members') heatmaps: the moments
        are per heatmap, so this equals one head per member."""
        t_e = epistemic_samples(model, self.t_e)
        out = self._gaussians_from_out(forward_views(model, img, t_e, generator))
        return tuple(per_frame_samples(a, img.shape[:-3], t_e) for a in out)

    def val_figure(self, model, batch, max_items: int = 4):
        raise NotImplementedError("validation figures are not ported yet (ROADMAP.md "
                                  "Queue 1, item 13)")
