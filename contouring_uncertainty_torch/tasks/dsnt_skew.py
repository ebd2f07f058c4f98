"""DSNT-skew task: heatmaps and a bottleneck ConfidenceNet -> per-point
bivariate skew-normal (MICCAI 2023 asymmetric contour uncertainty).

Counterpart of contouring_uncertainty_tpu/tasks/dsnt_skew.py: the backbone
(UNet, DeepLabV3 or Enet) runs with `bottleneck_out`, a ConfidenceNet head
regresses 2 |skew_indices| alpha values, scattered into the (N, K, 2)
alpha tensor (zeros elsewhere);
the loss is the skew-normal NLL 0.5 log|S| + 0.5 maha - log Phi, and at
predict time alpha's y component is flipped (the image's y axis points
down; the skew PSM sampler flips it once more, as in the JAX package).
`freeze_seg` trains the skew head alone (`optimizer_labels`).

The DSNT head goes through the moment kernel (K2 on the card) and the
validation Dice's linear polygons through the crossing selection (K3), as
in DSNT-AL, whose `loss` and `val_metrics` this task inherits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from contouring_uncertainty_torch.data.config import Tags
from contouring_uncertainty_torch.device import DeviceLike, resolve_device
from contouring_uncertainty_torch.distributions import bsn
from contouring_uncertainty_torch.models.unet import ConfidenceNet
from contouring_uncertainty_torch.ops import dsnt as dsnt_ops
from contouring_uncertainty_torch.parallel.serving import NO_SHARD, SampleShard
from contouring_uncertainty_torch.rng import Generators
from contouring_uncertainty_torch.tasks.dsnt_al import DSNTAleatoric


class SkewUNet(nn.Module):
    """Backbone (`unet`) + ConfidenceNet skew head (`confidence_net`) over
    the bottleneck features; the two names are the flax tree's, so
    convert.py maps it one to one."""

    def __init__(self, unet: nn.Module, n_skew: int):
        super().__init__()
        if not getattr(unet, "bottleneck_out", False):
            raise ValueError(f"SkewUNet needs a backbone built with bottleneck_out=True "
                             f"(a UNet, DeepLabV3 or Enet), got {type(unet).__name__}")
        self.unet = unet
        self.n_skew = n_skew
        self.confidence_net = ConfidenceNet(unet.bottleneck_shape, 2 * n_skew)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.unet.reset_parameters(generator)
        self.confidence_net.reset_parameters(generator)

    def forward(self, x: Optional[torch.Tensor], deterministic: bool = True,
                generator: Optional[torch.Generator] = None, mode: str = "full",
                prefix: Optional[dict] = None):
        """The UNet's modes; every mode but "encode_prefix" adds
        "alpha_raw" (N, n_skew, 2) f32 to the output."""
        out = self.unet(x, deterministic, generator, mode=mode, prefix=prefix)
        if mode == "encode_prefix":
            return out
        a = self.confidence_net(out["bottleneck"])
        return {**out, "alpha_raw": a.reshape(a.shape[0], self.n_skew, 2)}


@dataclass
class DSNTSkew(DSNTAleatoric):
    """Skew task config; the DSNT pipeline is DSNTAleatoric's."""

    skew_indices: Optional[Tuple[int, ...]] = None
    task_name: str = "dsnt-skew"
    # Two-stage fine-tune: freeze the segmentation backbone and train only
    # the ConfidenceNet skew head (task.freeze_seg=true).
    freeze_seg: bool = False

    def optimizer_labels(self, model: nn.Module) -> Optional[Dict[str, str]]:
        """Parameter name -> "freeze" for the backbone (`unet.*`), "train"
        for the rest; None when freeze_seg is off. The trainer leaves the
        frozen ones out of the optimizer, as optax's set_to_zero leaves them
        unchanged, weight decay included."""
        if not self.freeze_seg:
            return None
        return {name: "freeze" if name.startswith("unet.") else "train"
                for name, _ in model.named_parameters()}

    def _indices(self) -> Tuple[int, ...]:
        k = self.data_params.out_shape[0]
        return tuple(range(k)) if self.skew_indices is None else tuple(self.skew_indices)

    def build_model(self, device: DeviceLike = None,
                    generator: Optional[torch.Generator] = None) -> SkewUNet:
        """The SkewUNet on `device` (default cuda), initialised from
        `generator` (a CPU generator gives the same weights on any device)."""
        from contouring_uncertainty_torch.models import build_backbone

        device = resolve_device(device)
        c, h, w = self.data_params.in_shape
        k = self.data_params.out_shape[0]
        backbone = build_backbone(self.model_name, (c, h, w), (k, h, w),
                                  **{**self.model_kwargs, "bottleneck_out": True})
        model = SkewUNet(backbone, len(self._indices()))
        model.reset_parameters(generator)
        return model.to(device).eval()

    def _scatter_alpha(self, alpha_raw: torch.Tensor) -> torch.Tensor:
        """(N, K*, 2) head output -> (N, K, 2) alpha with zeros elsewhere."""
        k = self.data_params.out_shape[0]
        alpha = alpha_raw.new_zeros((alpha_raw.shape[0], k, 2))
        idx = torch.tensor(self._indices(), dtype=torch.long, device=alpha_raw.device)
        return alpha.index_copy(1, idx, alpha_raw)

    def _forward_loss(self, model, batch, generator: Optional[torch.Generator], train: bool):
        """One forward -> (loss, logs, mu). Logs: `loss`, `distance_loss`,
        `loss_term1` (log|Sigma|), `loss_term2` (Mahalanobis), `loss_term3`
        (log Phi of the whitened skew term) and `alpha_norm`."""
        y = batch[Tags.contour]
        out = model(batch[Tags.img], deterministic=not train, generator=generator)
        mu, sigma = dsnt_ops.logits_to_pixel_gaussians(out["out"], use_covar=self.covar)
        alpha = self._scatter_alpha(out["alpha_raw"])
        point_loss, logdet, maha, term3 = bsn.nll(y, mu, sigma, alpha)
        loss = point_loss.mean()
        logs = {
            "loss": loss,
            "distance_loss": dsnt_ops.euclidean_error(mu, y).mean(),
            "loss_term1": logdet.mean(),
            "loss_term2": maha.mean(),
            "loss_term3": term3.mean(),
            "alpha_norm": torch.linalg.vector_norm(alpha, dim=-1).mean(),
        }
        return loss, logs, mu

    def _outputs_to_skew(self, out, whole_rows: Optional[int] = None):
        mu, sigma = dsnt_ops.logits_to_pixel_gaussians(out["out"], use_covar=self.covar,
                                                       whole_rows=whole_rows)
        alpha = self._scatter_alpha(out["alpha_raw"])
        # Test-time y flip: the image's y axis points down.
        alpha = alpha * torch.tensor([1.0, -1.0], dtype=alpha.dtype, device=alpha.device)
        return mu, sigma, alpha

    def forward_skew(self, model, img, generator=None, mc_dropout=False):
        """img (N, C, H, W) -> (mu (N,K,2), sigma (N,K,2,2), alpha (N,K,2))."""
        return self._outputs_to_skew(
            model(img, deterministic=not mc_dropout, generator=generator))

    def predict(self, model, img, generator: Generators = None,
                shard: SampleShard = NO_SHARD):
        """-> mu (N, T_e, K, 2), cov (N, T_e, K, 2, 2), alpha (N, T_e, K, 2)
        for one view (N, C, H, W); (V, N, T_e, ...) for V views (V, N, C, H,
        W), with one generator per view. T_e > 1 uses one MC-dropout forward
        per view with the encoder prefix shared, its T_e*N rows in blocks;
        T_e == 1 is deterministic; a deep ensemble (a list of models) gives
        T_e = its length, each member's forward deterministic. The DSNT head
        runs once on all views' heatmaps. With a `shard`, each rank runs its
        blocks of the MC-dropout rows, the DSNT head and the ConfidenceNet on
        them, and every rank gets the gathered (mu, cov, alpha)."""
        return self._served_outputs(model, img, generator, shard, self._outputs_to_skew)
