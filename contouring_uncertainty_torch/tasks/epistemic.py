"""Pure-epistemic contour task: statistics over T_e stochastic forwards.

Counterpart of contouring_uncertainty_tpu/tasks/epistemic.py: a DSNT-AL
task whose aleatoric covariances are zeroed, so the predictor's fusion
(mean covariance + spread of the means) reduces to the spread of the T_e
MC-dropout forwards. It trains as DSNT-AL and is served by
`predict.AleatoricPredictor`, through the moment kernel (K2) and the
crossing selection (K3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from contouring_uncertainty_torch.device import DeviceLike
from contouring_uncertainty_torch.parallel.serving import NO_SHARD, SampleShard
from contouring_uncertainty_torch.rng import Generators
from contouring_uncertainty_torch.tasks.dsnt_al import DSNTAleatoric


@dataclass
class EpistemicUncertainty(DSNTAleatoric):
    task_name: str = "epistemic"

    def build_model(self, device: DeviceLike = None,
                    generator: Optional[torch.Generator] = None):
        """The backbone with MC dropout forced on when T_e > 1 (without it
        the T_e forwards would be identical): the UNet's `drop_block`, or
        `dropout=0.1` on the other backbones where their config has none."""
        if self.t_e > 1:
            if self.model_name in ("unet2", "unet"):
                self.model_kwargs["drop_block"] = True
            elif self.model_name in ("enet", "deeplabv3", "resnet"):
                if not self.model_kwargs.get("dropout"):
                    print("[epistemic] forcing model dropout=0.1 (t_e > 1 "
                          "requires stochastic forwards)")
                    self.model_kwargs["dropout"] = 0.1
        return super().build_model(device, generator)

    def predict(self, model, img, generator: Generators = None,
                shard: SampleShard = NO_SHARD):
        """The DSNT-AL means (..., T_e, K, 2) with covariances of zero (with
        a `shard`, its forward split as DSNT-AL's)."""
        mu_te, cov_te = super().predict(model, img, generator=generator, shard=shard)
        return mu_te, torch.zeros_like(cov_te)

    def predict_point_stats(self, model, img, generator: Generators = None):
        """-> (mu (..., K, 2), cov (..., K, 2, 2)): the mean and covariance
        of the T_e forwards' means."""
        mu_te, _ = self.predict(model, img, generator=generator)
        mu = mu_te.mean(dim=-3)
        d = mu_te - mu.unsqueeze(-3)
        return mu, (d[..., :, None] * d[..., None, :]).mean(dim=-4)
