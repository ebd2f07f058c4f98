"""DSNT-AL task: U-Net heatmaps -> DSNT -> per-point bivariate Gaussians.

Counterpart of contouring_uncertainty_tpu/tasks/dsnt_al.py: `build_model`
(every backbone; the Resnet regressor's coordinates go through
`regression_gaussians` instead of DSNT),
`forward_gaussians`, `predict` and `mc_dropout_apply` (serving; `predict`
takes one model or a deep ensemble, a list of models; the MC-dropout rows
run in blocks of `mc_block_rows`, which a `SampleShard` deals out to the
ranks of the latency and composed modes), `loss` and
`val_metrics` (training: the per-point Gaussian NLL, and the validation Dice
of the linear contour reconstruction, rasterized through the crossing
selection) and `val_figure` (the validation panel the trainer logs each
epoch; matplotlib, imported inside it).

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
from contouring_uncertainty_torch.parallel.serving import NO_SHARD, SampleShard
from contouring_uncertainty_torch.rng import Generators, rewinder, row_block
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


def mc_block_rows(t_e: int, n: int) -> int:
    """Rows of one block of the T_e*N Monte-Carlo dropout rows: T_e / p
    epistemic samples of N rows, p the smallest prime factor of T_e (at
    T_e = 10, N = 2 two blocks of 10 rows; at T_e = 3 three of N); all N
    rows at T_e = 1. It depends on T_e and N only, never on the ranks or
    the device: one process and every rank then run the tail's
    convolutions on the same batch shapes, whose algorithms (and rounding)
    cuDNN picks by the batch size."""
    p = next(d for d in range(2, t_e + 1) if t_e % d == 0) if t_e > 1 else 1
    return t_e // p * n


def mc_dropout_apply(model: torch.nn.Module, img: torch.Tensor, t_e: int,
                     generator: Optional[torch.Generator], shard: SampleShard = NO_SHARD
                     ) -> Dict:
    """The MC-dropout forward of the T_e*N rows -> raw output dict,
    T_e-major ordering (sample e of frame i at batch index e*N + i).

    For a UNet (or a model that wraps one as `model.unet`, SkewUNet, whose
    modes pass through to it) with `drop_block`, the deterministic encoder
    prefix (stem + every stage before the first dropout stage, the
    FLOP-heavy high-resolution part) runs ONCE at batch N and is tiled;
    only the stochastic tail runs on the T_e*N rows. Exact against tiling
    the input: the prefix has no dropout, instance norm is per sample, and
    the tail draws the same masks from the generator in the same order. Any
    other model, or a UNet without `drop_block`, runs the tiled input.

    The rows run in blocks of `mc_block_rows(t_e, N)`, one after another,
    each from the generator's state before the forward and with its rows of
    the whole batch's dropout masks (`rng.RowBlock`), so the generator ends
    where one forward of the whole batch leaves it. With a `shard` of k
    ranks this rank runs only its blocks (`SampleShard.part` in blocks) and
    the output holds its rows: between them the ranks run exactly the
    forwards one process runs, on the same shapes. A rank with no block
    runs the tail on no rows, which still makes the masks' draws."""
    n = img.shape[0]
    total, block = t_e * n, mc_block_rows(t_e, n)
    mine = shard.part(total, block)
    tile = lambda a, m: a.repeat((m,) + (1,) * (a.ndim - 1))
    inner = getattr(model, "unet", model)
    if isinstance(inner, UNet) and inner.drop_block:
        skips = model(img, mode="encode_prefix")["skips"]
        run = lambda m, g: model(None, deterministic=False, generator=g,
                                 mode="decode_from_prefix",
                                 prefix={"skips": [tile(s, m) for s in skips]})
    else:
        run = lambda m, g: model(tile(img, m), deterministic=False, generator=g)
    rewind, outs = rewinder(generator), []
    for start in range(mine.start, mine.stop, block) or [mine.start]:
        rewind()
        rows = slice(start, min(start + block, mine.stop))
        outs.append(run((rows.stop - rows.start) // n, row_block(generator, rows, total)))
    return {k: outs[0][k] if len(outs) == 1 else torch.cat([o[k] for o in outs])
            for k in outs[0]}


def is_ensemble(model) -> bool:
    """True for a deep ensemble: a list or tuple of member models."""
    return isinstance(model, (list, tuple))


def epistemic_samples(model, t_e: int) -> int:
    """T_e of a forward: the ensemble's member count, else the task's t_e."""
    return len(model) if is_ensemble(model) else t_e


def splits_forward(model, t_e: int) -> bool:
    """Whether `forward_views` runs the MC-dropout forward, whose rows a
    shard splits: T_e > 1 and one model. A deep ensemble's members and the
    deterministic forward (T_e = 1) run whole on every rank, as the JAX
    package's ensemble loop and deterministic forward ignore its mesh."""
    return t_e > 1 and not is_ensemble(model)


def forward_views(model, img: torch.Tensor, t_e: int, generator: Generators,
                  shard: SampleShard = NO_SHARD) -> Dict:
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
    rounding of that size moves mu by tenths of a pixel.

    With a `shard` (where `splits_forward`), each view's rows are this
    rank's blocks of them only, view-major; `gather_views` puts the views'
    rows back together."""
    if img.dim() == 4:
        img, generator = img[None], [generator]
    if is_ensemble(model):
        outs = [member(v) for v in img for member in model]
    else:
        outs = [mc_dropout_apply(model, v, t_e, g, shard) if t_e > 1 else model(v)
                for v, g in zip(img, generator)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def gather_views(a: torch.Tensor, views: int, t_e: int, n: int,
                 shard: SampleShard) -> torch.Tensor:
    """(views * this rank's rows, ...) outputs of `forward_views` on a
    shard -> (views * T_e * N, ...), every rank's blocks in order."""
    if shard.k == 1:
        return a
    return shard.gather(a.unflatten(0, (views, -1)), 1, t_e * n,
                        mc_block_rows(t_e, n)).flatten(0, 1)


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

    def _gaussians_from_out(self, out, whole_rows: Optional[int] = None):
        """Model output dict -> (mu, cov): DSNT on heatmaps, or
        `regression_gaussians` on a regressor's (N, K, 2) coordinates.
        `whole_rows`: the heatmaps of the whole batch when `out` holds one
        rank's rows of it (the DSNT kernel's band count is the whole
        batch's)."""
        o = out["out"]
        if o.dim() == 3:
            return regression_gaussians(o, out["sigma"], use_covar=self.covar)
        return dsnt_ops.logits_to_pixel_gaussians(o, use_covar=self.covar,
                                                  whole_rows=whole_rows)

    def _served_outputs(self, model, img, generator: Generators, shard: SampleShard,
                        head) -> tuple:
        """`head(output dict, the whole batch's heatmaps or None)` ->
        tensors per row, on the forward of `predict`: with a shard
        (`splits_forward`), the head runs on this rank's rows and its
        outputs are gathered, 6 floats a heatmap instead of its logits.
        -> each output (..., T_e, ...)."""
        t_e = epistemic_samples(model, self.t_e)
        views = img.shape[0] if img.dim() == 5 else 1
        n = img.shape[-4]
        split = shard if splits_forward(model, t_e) else NO_SHARD
        out = forward_views(model, img, t_e, generator, split)
        outs = head(out, None if split.k == 1 else views * t_e * n * out["out"].shape[1])
        return tuple(per_frame_samples(gather_views(a, views, t_e, n, split), img.shape[:-3], t_e)
                     for a in outs)

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

    def predict(self, model, img, generator: Generators = None,
                shard: SampleShard = NO_SHARD):
        """Epistemic-sampling forward of one view (N, C, H, W) -> mu
        (N, T_e, K, 2), cov (N, T_e, K, 2, 2), or of V views (V, N, C, H, W),
        with one generator per view, -> (V, N, T_e, ...). T_e > 1 uses one
        MC-dropout forward per view with the encoder prefix shared, its
        T_e*N rows in blocks; T_e == 1 is deterministic; a deep ensemble (a
        list of models) gives T_e = its length, sample e from member e. The
        DSNT head runs once on all views' (and members') heatmaps: the
        moments are per heatmap, so this equals one head per member. With a
        `shard` (the latency and composed modes) each rank runs its blocks
        of the MC-dropout rows and the head on them, and every rank gets
        the gathered (mu, cov)."""
        return self._served_outputs(model, img, generator, shard, self._gaussians_from_out)

    def val_figure(self, model, batch, max_items: int = 4):
        """Contour-overlay panel of the first `max_items` images of a batch:
        each image with its reference landmarks, the predicted means and
        their 2-sigma confidence ellipses. Returns a matplotlib figure.
        matplotlib is imported before the forward, so without it nothing
        runs on the device."""
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        from contouring_uncertainty_torch.utils.plotting import confidence_ellipse

        img = batch[Tags.img][:max_items]
        with torch.no_grad():
            mu, sigma = self.forward_gaussians(model, img)
        mu = mu.float().cpu().numpy()
        sigma = sigma.float().cpu().numpy()
        n = img.shape[0]
        fig, axes = plt.subplots(1, n, figsize=(3 * n, 3), squeeze=False)
        gt = batch.get(Tags.contour)
        for i, ax in enumerate(axes[0]):
            ax.imshow(img[i, 0].float().cpu().numpy(), cmap="gray")
            if gt is not None:
                g = gt[i].cpu().numpy()
                ax.scatter(g[:, 0], g[:, 1], s=6, c="lime", label="gt")
            ax.scatter(mu[i, :, 0], mu[i, :, 1], s=6, c="red", label="pred")
            for k in range(mu.shape[1]):
                confidence_ellipse(mu[i, k, 0], mu[i, k, 1], sigma[i, k], ax,
                                   n_std=2.0, edgecolor="orange", alpha=0.6)
            ax.set_axis_off()
        axes[0, 0].legend(loc="lower right", fontsize=6)
        fig.tight_layout()
        return fig
