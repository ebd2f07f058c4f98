"""Segmentation-space uncertainty baselines of the TMI paper: the base task,
MC dropout, aleatoric (per-pixel sigma), test-time augmentation and
Stochastic Segmentation Networks.

Counterpart of contouring_uncertainty_tpu/tasks/segmentation.py:

- `SegmentationUncertaintyTask`: CE (sigmoid for one channel, softmax
  otherwise) plus soft Dice, with the deep-supervision ladder when the
  model returns those heads; a deterministic forward for prediction;
- `McDropoutUncertainty`: T_e MC-dropout forwards with the encoder prefix
  shared, their rows in blocks (tasks/dsnt_al.py `mc_dropout_apply`; with
  a shard each rank runs its blocks); `drop_block` on by default;
- `AleatoricUncertainty`: logits and a softplus sigma head (`ssn_rank=1`),
  the CE of the MC-integrated probabilities over `iterations` draws;
- `TTAUncertainty`: T_a random geometric and intensity augmentations per
  view, one forward over the T_a*N warped images, logits warped back
  (data/augment.py `un_apply_logits`);
- `StochasticSegmentationNetwork`: a low-rank multivariate normal over the
  logits (mean, diagonal, rank-`rank` factor), the log of the MC-integrated
  likelihood with antithetic draws.

Signatures follow the port's tasks: `build_model(device, generator)`,
`loss(model, batch, generator, train)`, `val_metrics(model, batch)`, and
`predict_probs(model, img, generators)`, which takes one view (N, C, H, W)
and one generator, or V views (V, N, C, H, W) and one generator per view,
and returns probabilities (N, T_e, T_a, C, H, W), or (V, N, ...). Every
random number comes from the caller's generators through rng.py (dropout
masks, aleatoric and SSN normals, augmentation parameters): a view served
with others draws what it draws alone; a data-parallel training rank draws
its rows of the batch's (`rng.RowBlock`; the losses' normals hold the
batch on their second axis). Without a generator, the losses'
normals come from a generator seeded 0 (the JAX tasks' `key(0)`).
`val_figure` draws the validation panel the trainer logs each epoch
(matplotlib, imported inside it).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from contouring_uncertainty_torch.data import augment as aug
from contouring_uncertainty_torch.data.config import DataParams, Tags
from contouring_uncertainty_torch.device import DeviceLike, resolve_device
from contouring_uncertainty_torch.parallel.serving import NO_SHARD, SampleShard
from contouring_uncertainty_torch.rng import Generators, draw_normal, draw_uniform
from contouring_uncertainty_torch.tasks.dsnt_al import mc_block_rows, mc_dropout_apply
from contouring_uncertainty_torch.utils.metrics import soft_dice


def _seg_channels(data_params: DataParams) -> int:
    n_labels = len(data_params.labels)
    return 1 if n_labels <= 2 else n_labels


def _as_views(img: torch.Tensor, generators: Generators):
    """(views (V, N, C, H, W), one generator per view, whether one view
    (N, C, H, W) was given)."""
    if img.dim() == 4:
        return img[None], [generators], True
    gens = [None] * len(img) if generators is None else list(generators)
    if len(gens) != len(img):
        raise ValueError(f"{len(img)} views need as many generators, got {len(gens)}")
    return img, gens, False


def _noise_generator(generator: Optional[torch.Generator], device) -> torch.Generator:
    return generator if generator is not None else torch.Generator(device=device).manual_seed(0)


def activate(logits: torch.Tensor) -> torch.Tensor:
    """Sigmoid of one-channel logits, else a softmax over the channel axis
    (-3 of (..., C, H, W)), in f32 at least (bf16 logits of a bf16 head
    give f32 probabilities)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    if logits.shape[-3] == 1:
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-3)


def tta_params(generators: Generators, views: int, t_a: int, n: int,
               device) -> aug.AugmentParams:
    """Augmentation parameters of `views` views' T_a draws of n frames,
    (views * t_a * n,) view-major, then draw, then frame; view v's from
    generator v, uniform in the training augmentation's ranges."""
    cfg = aug.AugmentConfig()
    u = draw_uniform(generators, (views, 6, t_a, n), device=device)
    u = u.transpose(0, 1).reshape(6, -1)
    lo = torch.tensor([-cfg.degrees, -cfg.translate[0], -cfg.translate[1], -cfg.brightness,
                       -cfg.contrast, cfg.gamma[0]], device=device)[:, None]
    hi = torch.tensor([cfg.degrees, cfg.translate[0], cfg.translate[1], cfg.brightness,
                       cfg.contrast, cfg.gamma[1]], device=device)[:, None]
    v = lo + (hi - lo) * u
    return aug.AugmentParams(v[0], v[1:3].T.contiguous(), v[3], v[4], v[5])


def _slice_params(params: aug.AugmentParams, start: int, stop: int) -> aug.AugmentParams:
    return aug.AugmentParams(*(p[start:stop] for p in params))


@dataclass
class SegmentationUncertaintyTask:
    """Base segmentation task: Dice + CE loss, deep-supervision ladder."""

    data_params: DataParams
    ce_weight: float = 0.1
    dice_weight: float = 1.0
    t_a: int = 25
    t_e: int = 1
    model_kwargs: Dict[str, Any] = field(default_factory=dict)
    model_name: str = "unet2"
    task_name: str = "segmentation"

    @property
    def n_channels(self) -> int:
        return _seg_channels(self.data_params)

    def build_model(self, device: DeviceLike = None,
                    generator: Optional[torch.Generator] = None) -> torch.nn.Module:
        """The backbone on `device` (default cuda), initialised from
        `generator` (a CPU generator gives the same weights on any device)."""
        from contouring_uncertainty_torch.models import build_backbone

        device = resolve_device(device)
        c, h, w = self.data_params.in_shape
        model = build_backbone(self.model_name, (c, h, w), (self.n_channels, h, w),
                               **self.model_kwargs)
        model.reset_parameters(generator)
        return model.to(device).eval()

    # -------------------------------------------------------------------- loss

    def compute_loss(self, y: torch.Tensor, logits: torch.Tensor):
        """y (N, H, W) int labels, logits (N, C, H, W) -> (loss, ce, dice)."""
        if logits.shape[1] == 1:
            target = (y > 0).to(torch.float32)
            log_p = F.logsigmoid(logits[:, 0])
            log_1mp = F.logsigmoid(-logits[:, 0])
            ce = -(target * log_p + (1 - target) * log_1mp).mean()
        else:
            onehot = F.one_hot(y.long(), logits.shape[1]).permute(0, 3, 1, 2).to(logits.dtype)
            ce = -(onehot * F.log_softmax(logits, dim=1)).sum(1).mean()
        dice = soft_dice(activate(logits), y, self.n_channels)
        loss = self.ce_weight * ce + self.dice_weight * (1.0 - dice.mean())
        return loss, ce, dice.mean()

    def loss(self, model, batch, generator: Optional[torch.Generator] = None,
             train: bool = True):
        """(loss, logs) of one batch; logs hold `loss`, `ce` and `dice`.
        In training, deep-supervision heads add 0.5^(i+1) of their loss on
        the labels subsampled to their size, and the sum is divided by
        2 - 2^-(n+1)."""
        img, y = batch[Tags.img], batch[Tags.gt]
        out = model(img, deterministic=not train, generator=generator, train=train)
        loss, ce, dice = self.compute_loss(y, out["out"])
        heads = out.get("deep_supervision") if train else None
        if heads:
            for i, head in enumerate(heads):
                factor = y.shape[-2] // head.shape[-2]
                l_ds, _, _ = self.compute_loss(y[:, ::factor, ::factor], head)
                loss = loss + 0.5 ** (i + 1) * l_ds
            loss = loss / (2.0 - 2.0 ** (-(len(heads) + 1)))
        return loss, {"loss": loss, "ce": ce, "dice": dice}

    def val_metrics(self, model, batch) -> Dict[str, torch.Tensor]:
        return self.loss(model, batch, None, train=False)[1]

    def val_figure(self, model, batch, max_items: int = 4):
        """Overlay panel of the first `max_items` images of a batch: each
        image, its predicted label map (one deterministic forward) and the
        reference boundary. Returns a matplotlib figure; matplotlib is
        imported before the forward."""
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        img = batch[Tags.img][:max_items]
        with torch.no_grad():
            probs = activate(model(img)["out"]).float().cpu().numpy()
        if probs.shape[1] == 1:
            pred = (probs[:, 0] > 0.5).astype(np.int32)
        else:
            pred = probs.argmax(axis=1)
        n = img.shape[0]
        fig, axes = plt.subplots(1, n, figsize=(3 * n, 3), squeeze=False)
        gt = batch.get(Tags.gt)
        for i, ax in enumerate(axes[0]):
            ax.imshow(img[i, 0].float().cpu().numpy(), cmap="gray")
            ax.imshow(pred[i], alpha=0.35, cmap="viridis",
                      interpolation="nearest")
            if gt is not None:
                ax.contour(gt[i].cpu().numpy(), levels=[0.5], colors="lime",
                           linewidths=0.8)
            ax.set_axis_off()
        fig.tight_layout()
        return fig

    # ----------------------------------------------------------------- predict

    def predict_probs(self, model, img: torch.Tensor, generators: Generators = None,
                      shard: SampleShard = NO_SHARD):
        """Probabilities (N, T_e, T_a, C, H, W) of one view, or of V views
        (V, N, ...). Base: one deterministic forward per view. `shard` (the
        latency and composed modes) splits only the MC-dropout forward of
        `McDropoutUncertainty`; the other tasks' forwards are whole."""
        imgs, _, single = _as_views(img, generators)
        probs = torch.stack([activate(model(v)["out"]) for v in imgs])[:, :, None, None]
        return probs[0] if single else probs


@dataclass
class McDropoutUncertainty(SegmentationUncertaintyTask):
    """T_e MC-dropout forwards per view."""

    task_name: str = "mcdropout"

    def build_model(self, device: DeviceLike = None,
                    generator: Optional[torch.Generator] = None):
        if self.model_name in ("unet2", "unet"):
            self.model_kwargs.setdefault("drop_block", True)
        return super().build_model(device, generator)

    def predict_probs(self, model, img, generators: Generators = None,
                      shard: SampleShard = NO_SHARD):
        """Per view one MC-dropout forward of the T_e*N rows in blocks, the
        encoder prefix shared, its masks from the view's generator. With a
        `shard` (T_e > 1) each rank runs its blocks of the rows and the
        logits are gathered."""
        imgs, gens, single = _as_views(img, generators)
        n = imgs.shape[1]
        split = shard if self.t_e > 1 else NO_SHARD
        logits = torch.stack([mc_dropout_apply(model, v, self.t_e, g, split)["out"]
                              for v, g in zip(imgs, gens)])  # (V, this rank's rows, C, H, W)
        logits = split.gather(logits, 1, self.t_e * n, mc_block_rows(self.t_e, n))
        probs = activate(logits).unflatten(1, (self.t_e, n)).transpose(1, 2)[:, :, :, None]
        return probs[0] if single else probs


@dataclass
class AleatoricUncertainty(SegmentationUncertaintyTask):
    """Logits and a per-pixel sigma head with an MC-integrated CE."""

    iterations: int = 10
    task_name: str = "aleatoric"

    def build_model(self, device: DeviceLike = None,
                    generator: Optional[torch.Generator] = None):
        self.model_kwargs["ssn_rank"] = 1
        return super().build_model(device, generator)

    def loss(self, model, batch, generator: Optional[torch.Generator] = None,
             train: bool = True):
        img, y = batch[Tags.img], batch[Tags.gt]
        out = model(img, deterministic=not train, generator=generator, train=train)
        logits = out["out"]
        sigma = F.softplus(out["ssn"][0]) + 1e-8
        eps = draw_normal(_noise_generator(generator, img.device),
                          (self.iterations, *logits.shape), device=logits.device, batch_axis=1)
        x_hat = logits[None] + sigma[None] * eps
        if logits.shape[1] == 1:
            mc = torch.sigmoid(x_hat).mean(0)  # (N, 1, H, W)
            target = (y > 0).to(torch.float32)
            ce = -(target * torch.log(mc[:, 0] + 1e-8)
                   + (1 - target) * torch.log(1 - mc[:, 0] + 1e-8)).mean()
        else:
            mc = torch.softmax(x_hat, dim=2).mean(0)
            onehot = F.one_hot(y.long(), logits.shape[1]).permute(0, 3, 1, 2).to(mc.dtype)
            ce = -(onehot * torch.log(mc + 1e-8)).sum(1).mean()
        dice = soft_dice(mc, y, self.n_channels)
        loss = self.ce_weight * ce + self.dice_weight * (1.0 - dice.mean())
        return loss, {"loss": loss, "ce": ce, "dice": dice.mean()}

    def predict_probs(self, model, img, generators: Generators = None,
                      shard: SampleShard = NO_SHARD):
        """Per view one deterministic forward, then T_a draws of
        logits + sigma * eps, eps from the view's generator."""
        imgs, gens, single = _as_views(img, generators)
        outs = [model(v) for v in imgs]
        logits = torch.stack([o["out"] for o in outs])  # (V, N, C, H, W)
        sigma = torch.stack([F.softplus(o["ssn"][0]) + 1e-8 for o in outs])
        eps = draw_normal(gens, (len(imgs), self.t_a, *logits.shape[1:]), device=logits.device)
        probs = activate(logits[:, None] + sigma[:, None] * eps)  # (V, T_a, N, C, H, W)
        probs = probs.transpose(1, 2)[:, :, None]
        return probs[0] if single else probs


@dataclass
class TTAUncertainty(SegmentationUncertaintyTask):
    """Test-time augmentation with inverse-warped logits."""

    task_name: str = "tta"

    def predict_probs(self, model, img, generators: Generators = None,
                      shard: SampleShard = NO_SHARD):
        """Per view T_a parameter sets for its N frames, one forward over
        the T_a*N warped images (draw-major), the logits warped back in f32."""
        imgs, gens, single = _as_views(img, generators)
        v_n, n = imgs.shape[:2]
        params = tta_params(gens, v_n, self.t_a, n, imgs.device)
        per_view = self.t_a * n
        probs = []
        for v, view in enumerate(imgs):
            p = _slice_params(params, v * per_view, (v + 1) * per_view)
            warped = aug.apply({"img": view.repeat(self.t_a, 1, 1, 1)}, p)["img"]
            logits = aug.un_apply_logits(model(warped)["out"].to(torch.float32), p)
            probs.append(activate(logits).unflatten(0, (self.t_a, n)).transpose(0, 1))
        probs = torch.stack(probs)[:, :, None]  # (V, N, 1, T_a, C, H, W)
        return probs[0] if single else probs


@dataclass
class StochasticSegmentationNetwork(SegmentationUncertaintyTask):
    """A low-rank multivariate normal over the logits."""

    rank: int = 10
    mc_samples: int = 20
    epsilon: float = 1e-5
    diagonal: bool = False
    task_name: str = "ssn"

    def build_model(self, device: DeviceLike = None,
                    generator: Optional[torch.Generator] = None):
        self.model_kwargs["ssn_rank"] = self.rank
        return super().build_model(device, generator)

    def _distribution_params(self, out):
        """Outputs of (..., N) frames -> mean (..., N, D), diag (..., N, D)
        and factor (..., N, D, R), D = C*H*W. The factor head's channels are
        rank-major: channel r*C + c is rank r of class c."""
        logits = out["out"]
        c = logits.shape[-3]
        mean = logits.flatten(-3)
        diag = torch.exp(out["ssn"][0]).flatten(-3) + self.epsilon
        f = out["ssn"][1]
        factor = f.reshape(*f.shape[:-3], self.rank, c * f.shape[-2] * f.shape[-1])
        return mean, diag, factor.transpose(-1, -2)

    def _sample_logits(self, generators: Generators, mean, diag, factor, num: int,
                       antithetic: bool = True):
        """num draws from N(mean, F F^T + diag): (..., num, N, D) for
        parameters of (..., N) frames. The factor normals (..., half, N, R)
        are drawn first, then the diagonal's (..., half, N, D); antithetic
        draws take half = ceil(num / 2) and append their negations."""
        *lead, n, d = mean.shape
        half = (num + 1) // 2 if antithetic else num
        eps_f = draw_normal(generators, (*lead, half, n, self.rank), device=mean.device,
                            batch_axis=-2)
        eps_d = draw_normal(generators, (*lead, half, n, d), device=mean.device, batch_axis=-2)
        scale = torch.sqrt(diag).unsqueeze(-3)
        if self.diagonal:
            dev = scale * eps_d
        else:
            dev = torch.einsum("...ndr,...snr->...snd", factor, eps_f) + scale * eps_d
        if antithetic:
            dev = torch.cat([dev, -dev], dim=-3)[..., :num, :, :]
        return mean.unsqueeze(-3) + dev

    def loss(self, model, batch, generator: Optional[torch.Generator] = None,
             train: bool = True):
        """The negative log of the likelihood averaged over `mc_samples`
        logit draws (a logsumexp over the draws of the per-image sums)."""
        img, y = batch[Tags.img], batch[Tags.gt]
        out = model(img, deterministic=not train, generator=generator, train=train)
        mean, diag, factor = self._distribution_params(out)
        num = self.mc_samples
        samples = self._sample_logits(_noise_generator(generator, img.device), mean, diag,
                                      factor, num)  # (S, N, D)
        n, c = img.shape[0], self.n_channels
        hw = y.shape[-2] * y.shape[-1]
        logit_s = samples.reshape(num, n, c, hw)
        if c == 1:
            target = (y > 0).to(torch.float32).reshape(1, n, hw)
            x = logit_s[:, :, 0]
            logp = -torch.clamp(x, min=0) + x * target - torch.log1p(torch.exp(-x.abs()))
        else:
            target = y.long().reshape(1, n, 1, hw).expand(num, n, 1, hw)
            logp = torch.gather(F.log_softmax(logit_s, dim=2), 2, target)[:, :, 0]
        loglik = torch.logsumexp(logp.sum(-1), dim=0) - math.log(num)
        loss = -loglik.mean()
        dice = soft_dice(activate(out["out"]), y, c)
        return loss, {"loss": loss, "ce": loss, "dice": dice.mean()}

    def predict_probs(self, model, img, generators: Generators = None,
                      shard: SampleShard = NO_SHARD):
        """Per view one deterministic forward, then T_a logit draws (not
        antithetic) from the view's generator."""
        imgs, gens, single = _as_views(img, generators)
        outs = [model(v) for v in imgs]
        out = {"out": torch.stack([o["out"] for o in outs]),
               "ssn": [torch.stack([o["ssn"][i] for o in outs]) for i in range(2)]}
        mean, diag, factor = self._distribution_params(out)
        samples = self._sample_logits(gens, mean, diag, factor, self.t_a, antithetic=False)
        probs = activate(samples.unflatten(-1, out["out"].shape[-3:]))  # (V, T_a, N, C, H, W)
        probs = probs.transpose(1, 2)[:, :, None]
        return probs[0] if single else probs
