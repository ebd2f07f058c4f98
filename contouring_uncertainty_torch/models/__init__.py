"""Model zoo: the nnU-Net-style UNet (`unet2`, with its ConfidenceNet skew
head), DeepLabV3, the ResNet landmark regressor and ENet."""

from __future__ import annotations

import torch

from contouring_uncertainty_torch.models.unet import ConfidenceNet, UNet

# The config keys each backbone takes (those of the JAX package's
# `build_backbone`, and the UNet's serving `head_dtype`); the others of the
# shared model config are dropped.
ALLOWED_KWARGS = {
    "unet2": {"kernels", "strides", "deep_supervision", "attention", "drop_block",
              "residual", "out_seg_bias", "ssn_rank", "bottleneck_out", "dtype", "head_dtype"},
    "deeplabv3": {"layers", "base", "dropout", "n_heads", "ssn_rank", "bottleneck_out", "dtype"},
    "resnet": {"layers", "dropout", "sigma_out", "dtype"},
    "enet": {"init_channels", "dropout", "encoder_relu", "decoder_relu", "bottleneck_out",
             "n_heads", "ssn_rank", "dtype"},
}
ALLOWED_KWARGS["unet"] = ALLOWED_KWARGS["unet2"]


def as_dtype(dtype) -> torch.dtype:
    """torch dtype from a torch dtype or its name ("bfloat16", "float32")."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))


def check_backbone(name: str) -> None:
    """Raise ValueError on a model name no backbone answers to."""
    if name not in ALLOWED_KWARGS:
        raise ValueError(f"Unknown model '{name}'")


def build_backbone(name: str, input_shape, output_shape, **kwargs):
    """Model-zoo dispatch (counterpart of the JAX `models.build_backbone`):
    each backbone receives only the config keys it takes."""
    check_backbone(name)
    kwargs = {k: v for k, v in kwargs.items() if k in ALLOWED_KWARGS[name]}
    for key in ("dtype", "head_dtype"):
        if key in kwargs:
            kwargs[key] = as_dtype(kwargs[key])
    if "layers" in kwargs:
        kwargs["layers"] = tuple(kwargs["layers"])
    if name in ("unet2", "unet"):
        return UNet(input_shape=input_shape, output_shape=output_shape, **kwargs)
    if name == "deeplabv3":
        from contouring_uncertainty_torch.models.deeplabv3 import DeepLabV3

        return DeepLabV3(input_shape=input_shape, output_shape=output_shape, **kwargs)
    if name == "resnet":
        from contouring_uncertainty_torch.models.resnet import Resnet

        return Resnet(input_shape=input_shape, output_shape=output_shape, **kwargs)
    from contouring_uncertainty_torch.models.enet import Enet

    return Enet(input_shape=input_shape, output_shape=output_shape, **kwargs)
