"""Model zoo: the nnU-Net-style UNet (`unet2`) and its ConfidenceNet skew head."""

from __future__ import annotations

import torch

from contouring_uncertainty_torch.models.unet import ConfidenceNet, UNet

# Backbones and UNet flags of the JAX package that this port does not
# implement yet (ROADMAP.md Queue 1, item 9): building one raises instead of
# silently dropping it.
_BACKBONES_NOT_PORTED = ("enet", "deeplabv3", "resnet")
_UNPORTED_FLAGS = ("attention", "residual")
_UNET_KWARGS = {"kernels", "strides", "drop_block", "bottleneck_out", "deep_supervision",
                "out_seg_bias", "ssn_rank", "dtype", "head_dtype"}


def as_dtype(dtype) -> torch.dtype:
    """torch dtype from a torch dtype or its name ("bfloat16", "float32")."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))


def check_backbone(name: str, kwargs) -> None:
    """Raise on a backbone or UNet flag that is not ported, naming its
    ROADMAP.md item."""
    if name in _BACKBONES_NOT_PORTED:
        raise NotImplementedError(f"model '{name}' is not ported yet "
                                  "(ROADMAP.md Queue 1, item 9)")
    if name not in ("unet2", "unet"):
        raise ValueError(f"Unknown model '{name}'")
    unported = [k for k in _UNPORTED_FLAGS if kwargs.get(k)]
    if unported:
        raise NotImplementedError(f"UNet flags {unported} are not ported yet "
                                  "(ROADMAP.md Queue 1, item 9)")


def build_backbone(name: str, input_shape, output_shape, **kwargs):
    """Model-zoo dispatch (counterpart of the JAX `models.build_backbone`)."""
    check_backbone(name, kwargs)
    kwargs = {k: v for k, v in kwargs.items() if k in _UNET_KWARGS}
    for key in ("dtype", "head_dtype"):
        if key in kwargs:
            kwargs[key] = as_dtype(kwargs[key])
    return UNet(input_shape=input_shape, output_shape=output_shape, **kwargs)
