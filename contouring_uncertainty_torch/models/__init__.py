"""Model zoo: the nnU-Net-style UNet (`unet2`) and its ConfidenceNet skew head."""

from __future__ import annotations

import torch

from contouring_uncertainty_torch.models.unet import ConfidenceNet, UNet

# Flags of the JAX UNet that this port does not implement yet: building a
# backbone that sets one raises instead of silently dropping it.
_UNPORTED_FLAGS = ("deep_supervision", "attention", "residual", "out_seg_bias",
                   "ssn_rank")


def as_dtype(dtype) -> torch.dtype:
    """torch dtype from a torch dtype or its name ("bfloat16", "float32")."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))


def build_backbone(name: str, input_shape, output_shape, **kwargs):
    """Model-zoo dispatch (counterpart of the JAX `models.build_backbone`)."""
    if name not in ("unet2", "unet"):
        raise ValueError(f"Unknown or not yet ported model '{name}'")
    unported = [k for k in _UNPORTED_FLAGS if kwargs.get(k)]
    if unported:
        raise NotImplementedError(f"UNet flags not ported yet: {unported}")
    allowed = {"kernels", "strides", "drop_block", "bottleneck_out", "dtype", "head_dtype"}
    kwargs = {k: v for k, v in kwargs.items() if k in allowed}
    for key in ("dtype", "head_dtype"):
        if key in kwargs:
            kwargs[key] = as_dtype(kwargs[key])
    return UNet(input_shape=input_shape, output_shape=output_shape, **kwargs)
