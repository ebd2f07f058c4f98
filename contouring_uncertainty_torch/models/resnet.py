"""Standalone ResNet-50 coordinate-regression model, in PyTorch (NCHW).

Counterpart of contouring_uncertainty_tpu/models/resnet.py: a ResNet-50
V1.5 (bottlenecks [3, 4, 6, 3], the stride on the 3x3 conv) whose blocks
drop channels after every conv and after the residual sum, a 7x7/2 stem on
the data's channels, global average pooling and a dense head reshaped to
`output_shape`: landmark coordinates (N, K, 2). With `sigma_out > 0` a
second branch of layers 3-4 (parameters of its own) runs from the layer-2
features and regresses (N, K, sigma_out) per-point uncertainty parameters.

Norms are per-channel group norms in f32 (layers.py `group_norm`);
convolutions run in `dtype`, the pooled features and the dense heads in
f32. Submodules carry the flax names (Conv_0, GroupNorm_0, layer1..4,
sigma_layer3/4, RegressionBottleneck_i, fc, sigma_fc).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from contouring_uncertainty_torch.models.layers import (Dense, conv, dropout, group_norm,
                                                        max_pool_3x3_s2, reset_layers)


class RegressionBottleneck(nn.Module):
    """ResNet V1.5 bottleneck with dropout after every conv and after the
    residual sum: relu(out + identity), then the third dropout."""

    def __init__(self, c_in, features, strides=1, dropout=0.0, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = conv(c_in, features, 1, dtype=dtype)
        self.GroupNorm_0 = group_norm(features)
        self.Conv_1 = conv(features, features, 3, strides, 1, dtype=dtype)
        self.GroupNorm_1 = group_norm(features)
        self.Conv_2 = conv(features, features * 4, 1, dtype=dtype)
        self.GroupNorm_2 = group_norm(features * 4)
        self.project = c_in != features * 4 or strides != 1
        if self.project:
            self.Conv_3 = conv(c_in, features * 4, 1, strides, dtype=dtype)
            self.GroupNorm_3 = group_norm(features * 4)
        self.dropout = dropout

    def forward(self, x, deterministic=True, generator=None):
        drop = lambda h: dropout(h, self.dropout, deterministic, generator)
        out = drop(F.relu(self.GroupNorm_0(self.Conv_0(x))))
        out = drop(F.relu(self.GroupNorm_1(self.Conv_1(out))))
        out = self.GroupNorm_2(self.Conv_2(out))
        residual = self.GroupNorm_3(self.Conv_3(x)) if self.project else x
        return drop(F.relu(out + residual))


class Stage(nn.Module):
    """One ResNet stage: `blocks` bottlenecks, the stride on the first."""

    def __init__(self, c_in, features, blocks, strides=1, dropout=0.0, dtype=torch.float32):
        super().__init__()
        for b in range(blocks):
            self.add_module(f"RegressionBottleneck_{b}", RegressionBottleneck(
                c_in if b == 0 else features * 4, features, strides if b == 0 else 1,
                dropout, dtype))
        self.blocks = blocks

    def forward(self, x, deterministic=True, generator=None):
        for b in range(self.blocks):
            x = getattr(self, f"RegressionBottleneck_{b}")(x, deterministic, generator)
        return x


class Resnet(nn.Module):
    """ResNet-50 landmark regressor: {"out": (N, *output_shape)} f32, and
    {"sigma": (N, K, sigma_out)} f32 when `sigma_out > 0`."""

    def __init__(self, input_shape: Sequence[int], output_shape: Sequence[int],
                 layers=(3, 4, 6, 3), dropout: float = 0.0, sigma_out: int = 0,
                 dtype=torch.float32):
        super().__init__()
        self.input_shape = tuple(input_shape)
        self.output_shape = tuple(int(d) for d in output_shape)
        self.sigma_out = int(sigma_out)
        self.dtype = dtype
        layers = tuple(layers)
        self.Conv_0 = conv(input_shape[0], 64, 7, 2, 3, dtype=dtype)
        self.GroupNorm_0 = group_norm(64)
        self.layer1 = Stage(64, 64, layers[0], 1, dropout, dtype)
        self.layer2 = Stage(256, 128, layers[1], 2, dropout, dtype)
        self.layer3 = Stage(512, 256, layers[2], 2, dropout, dtype)
        self.layer4 = Stage(1024, 512, layers[3], 2, dropout, dtype)
        self.fc = Dense(2048, math.prod(self.output_shape))
        if self.sigma_out > 0:
            self.sigma_layer3 = Stage(512, 256, layers[2], 2, dropout, dtype)
            self.sigma_layer4 = Stage(1024, 512, layers[3], 2, dropout, dtype)
            self.sigma_fc = Dense(2048, self.output_shape[0] * self.sigma_out)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's default init (lecun truncated normal), by `reset_layers`."""
        reset_layers(self, generator)

    def forward(self, x, deterministic: bool = True, generator=None, mode: str = "full",
                prefix=None, train: bool = False):
        if mode != "full":
            raise ValueError(f"Resnet has no mode {mode!r}")
        n = x.shape[0]
        pooled_dtype = torch.promote_types(torch.float32, self.dtype)
        out = max_pool_3x3_s2(F.relu(self.GroupNorm_0(self.Conv_0(x.to(self.dtype)))))
        out = self.layer1(out, deterministic, generator)
        out = self.layer2(out, deterministic, generator)
        sigma_split = out
        out = self.layer3(out, deterministic, generator)
        out = self.layer4(out, deterministic, generator)
        feats = out.mean(dim=(2, 3)).to(pooled_dtype)
        result = {"out": self.fc(feats).reshape((n,) + self.output_shape)}
        if self.sigma_out > 0:
            s = self.sigma_layer3(sigma_split, deterministic, generator)
            s = self.sigma_layer4(s, deterministic, generator)
            sigma = self.sigma_fc(s.mean(dim=(2, 3)).to(pooled_dtype))
            result["sigma"] = sigma.reshape(n, self.output_shape[0], self.sigma_out)
        return result
