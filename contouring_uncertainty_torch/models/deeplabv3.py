"""DeepLabV3 with a dropout-capable ResNet backbone, in PyTorch (NCHW).

Counterpart of contouring_uncertainty_tpu/models/deeplabv3.py: a
ResNet-50-style backbone of bottleneck blocks with optional channel dropout
(the MC-dropout source), a dilated last stage for output stride 16, an ASPP
head, bilinear upsampling to the input size, multi-head (`n_heads`) and SSN
(`ssn_rank`) outputs, and `bottleneck_out` backbone features for the skew
ConfidenceNet; the same output dict as the UNet.

Norms are flax's `GroupNorm(group_size=1)` (models/layers.py
`group_norm`): per-channel statistics in f32, single pass, so activations
stay f32 between convolutions, which run in `dtype`. On ASPP's pooled 1x1
map the variance is exactly 0 and the norm gives its bias. Submodules carry
the flax auto-names (ResNetBackbone_0, DropoutBottleneck_i, ASPP_0, Conv_i,
GroupNorm_i, head_conv_i, head_out_i), so convert.py maps a JAX parameter
tree one to one. The forward opens the trace spans `cut.model.backbone`,
`cut.model.aspp` and `cut.model.head` (utils/profiling.py `span`). Each
norm chain is models/layers.py's `conv_norm` (conv -> norm -> ReLU, or no
activation in a projection) or `conv_norm_tail` (a bottleneck's last norm,
its dropout, the residual add and the ReLU), on the kernels where
`chain_route` sends it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from contouring_uncertainty_torch.models.layers import (conv, conv_norm, conv_norm_tail,
                                                        group_norm, max_pool_3x3_s2, reset_layers)
from contouring_uncertainty_torch.utils.profiling import span


class DropoutBottleneck(nn.Module):
    """ResNet bottleneck (1x1 -> 3x3 -> 1x1, x4 expansion) with channel
    dropout after the last norm."""

    def __init__(self, c_in, features, strides=1, dilation=1, dropout=0.0,
                 dtype=torch.float32):
        super().__init__()
        self.Conv_0 = conv(c_in, features, 1, dtype=dtype)
        self.GroupNorm_0 = group_norm(features)
        # torch-style symmetric padding: the dilated 3x3 pads by its dilation.
        self.Conv_1 = conv(features, features, 3, strides, dilation, dilation, dtype=dtype)
        self.GroupNorm_1 = group_norm(features)
        self.Conv_2 = conv(features, features * 4, 1, dtype=dtype)
        self.GroupNorm_2 = group_norm(features * 4)
        self.project = c_in != features * 4 or strides != 1
        if self.project:
            self.Conv_3 = conv(c_in, features * 4, 1, strides, dtype=dtype)
            self.GroupNorm_3 = group_norm(features * 4)
        self.dropout = dropout

    def forward(self, x, deterministic=True, generator=None):
        out = conv_norm(self.Conv_0, self.GroupNorm_0, x, "relu")
        out = conv_norm(self.Conv_1, self.GroupNorm_1, out, "relu")
        residual = lambda: conv_norm(self.Conv_3, self.GroupNorm_3, x, None) if self.project else x
        return conv_norm_tail(self.Conv_2, self.GroupNorm_2, out, residual,
                              not deterministic and self.dropout != 0.0, self.dropout, generator)


class ResNetBackbone(nn.Module):
    """ResNet-50-style backbone, output stride 16 (the last stage dilated)."""

    def __init__(self, c_in, layers=(3, 4, 6, 3), base=64, dropout=0.0, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = conv(c_in, base, 7, 2, 3, dtype=dtype)
        self.GroupNorm_0 = group_norm(base)
        stage_cfg = [(base, 1, 1), (base * 2, 2, 1), (base * 4, 2, 1), (base * 8, 1, 2)]
        c, i = base, 0
        for (features, stride, dilation), blocks in zip(stage_cfg, layers):
            for b in range(blocks):
                self.add_module(f"DropoutBottleneck_{i}", DropoutBottleneck(
                    c, features, stride if b == 0 else 1, dilation, dropout, dtype))
                c, i = features * 4, i + 1
        self.n_blocks = i
        self.out_channels = c

    def forward(self, x, deterministic=True, generator=None):
        out = max_pool_3x3_s2(conv_norm(self.Conv_0, self.GroupNorm_0, x, "relu"))
        for i in range(self.n_blocks):
            out = getattr(self, f"DropoutBottleneck_{i}")(out, deterministic, generator)
        return out  # (N, base*32, H/16, W/16)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (rates 12/24/36 + image pooling)."""

    def __init__(self, c_in, features=256, rates=(12, 24, 36), dtype=torch.float32):
        super().__init__()
        self.Conv_0 = conv(c_in, features, 1, dtype=dtype)
        self.GroupNorm_0 = group_norm(features)
        for j, rate in enumerate(rates, start=1):
            self.add_module(f"Conv_{j}", conv(c_in, features, 3, dilation=rate, dtype=dtype))
            self.add_module(f"GroupNorm_{j}", group_norm(features))
        n = len(rates) + 1
        self.add_module(f"Conv_{n}", conv(c_in, features, 1, dtype=dtype))
        self.add_module(f"GroupNorm_{n}", group_norm(features))
        self.add_module(f"Conv_{n + 1}", conv(features * (n + 1), features, 1, dtype=dtype))
        self.add_module(f"GroupNorm_{n + 1}", group_norm(features))
        self.n_branches = n

    def forward(self, x):
        layer = lambda j, h: conv_norm(getattr(self, f"Conv_{j}"),
                                       getattr(self, f"GroupNorm_{j}"), h, "relu")
        n = self.n_branches
        branches = [layer(j, x) for j in range(n)]
        pooled = layer(n, x.mean(dim=(2, 3), keepdim=True))
        branches.append(pooled.expand_as(branches[0]))
        return layer(n + 1, torch.cat(branches, dim=1))


class DeepLabV3(nn.Module):
    """DeepLabV3 with the project's heads; NCHW in, the UNet's output dict
    out: {"out"}, {"heads": [...]} with `n_heads` > 1, {"ssn": [sigma,
    factor]} with `ssn_rank` > 0, {"bottleneck"} (N, base*32, H/16, W/16)
    f32 with `bottleneck_out`; every head f32 (f64 in an f64 model) at the
    input size."""

    def __init__(self, input_shape: Sequence[int], output_shape: Sequence[int],
                 layers=(3, 4, 6, 3), base: int = 64, dropout: float = 0.0, n_heads: int = 1,
                 ssn_rank: int = 0, bottleneck_out: bool = False, dtype=torch.float32):
        super().__init__()
        self.input_shape = tuple(input_shape)
        self.output_shape = tuple(output_shape)
        self.ssn_rank = int(ssn_rank)
        self.n_heads = int(n_heads)
        self.bottleneck_out = bottleneck_out
        self.dtype = dtype
        self.ResNetBackbone_0 = ResNetBackbone(input_shape[0], tuple(layers), base, dropout, dtype)
        self.ASPP_0 = ASPP(self.ResNetBackbone_0.out_channels, dtype=dtype)
        n_classes = output_shape[0]
        self.head_sizes = [n_classes]
        if self.ssn_rank > 0:
            self.head_sizes = [n_classes, n_classes, n_classes * self.ssn_rank]
        elif self.n_heads > 1:
            self.head_sizes = [n_classes] * self.n_heads
        for i, size in enumerate(self.head_sizes):
            self.add_module(f"head_conv_{i}", conv(256, 256, 3, dtype=dtype))
            self.add_module(f"GroupNorm_{i}", group_norm(256))
            self.add_module(f"head_out_{i}", conv(256, size, 1, bias=True, dtype=dtype))

    @property
    def bottleneck_shape(self):
        """(C_b, Hb, Wb) of the backbone features for this input shape."""
        h, w = self.input_shape[1:]
        for _ in range(4):  # stem conv, max pool, stages 2 and 3: stride 2, pad 1
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        return self.ResNetBackbone_0.out_channels, h, w

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's default init (lecun truncated normal), by `reset_layers`."""
        reset_layers(self, generator)

    def forward(self, x, deterministic: bool = True, generator=None, mode: str = "full",
                prefix=None, train: bool = False):
        if mode != "full":
            raise ValueError(f"DeepLabV3 has no mode {mode!r}")
        h, w = x.shape[-2:]
        out_dtype = torch.promote_types(torch.float32, self.dtype)
        with span("cut.model.backbone"):
            feats = self.ResNetBackbone_0(x.to(self.dtype), deterministic, generator)
        with span("cut.model.aspp"):
            aspp = self.ASPP_0(feats)
        outs = []
        with span("cut.model.head"):
            for i in range(len(self.head_sizes)):
                head = conv_norm(getattr(self, f"head_conv_{i}"), getattr(self, f"GroupNorm_{i}"),
                                 aspp, "relu")
                head = getattr(self, f"head_out_{i}")(head).to(out_dtype)
                outs.append(F.interpolate(head, size=(h, w), mode="bilinear",
                                          align_corners=False))
        result = {"out": outs[0]}
        if self.ssn_rank > 0:
            result["ssn"] = outs[1:]
        elif self.n_heads > 1:
            result["heads"] = outs
        if self.bottleneck_out:
            result["bottleneck"] = feats.to(out_dtype)
        return result
