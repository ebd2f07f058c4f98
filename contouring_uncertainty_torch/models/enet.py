"""ENet in PyTorch (NCHW): the lightweight segmentation backbone.

Counterpart of contouring_uncertainty_tpu/models/enet.py: an initial block
(3x3/2 conv beside a 2x2 max pool), an encoder of regular, dilated,
asymmetric and downsampling bottlenecks, a decoder of upsampling ones
(strided transposed convolutions; the main branch a nearest 2x repeat),
per-head decoders (`n_heads`, `ssn_rank`) and `bottleneck_out` features.
ReLU or a per-channel PReLU; group norms in f32 (layers.py `group_norm`);
convolutions in `dtype`.

The transposed convolutions are flax's `ConvTranspose(k=3, s=2, "SAME")`:
torch's unpadded transposed conv of the flipped kernel (convert.py), its
last row and column dropped (layers.py `ConvTranspose`), exactly; torch's
`padding=1, output_padding=1` would pad the other side. Submodules carry
the flax auto-names (InitialBlock_0, Bottleneck_i, head_i, Conv_j,
ConvTranspose_0, GroupNorm_j, PReLU_j).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from contouring_uncertainty_torch.models.layers import (ConvTranspose, conv, dropout, group_norm,
                                                        reset_layers)


class PReLU(nn.Module):
    """where(x >= 0, x, alpha * x) with a per-channel `alpha` (init 0.25)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha.to(x.dtype)[None, :, None, None] * x)


def add_activations(module: nn.Module, relu: bool, widths: Sequence[int]):
    """Give `module` its activations in call order: ReLU, or a fresh PReLU
    per use site (PReLU_0, PReLU_1, ...), as flax names them; `act(module,
    j, x)` applies the j-th."""
    module.relu = relu
    if not relu:
        for j, c in enumerate(widths):
            module.add_module(f"PReLU_{j}", PReLU(c))


def act(module: nn.Module, j: int, x):
    return F.relu(x) if module.relu else getattr(module, f"PReLU_{j}")(x)


def transpose_conv(c_in, c_out, dtype) -> ConvTranspose:
    """flax ConvTranspose(c_out, (3, 3), strides (2, 2), "SAME"), no bias."""
    return ConvTranspose(c_in, c_out, (2, 2), dtype=dtype, kernel_size=(3, 3),
                         padding="SAME", init_scale=1.0)


class InitialBlock(nn.Module):
    """3x3/2 conv (C - C_in maps) concatenated with the 2x2 max pool of the
    input, normed and activated."""

    def __init__(self, c_in, out_channels=16, relu=True, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = conv(c_in, out_channels - c_in, 3, 2, 1, dtype=dtype)
        self.GroupNorm_0 = group_norm(out_channels)
        add_activations(self, relu, [out_channels])

    def forward(self, x):
        out = torch.cat([self.Conv_0(x), F.max_pool2d(x, 2, 2).to(self.Conv_0.dtype)], dim=1)
        return act(self, 0, self.GroupNorm_0(out))


class Bottleneck(nn.Module):
    """Regular / dilated / asymmetric / downsampling / upsampling bottleneck."""

    def __init__(self, c_in, channels, internal_ratio=4, kernel_size=3, dilation=1,
                 asymmetric=False, downsample=False, upsample=False, dropout=0.1, relu=True,
                 dtype=torch.float32):
        super().__init__()
        internal = max(channels // internal_ratio, 1)
        self.channels = channels
        self.downsample, self.upsample, self.asymmetric = downsample, upsample, asymmetric
        self.dropout = dropout
        self.Conv_0 = (conv(c_in, internal, 2, 2, dtype=dtype) if downsample
                       else conv(c_in, internal, 1, dtype=dtype))
        self.GroupNorm_0 = group_norm(internal)
        j = 1
        if upsample:
            self.ConvTranspose_0 = transpose_conv(internal, internal, dtype)
        elif asymmetric:
            k = kernel_size
            self.Conv_1 = conv(internal, internal, (k, 1), dtype=dtype)
            self.Conv_2 = conv(internal, internal, (1, k), dtype=dtype)
            j = 3
        else:
            self.add_module("Conv_1", conv(internal, internal, kernel_size, dilation=dilation,
                                           dtype=dtype))
            j = 2
        self.GroupNorm_1 = group_norm(internal)
        self.expand = f"Conv_{j}"
        self.add_module(self.expand, conv(internal, channels, 1, dtype=dtype))
        self.GroupNorm_2 = group_norm(channels)
        self.main = None
        if upsample:
            self.main = f"Conv_{j + 1}"
            self.add_module(self.main, conv(c_in, channels, 1, dtype=dtype))
            self.GroupNorm_3 = group_norm(channels)
        elif not downsample and c_in != channels:
            self.main = f"Conv_{j + 1}"
            self.add_module(self.main, conv(c_in, channels, 1, dtype=dtype))
        add_activations(self, relu, [internal, internal, channels])

    def forward(self, x, deterministic=True, generator=None):
        ext = act(self, 0, self.GroupNorm_0(self.Conv_0(x)))
        if self.upsample:
            ext = self.ConvTranspose_0(ext)
        elif self.asymmetric:
            ext = self.Conv_2(self.Conv_1(ext))
        else:
            ext = self.Conv_1(ext)
        ext = act(self, 1, self.GroupNorm_1(ext))
        ext = self.GroupNorm_2(getattr(self, self.expand)(ext))
        ext = dropout(ext, self.dropout, deterministic, generator)

        main = x
        if self.downsample:
            main = F.max_pool2d(x, 2, 2)
            pad = self.channels - main.shape[1]
            if pad > 0:  # zero channels after the pooled ones
                main = F.pad(main, (0, 0, 0, 0, 0, pad))
        elif self.upsample:
            main = self.GroupNorm_3(getattr(self, self.main)(main))
            main = main.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        elif self.main is not None:
            main = getattr(self, self.main)(main)
        return act(self, 2, main + ext)


class DecoderHead(nn.Module):
    """Stage-5 decoder head: upsampling and regular bottlenecks, then the
    final transposed conv, emitted in f32."""

    def __init__(self, c_in, init_channels, out_channels, dropout, relu, dtype=torch.float32):
        super().__init__()
        self.Bottleneck_0 = Bottleneck(c_in, init_channels, upsample=True, dropout=dropout,
                                       relu=relu, dtype=dtype)
        self.Bottleneck_1 = Bottleneck(init_channels, init_channels, dropout=dropout, relu=relu,
                                       dtype=dtype)
        self.ConvTranspose_0 = transpose_conv(init_channels, out_channels, dtype)

    def forward(self, x, deterministic=True, generator=None):
        x = self.Bottleneck_0(x, deterministic, generator)
        x = self.Bottleneck_1(x, deterministic, generator)
        return self.ConvTranspose_0(x)


class Enet(nn.Module):
    """ENet with the project's heads; NCHW in, the UNet's output dict out:
    {"out"}, {"heads": [...]} with `n_heads` > 1, {"ssn": [...]} with
    `ssn_rank` > 0, {"bottleneck"} (N, 4*init_channels, H/8, W/8) f32 with
    `bottleneck_out`; heads f32 (f64 in an f64 model)."""

    def __init__(self, input_shape: Sequence[int], output_shape: Sequence[int],
                 init_channels: int = 16, dropout: float = 0.1, encoder_relu: bool = True,
                 decoder_relu: bool = True, bottleneck_out: bool = False, n_heads: int = 1,
                 ssn_rank: int = 0, dtype=torch.float32):
        super().__init__()
        self.input_shape = tuple(input_shape)
        self.output_shape = tuple(output_shape)
        self.init_channels = c0 = init_channels
        self.bottleneck_out = bottleneck_out
        self.n_heads = int(n_heads)
        self.ssn_rank = int(ssn_rank)
        self.dtype = dtype
        drop, enc, dec = dropout, encoder_relu, decoder_relu
        self.InitialBlock_0 = InitialBlock(input_shape[0], c0, relu=enc, dtype=dtype)
        blocks = [dict(c_in=c0, channels=2 * c0, downsample=True, dropout=drop / 10, relu=enc)]
        blocks += [dict(channels=2 * c0, dropout=drop / 10, relu=enc)] * 4
        blocks += [dict(c_in=2 * c0, channels=4 * c0, downsample=True, dropout=drop, relu=enc)]
        stage2 = [dict(), dict(dilation=2), dict(kernel_size=5, asymmetric=True),
                  dict(dilation=4), dict(), dict(dilation=8),
                  dict(kernel_size=5, asymmetric=True), dict(dilation=16)]
        blocks += [dict(channels=4 * c0, dropout=drop, relu=enc, **b) for b in stage2] * 2
        self.n_encoder = len(blocks)
        blocks += [dict(c_in=4 * c0, channels=2 * c0, upsample=True, dropout=drop, relu=dec)]
        blocks += [dict(channels=2 * c0, dropout=drop, relu=dec)] * 2
        for i, b in enumerate(blocks):
            b = dict(b)
            c_in = b.pop("c_in", b["channels"])
            self.add_module(f"Bottleneck_{i}", Bottleneck(c_in, dtype=dtype, **b))
        self.n_blocks = len(blocks)
        n_classes = output_shape[0]
        self.head_sizes = [n_classes]
        if self.ssn_rank > 0:
            self.head_sizes = [n_classes, n_classes, n_classes * self.ssn_rank]
        elif self.n_heads > 1:
            self.head_sizes = [n_classes] * self.n_heads
        for i, size in enumerate(self.head_sizes):
            self.add_module(f"head_{i}", DecoderHead(2 * c0, c0, size, drop, dec, dtype))

    @property
    def bottleneck_shape(self):
        """(C_b, Hb, Wb) of the encoder's output for this input shape."""
        h, w = self.input_shape[1:]
        return 4 * self.init_channels, h // 8, w // 8

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's default init: lecun truncated normal, unit norm scales,
        zero norm biases, PReLU slopes 0.25."""
        reset_layers(self, generator)
        for mod in self.modules():
            if isinstance(mod, PReLU):
                nn.init.constant_(mod.alpha, 0.25)

    def forward(self, x, deterministic: bool = True, generator=None, mode: str = "full",
                prefix=None, train: bool = False):
        if mode != "full":
            raise ValueError(f"Enet has no mode {mode!r}")
        out_dtype = torch.promote_types(torch.float32, self.dtype)
        out = self.InitialBlock_0(x.to(self.dtype))
        bottleneck = None
        for i in range(self.n_blocks):
            out = getattr(self, f"Bottleneck_{i}")(out, deterministic, generator)
            if i == self.n_encoder - 1:
                bottleneck = out
        heads = [getattr(self, f"head_{i}")(out, deterministic, generator).to(out_dtype)
                 for i in range(len(self.head_sizes))]
        result = {"out": heads[0]}
        if self.ssn_rank > 0:
            result["ssn"] = heads[1:]
        elif self.n_heads > 1:
            result["heads"] = heads
        if self.bottleneck_out:
            result["bottleneck"] = bottleneck.to(out_dtype)
        return result
