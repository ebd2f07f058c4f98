"""nnU-Net-style dynamic U-Net in PyTorch (NCHW), flagship flags.

Counterpart of contouring_uncertainty_tpu/models/unet.py with the flags of
the serving configuration: 8 stages of filters min(2^(5+i), 480), double
conv blocks of conv -> [channel dropout] -> instance norm -> LeakyReLU(0.01),
`drop_block` MC-dropout in the two deepest encoder stages and the
bottleneck, transposed-conv upsampling with the skip concatenated after the
upsampled tensor, a 1x1 head, `dtype`/`head_dtype` compute types, the
`encode_prefix`/`decode_from_prefix` modes of the MC-dropout predict path,
`bottleneck_out` with the `ConfidenceNet` skew head that reads it, and the
heads of the segmentation baselines: `ssn_rank` (the SSN heads `ssn_sigma`
and, above rank 1, `ssn_factor`), `deep_supervision` (lower-resolution
heads, in training only) and `out_seg_bias`; `residual` (ResidBlock
stages) and `attention` (an AttentionGate on each skip).

Submodules carry the flax auto-names (ConvBlock_i or ResidBlock_i,
UpsampleBlock_j, AttentionGate_0, OutputBlock_0, ConvLayer_0, Conv_0,
InstanceNorm_0, ConvTranspose_0), so convert.py maps a JAX parameter tree
onto `state_dict` keys one to one.
The layers, their dtypes and dropout draws are models/layers.py's; a
ConvLayer's chain is its `conv_norm`, on the kernels where `chain_route`
sends it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from contouring_uncertainty_torch.models.layers import (NEG_SLOPE, Conv, ConvTranspose, Dense,
                                                        InstanceNorm, channel_dropout,
                                                        conv_norm, reset_layers, torch_padding)


class ConvLayer(nn.Module):
    """conv -> [channel dropout] -> instance norm -> leaky relu, by
    models/layers.py `conv_norm` (the kernels or the op-by-op chain, as
    `chain_route` decides)."""

    def __init__(self, c_in, features, kernel_size=(3, 3), strides=(1, 1),
                 drop_block=False, drop_rate=0.5, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(c_in, features, kernel_size, strides,
                           torch_padding(kernel_size), dtype=dtype)
        self.InstanceNorm_0 = InstanceNorm(features, dtype=dtype)
        self.drop_block = drop_block
        self.drop_rate = drop_rate
        # The LeakyReLU's sides while `leaky_relu_sides` pins them, else None.
        self.pinned_sides: Optional[torch.Tensor] = None

    def forward(self, x, deterministic=True, generator=None):
        return conv_norm(self.Conv_0, self.InstanceNorm_0, x, "leaky_relu",
                         self.drop_block and not deterministic, self.drop_rate, generator,
                         self.pinned_sides)


class ConvBlock(nn.Module):
    """Double ConvLayer; the first carries the stage stride."""

    def __init__(self, c_in, features, kernel_size=(3, 3), strides=(1, 1),
                 drop_block=False, dtype=torch.float32):
        super().__init__()
        self.ConvLayer_0 = ConvLayer(c_in, features, kernel_size, strides,
                                     drop_block, dtype=dtype)
        self.ConvLayer_1 = ConvLayer(features, features, kernel_size, (1, 1),
                                     drop_block, dtype=dtype)

    def forward(self, x, deterministic=True, generator=None):
        x = self.ConvLayer_0(x, deterministic, generator)
        return self.ConvLayer_1(x, deterministic, generator)


class ResidBlock(nn.Module):
    """Residual double conv: ConvLayer (carrying the stride), conv ->
    [channel dropout 0.5] -> instance norm, plus the input, projected by a
    strided conv -> [dropout] -> norm where the stride or the width
    changes; LeakyReLU of the sum. Dropout draws in that order."""

    def __init__(self, c_in, features, kernel_size=(3, 3), strides=(1, 1),
                 drop_block=False, dtype=torch.float32):
        super().__init__()
        self.ConvLayer_0 = ConvLayer(c_in, features, kernel_size, strides, drop_block,
                                     dtype=dtype)
        self.Conv_0 = Conv(features, features, kernel_size, padding=torch_padding(kernel_size),
                           dtype=dtype)
        self.InstanceNorm_0 = InstanceNorm(features, dtype=dtype)
        self.project = max(strides) > 1 or c_in != features
        if self.project:
            self.Conv_1 = Conv(c_in, features, kernel_size, strides,
                               torch_padding(kernel_size), dtype=dtype)
            self.InstanceNorm_1 = InstanceNorm(features, dtype=dtype)
        self.drop_block = drop_block

    def forward(self, x, deterministic=True, generator=None):
        drop = self.drop_block and not deterministic
        out = self.Conv_0(self.ConvLayer_0(x, deterministic, generator))
        if drop:
            out = channel_dropout(out, 0.5, generator)
        out = self.InstanceNorm_0(out)
        residual = x
        if self.project:
            residual = self.Conv_1(x)
            if drop:
                residual = channel_dropout(residual, 0.5, generator)
            residual = self.InstanceNorm_1(residual)
        return F.leaky_relu(out + residual, NEG_SLOPE)


class AttentionGate(nn.Module):
    """Additive attention on a skip connection: skip * sigmoid(psi), psi a
    conv -> instance norm of relu(g + s), g and s the same of the gate and
    the skip at half the gate's width."""

    def __init__(self, c_gate, c_skip, features, dtype=torch.float32):
        super().__init__()
        half = features // 2
        for i, (c_in, c_out) in enumerate(((c_gate, half), (c_skip, half), (half, 1))):
            self.add_module(f"Conv_{i}", Conv(c_in, c_out, (3, 3), padding=torch_padding((3, 3)),
                                              dtype=dtype))
            self.add_module(f"InstanceNorm_{i}", InstanceNorm(c_out, dtype=dtype))

    def forward(self, gate, skip):
        layer = lambda i, h: getattr(self, f"InstanceNorm_{i}")(getattr(self, f"Conv_{i}")(h))
        psi = layer(2, F.relu(layer(0, gate) + layer(1, skip)))
        return skip * torch.sigmoid(psi)


class UpsampleBlock(nn.Module):
    """Transposed-conv upsample, concat [upsampled, (gated) skip], double
    conv."""

    def __init__(self, c_in, c_skip, features, kernel_size=(3, 3), strides=(2, 2),
                 attention: bool = False, dtype=torch.float32):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(c_in, features, strides, dtype=dtype)
        if attention:
            self.AttentionGate_0 = AttentionGate(features, c_skip, features, dtype=dtype)
        self.attention = attention
        self.ConvBlock_0 = ConvBlock(features + c_skip, features, kernel_size,
                                     (1, 1), False, dtype=dtype)

    def forward(self, x, skip, deterministic=True, generator=None):
        x = self.ConvTranspose_0(x)
        skip = skip.to(x.dtype)
        if self.attention:
            skip = self.AttentionGate_0(x, skip)
        x = torch.cat([x, skip], dim=1)
        return self.ConvBlock_0(x, deterministic, generator)


class OutputBlock(nn.Module):
    """1x1 conv head (bias off unless `bias`), computed in `dtype`,
    emitted in `out_dtype`."""

    def __init__(self, c_in, features, bias: bool = False, dtype=torch.float32,
                 out_dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(c_in, features, (1, 1), bias=bias, dtype=dtype)
        self.out_dtype = out_dtype

    def forward(self, x):
        return self.Conv_0(x).to(self.out_dtype)


class ConfidenceNet(nn.Module):
    """Bottleneck (N, C, Hb, Wb) -> (N, output_size) skew head: three 3x3
    convolutions of 128 channels with ReLU, a flatten in flax's NHWC order
    (so a converted Dense kernel means the same in both packages), and a
    Dense layer; all in `dtype` (f32), whatever the backbone's dtype."""

    def __init__(self, bottleneck_shape: Sequence[int], output_size: int):
        super().__init__()
        self.dtype = torch.float32
        c_in, hb, wb = bottleneck_shape
        for i in range(3):
            self.add_module(f"Conv_{i}", Conv(c_in if i == 0 else 128, 128, (3, 3),
                                              padding=torch_padding((3, 3))))
        self.Dense_0 = Dense(128 * hb * wb, output_size)

    def reset_parameters(self, generator=None):
        reset_layers(self, generator)

    def forward(self, x):
        x = x.to(self.dtype)
        for i in range(3):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        return self.Dense_0(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


class UNet(nn.Module):
    """Dynamic 2D U-Net: NCHW in, {"out": (N, C_out, H, W)} out; with
    `bottleneck_out` also {"bottleneck": (N, C_b, Hb, Wb)} in f32 (f64 in
    an f64 model), the last encoder stage's output after its dropout; with
    `ssn_rank` also {"ssn": [sigma (N, C_out, H, W), and above rank 1
    factor (N, C_out * rank, H, W), rank-major]} in f32, both read from the
    last decoder output and computed in `dtype`; with `deep_supervision`,
    in training, {"deep_supervision": [...]}, one head on each decoder
    output but the two coarsest and the last, finest first (flax's
    `decoder_outputs[2:-1][::-1]`). `out_seg_bias` gives the main and the
    deep-supervision heads a bias, not the SSN heads."""

    def __init__(self, input_shape: Sequence[int], output_shape: Sequence[int],
                 kernels=((3, 3),) * 8, strides=((1, 1),) + ((2, 2),) * 7,
                 drop_block: bool = False, bottleneck_out: bool = False,
                 deep_supervision: bool = False, out_seg_bias: bool = False,
                 ssn_rank: int = 0, residual: bool = False, attention: bool = False,
                 dtype=torch.float32, head_dtype=torch.float32):
        super().__init__()
        self.input_shape = tuple(input_shape)
        self.output_shape = tuple(output_shape)
        self.kernels = tuple(tuple(k) for k in kernels)
        self.strides = tuple(tuple(s) for s in strides)
        self.drop_block = drop_block
        self.bottleneck_out = bottleneck_out
        self.deep_supervision = deep_supervision
        self.ssn_rank = int(ssn_rank)
        self.dtype = dtype
        self.head_dtype = head_dtype
        filters = self.filters
        n_down = len(filters) - 2
        self.n_down = n_down
        self.drop_flags = [drop_block and (n_down - i) <= 2 for i in range(n_down)]
        # First stochastic encoder stage; the prefix is everything before it.
        self.first_drop = next((i for i, f in enumerate(self.drop_flags) if f), n_down)

        block = ResidBlock if residual else ConvBlock
        self.block_name = block.__name__
        c_in = input_shape[0]
        enc_ch = []
        for idx in range(n_down + 2):
            f = filters[idx] if idx <= n_down else filters[-1]
            use_drop = (self.drop_flags[idx - 1] if 1 <= idx <= n_down
                        else drop_block if idx == n_down + 1 else False)
            self.add_module(f"{self.block_name}_{idx}", block(
                c_in, f, self.kernels[idx], self.strides[idx], use_drop, dtype=dtype))
            c_in = f
            enc_ch.append(f)
        skips_ch = enc_ch[:-1]
        up_filters = filters[:-1][::-1]
        up_kernels = list(self.kernels[1:])[::-1]
        up_strides = list(self.strides[1:])[::-1]
        for j, c_skip in enumerate(reversed(skips_ch)):
            self.add_module(f"UpsampleBlock_{j}", UpsampleBlock(
                c_in, c_skip, up_filters[j], up_kernels[j], up_strides[j], attention,
                dtype=dtype))
            c_in = up_filters[j]
        n_classes = output_shape[0]
        head_compute = torch.promote_types(dtype, head_dtype)
        self.OutputBlock_0 = OutputBlock(c_in, n_classes, out_seg_bias, dtype=head_compute,
                                         out_dtype=head_dtype)
        n_up = len(skips_ch)
        # Decoder outputs read by the deep-supervision heads, finest first.
        self.ds_levels = list(range(n_up - 2, 1, -1)) if deep_supervision else []
        for j, level in enumerate(self.ds_levels):
            self.add_module(f"deep_supervision_{j}", OutputBlock(
                up_filters[level], n_classes, out_seg_bias, dtype=dtype))
        if self.ssn_rank:
            self.ssn_sigma = OutputBlock(c_in, n_classes, dtype=dtype)
            if self.ssn_rank > 1:
                self.ssn_factor = OutputBlock(c_in, n_classes * self.ssn_rank, dtype=dtype)

    @property
    def filters(self):
        return [min(2 ** (5 + i), 480) for i in range(len(self.strides))]

    def stage(self, idx: int) -> nn.Module:
        """The encoder block of stage `idx` (ConvBlock_idx or ResidBlock_idx)."""
        return getattr(self, f"{self.block_name}_{idx}")

    @property
    def bottleneck_shape(self):
        """(C_b, Hb, Wb) of the bottleneck features for this input shape."""
        h, w = self.input_shape[1:]
        for (kh, kw), (sh, sw) in zip(self.kernels, self.strides):
            h = (h + 2 * (kh // 2) - kh) // sh + 1
            w = (w + 2 * (kw // 2) - kw) // sw + 1
        return self.filters[-1], h, w

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Kaiming truncated-normal init for LeakyReLU(0.01), by `reset_layers`."""
        reset_layers(self, generator)

    def forward(self, x: Optional[torch.Tensor], deterministic: bool = True,
                generator: Optional[torch.Generator] = None, mode: str = "full",
                prefix: Optional[dict] = None, train: bool = False):
        """mode "full" runs the network; "encode_prefix" only the
        deterministic prefix (stem + encoder stages before the first dropout
        stage), returning {"skips": [...]}; "decode_from_prefix" the
        stochastic tail from `prefix` (possibly tiled along batch; `x` is
        ignored). `train` adds the deep-supervision heads."""
        if mode == "decode_from_prefix":
            if prefix is None:
                raise ValueError("mode='decode_from_prefix' requires prefix=")
            skips = [s.to(self.dtype) for s in prefix["skips"]]
            out = skips[-1]
            for i in range(self.first_drop, self.n_down):
                out = self.stage(i + 1)(out, deterministic, generator)
                skips.append(out)
        else:
            out = self.stage(0)(x.to(self.dtype), deterministic, generator)
            skips = [out]
            stop = self.first_drop if mode == "encode_prefix" else self.n_down
            for i in range(stop):
                out = self.stage(i + 1)(out, deterministic, generator)
                skips.append(out)
            if mode == "encode_prefix":
                return {"skips": skips}
        out = self.stage(self.n_down + 1)(out, deterministic, generator)
        bottleneck = out
        decoder_outputs = []
        for j, skip in enumerate(reversed(skips)):
            out = getattr(self, f"UpsampleBlock_{j}")(out, skip, deterministic, generator)
            decoder_outputs.append(out)
        result = {"out": self.OutputBlock_0(out)}
        if train and self.ds_levels:
            result["deep_supervision"] = [
                getattr(self, f"deep_supervision_{j}")(decoder_outputs[level])
                for j, level in enumerate(self.ds_levels)]
        if self.ssn_rank:
            heads = [self.ssn_sigma(out)]
            if self.ssn_rank > 1:
                heads.append(self.ssn_factor(out))
            result["ssn"] = heads
        if self.bottleneck_out:
            result["bottleneck"] = bottleneck.to(torch.promote_types(torch.float32, self.dtype))
        return result


@contextlib.contextmanager
def leaky_relu_sides(model: nn.Module, pin: Optional[Dict[str, torch.Tensor]] = None):
    """Within the block, record on which side of its LeakyReLU kink each
    activation of every ConvLayer of `model` falls in the last forward
    (layer name -> bool tensor, pre-activation > 0, read as the ConvLayer's
    output > 0: a slope of 0.01 > 0 keeps the sign, on either route), or,
    given `pin` (such a record), apply each ConvLayer's LeakyReLU with the
    slopes of the pinned sides (the layers then take the op-by-op chain).
    An f32 forward puts an activation within rounding of zero on either
    side, and a gradient through it moves by the slopes' difference:
    pinning an f64 model to an f32 forward's sides gives the f64 gradient
    on the linear piece that forward chose. Yields the record."""
    sides = {} if pin is None else pin
    layers = [(name, mod) for name, mod in model.named_modules() if isinstance(mod, ConvLayer)]
    handles = []
    for name, mod in layers:
        if pin is None:
            handles.append(mod.register_forward_hook(
                lambda m, inputs, out, name=name: sides.__setitem__(name, out.detach() > 0)))
        else:
            mod.pinned_sides = pin[name]
    try:
        yield sides
    finally:
        for h in handles:
            h.remove()
        for _, mod in layers:
            mod.pinned_sides = None
