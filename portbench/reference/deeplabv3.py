"""The backbone `deeplabv3` (DeepLabV3 on a ResNet-50, `task/model/deeplabv3.json`:
base 64, layers [3, 4, 6, 3]) with one landmark head: its plain-PyTorch
forward over a state dict of the benchmark's weights, its initialisation
rule, and the FLOPs of one training image from its layer shapes. The three
functions are those reference/unet2.py documents.

The network (Chen et al., arXiv:1706.05587; ResNet-50 of He et al.,
arXiv:1512.03385), as the repository defines it. Every convolution is
without bias except the head's last, and pads symmetrically:

- stem: 7x7 convolution, stride 2, padding 3, to `base` channels -> norm
  -> ReLU -> 3x3 max pool, stride 2, padding 1;
- four stages of bottlenecks, `layers` of them each, of `base` x (1, 2, 4,
  8) features with strides (1, 2, 2, 1) and dilations (1, 1, 1, 2); a
  stage's first bottleneck carries its stride. A bottleneck: 1x1 -> norm
  -> ReLU -> 3x3 (the stride, dilation d, padding d) -> norm -> ReLU ->
  1x1 to 4 x features -> norm -> channel dropout; plus the input, or
  where the channels or the stride change a 1x1 projection (the stride,
  no padding) -> norm; then ReLU. Output stride 16;
- ASPP on the 2048-channel map: a 1x1 branch, three 3x3 branches at
  dilations 12, 24 and 36 (padding equal to the dilation), and an image
  pooling branch (the spatial mean -> 1x1 -> norm -> ReLU, broadcast back
  to the map), each of 256 channels and each but the pooling followed by
  norm -> ReLU; their concatenation (1x1, 3x3 rates in order, pooling)
  -> 1x1 to 256 -> norm -> ReLU;
- head: 3x3 (padding 1) 256 -> 256 -> norm -> ReLU -> 1x1 with bias to K
  heatmaps -> bilinear upsampling (half-pixel centres) to the input size.

Its departures from torchvision's `deeplabv3_resnet50`, which are the
repository's own:

- every norm is a GroupNorm with one channel a group (eps 1e-5, affine),
  not BatchNorm;
- output stride 16 with only the last stage dilated (torchvision's
  DeepLabV3 dilates the last two stages for output stride 8);
- ASPP at rates 12/24/36 with its pooling branch normed per channel, and
  no dropout after ASPP's projection;
- the head is one 3x3 convolution, norm, ReLU and a 1x1 convolution with
  bias (torchvision's DeepLabHead keeps the 3x3 without bias, then a 1x1);
- channel dropout after each bottleneck's last norm, the MC-dropout
  source: per bottleneck in execution order one uniform per (row,
  channel) from the caller's `drop`, the channel kept where it is below
  1 - p (p = `model["dropout"]`) and scaled by 1 / (1 - p).

The weights are read by the program's parameter names
(`ResNetBackbone_0.DropoutBottleneck_<i>.Conv_<j>.weight`, `ASPP_0.*`,
`head_conv_0`, `GroupNorm_0`, `head_out_0`). The forward runs in the
dtype of its input and weights (float32 in the benchmark) and sets no
TF32 flag.

The initialisation: flax's default, a truncated normal of variance
1 / fan_in (variance scale 1) on every convolution; GroupNorm scales one;
every bias zero.

The FLOPs count what `torch.utils.flop_counter` counts: two per
multiply-add of every convolution at its output size, padding taps
included (a forward; the backward's input and weight gradients, with no
input gradient for the stem). The norms, pooling, activations, the
upsampling and the DSNT head are not counted. A CPU test holds these
counts to `flop_counter` on the program's model.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.work import ConvShape, conv_flops

Weights = Dict[str, torch.Tensor]

STAGES = ((1, 1, 1), (2, 2, 1), (4, 2, 1), (8, 1, 2))  # (width x base, stride, dilation)
RATES = (12, 24, 36)
ASPP_FEATURES = 256
_NORM_WEIGHT = re.compile(r"(^|\.)GroupNorm_\d+\.weight$")


def _norm(w: Weights, name: str, x):
    return F.group_norm(x, x.shape[1], w[f"{name}.weight"], w[f"{name}.bias"], eps=1e-5)


def _conv_norm(w: Weights, conv: str, norm: str, x, stride=1, padding=0, dilation=1):
    return _norm(w, norm, F.conv2d(x, w[f"{conv}.weight"], None, stride, padding, dilation))


def _bottleneck(w: Weights, name: str, x, stride: int, dilation: int, p: float,
                drop: Optional[Callable]):
    out = F.relu(_conv_norm(w, f"{name}.Conv_0", f"{name}.GroupNorm_0", x))
    out = F.relu(_conv_norm(w, f"{name}.Conv_1", f"{name}.GroupNorm_1", out, stride, dilation,
                            dilation))
    out = _conv_norm(w, f"{name}.Conv_2", f"{name}.GroupNorm_2", out)
    if drop is not None and p > 0:
        keep = drop((out.shape[0], out.shape[1], 1, 1)).to(out.device) < 1.0 - p
        out = torch.where(keep, out / (1.0 - p), torch.zeros((), dtype=out.dtype,
                                                                device=out.device))
    if f"{name}.Conv_3.weight" in w:
        x = _conv_norm(w, f"{name}.Conv_3", f"{name}.GroupNorm_3", x, stride)
    return F.relu(out + x)


def backbone(w: Weights, x, model: Dict, drop: Optional[Callable] = None):
    """The ResNet-50 of stride 16: (B, C, H, W) -> (B, 32 x base, H/16, W/16)."""
    x = F.relu(_conv_norm(w, "ResNetBackbone_0.Conv_0", "ResNetBackbone_0.GroupNorm_0", x, 2, 3))
    x = F.max_pool2d(x, 3, 2, padding=1)
    i = 0
    for (_, stride, dilation), blocks in zip(STAGES, model["layers"]):
        for b in range(blocks):
            x = _bottleneck(w, f"ResNetBackbone_0.DropoutBottleneck_{i}", x,
                            stride if b == 0 else 1, dilation, model["dropout"], drop)
            i += 1
    return x


def aspp(w: Weights, x):
    """The five branches, concatenated and projected to 256 channels."""
    layer = lambda j, h, pad=0, dil=1: F.relu(
        _conv_norm(w, f"ASPP_0.Conv_{j}", f"ASPP_0.GroupNorm_{j}", h, 1, pad, dil))
    n = len(RATES) + 1
    branches = [layer(0, x)] + [layer(j, x, r, r) for j, r in enumerate(RATES, start=1)]
    pooled = layer(n, x.mean(dim=(2, 3), keepdim=True))
    branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
    return layer(n + 1, torch.cat(branches, dim=1))


def head(w: Weights, x, size: Tuple[int, int]):
    """3x3, norm, ReLU, 1x1 with bias, then bilinear upsampling to `size`."""
    x = F.relu(_conv_norm(w, "head_conv_0", "GroupNorm_0", x, 1, 1))
    x = F.conv2d(x, w["head_out_0.weight"], w["head_out_0.bias"])
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


def forward(w: Weights, x, model: Dict, drop: Optional[Callable] = None):
    """The whole network on x (B, C, H, W) -> logits (B, K, H, W).
    `drop(shape)` draws the uniforms of a dropout layer (None: dropout off)."""
    return head(w, aspp(w, backbone(w, x, model, drop)), tuple(x.shape[-2:]))


def init(name: str, shape: Sequence[int]) -> Tuple[str, float]:
    """Convolutions (out, in, kh, kw) draw at variance 1 / (in * kh * kw);
    GroupNorm scales are one, every other leaf zero."""
    if name.endswith(".weight") and len(shape) == 4:
        return "normal", 1.0 / (shape[1] * shape[2] * shape[3])
    return "constant", 1.0 if _NORM_WEIGHT.search(name) else 0.0


def convs(in_shape: Sequence[int], n_classes: int, model: Dict) -> List[ConvShape]:
    """Every convolution of the network, in execution order, at its output
    size."""
    c, h, w = in_shape
    base = model["base"]
    down = lambda n, s: (n - 1) // s + 1  # a strided layer padded to keep ceil(n / s)
    h, w = down(h, 2), down(w, 2)
    out = [ConvShape("stem", c, base, 7, 7, h, w)]
    h, w = down(h, 2), down(w, 2)  # max pool
    c = base
    for stage, ((width, stride, _), blocks) in enumerate(zip(STAGES, model["layers"])):
        f = width * base
        for b in range(blocks):
            s = stride if b == 0 else 1
            ho, wo = down(h, s), down(w, s)
            out += [ConvShape(f"stage{stage}", c, f, 1, 1, h, w),
                    ConvShape(f"stage{stage}", f, f, 3, 3, ho, wo),
                    ConvShape(f"stage{stage}", f, 4 * f, 1, 1, ho, wo)]
            if c != 4 * f or s != 1:
                out.append(ConvShape(f"stage{stage}", c, 4 * f, 1, 1, ho, wo))
            c, h, w = 4 * f, ho, wo
    a = ASPP_FEATURES
    out += [ConvShape("aspp", c, a, 1, 1, h, w)]
    out += [ConvShape("aspp", c, a, 3, 3, h, w) for _ in RATES]
    out += [ConvShape("aspp", c, a, 1, 1, 1, 1),
            ConvShape("aspp", a * (len(RATES) + 2), a, 1, 1, h, w),
            ConvShape("head", a, a, 3, 3, h, w),
            ConvShape("head", a, n_classes, 1, 1, h, w)]
    return out


def train_flops(in_shape: Sequence[int], n_classes: int, model: Dict) -> float:
    """Forward and backward of one image: the forward, each convolution's
    weight gradient, and each input gradient but the stem's."""
    layers = convs(in_shape, n_classes, model)
    return 3.0 * sum(conv_flops(c) for c in layers) - conv_flops(layers[0])
