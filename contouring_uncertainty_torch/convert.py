"""JAX (flax) model parameters -> the port's `state_dict`.

Takes the flax parameter tree as a nested dict of numpy arrays (a
`variables` dict with a top-level "params" key is accepted too) and returns
tensors keyed like the port's model, whose submodules keep the flax names:
the UNet's (ConvBlock_i or ResidBlock_i / UpsampleBlock_j / AttentionGate_0
/ OutputBlock_0 / ConvLayer_0 / Conv_0 / InstanceNorm_0 / ConvTranspose_0;
the segmentation heads ssn_sigma, ssn_factor and deep_supervision_j), a
SkewUNet's `unet` and `confidence_net` (Conv_0..2, Dense_0), DeepLabV3's
(ResNetBackbone_0 / DropoutBottleneck_i / ASPP_0 / head_conv_i /
head_out_i / GroupNorm_i), the Resnet regressor's (layer1..4,
sigma_layer3/4, RegressionBottleneck_i, fc, sigma_fc) and ENet's
(InitialBlock_0, Bottleneck_i, head_i, PReLU_j). The mapping dispatches on
the kernel's rank:

- conv kernels (kh, kw, ci, co) -> (co, ci, kh, kw);
- ConvTranspose kernels are flipped in both spatial dims (flax's transposed
  conv mirrors the kernel relative to torch's ConvTranspose2d), then
  permuted to (ci, co, kh, kw);
- Dense kernels (in, out) -> Linear weights (out, in) (the port's
  ConfidenceNet flattens in flax's NHWC order, so the inputs line up);
- InstanceNorm and GroupNorm scale/bias -> weight/bias; conv and Dense
  bias -> bias; PReLU alpha -> alpha.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch


def flax_to_torch_state(params: Mapping) -> Dict[str, torch.Tensor]:
    if "params" in params and len(params) == 1:
        params = params["params"]
    state: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, path: List[str]):
        for name, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + [name])
                continue
            t = torch.from_numpy(np.array(value, dtype=np.float32))
            prefix = ".".join(path)
            if name == "kernel" and t.dim() == 2:
                state[f"{prefix}.weight"] = t.t().contiguous()
            elif name == "kernel" and t.dim() == 4:
                if path[-1].startswith("ConvTranspose"):
                    t = t.flip(0).flip(1).permute(2, 3, 0, 1)
                else:
                    t = t.permute(3, 2, 0, 1)
                state[f"{prefix}.weight"] = t.contiguous()
            elif name == "scale":
                state[f"{prefix}.weight"] = t
            elif name in ("bias", "alpha"):
                state[f"{prefix}.{name}"] = t
            else:
                raise KeyError(f"unexpected flax parameter {prefix}.{name}")

    walk(params, [])
    return state

