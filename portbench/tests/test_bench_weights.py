"""The benchmark's weights (weights.py) by the UNet's initialisation rule
(reference/unet2.py `init`, found by the configuration's `model_name`):
bitwise the tensors that the rule's earlier form, written into weights.py
itself, drew at the same seed."""

import hashlib
from pathlib import Path

import torch

from portbench import harness, weights

REPO = Path(__file__).resolve().parents[2]


def test_unet_weights_are_bitwise_pinned():
    """The 4-stage UNet at 64x64, K = 21 (60 leaves, 1,928,256 values): the
    SHA-256 of every leaf's name, dtype and bytes in the state dict's order."""
    from contouring_uncertainty_torch.models.unet import UNet

    manifest = harness.Manifest(REPO / "BENCHMARK.json")
    unet = manifest.backbone(manifest.config("camus-dsnt-al")["model_name"])
    with torch.device("meta"):
        model = UNet((1, 64, 64), (21, 64, 64), kernels=((3, 3),) * 4,
                     strides=((1, 1),) + ((2, 2),) * 3, drop_block=True)
    shapes = {n: v.shape for n, v in model.state_dict().items()}
    made = weights.make(shapes, 2 ** 32 + 17, "cpu", unet.init)
    assert list(made) == list(shapes) and sum(v.numel() for v in made.values()) == 1928256
    digest = hashlib.sha256()
    for name, value in made.items():
        digest.update(name.encode())
        digest.update(str(value.dtype).encode())
        digest.update(value.contiguous().numpy().tobytes())
    assert digest.hexdigest() == (
        "7f9f9f2c0950f331cebad40a4c7733f06fdd5906804b8f9335298c44bcca84d6")
