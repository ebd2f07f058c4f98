"""Config composition: JSON config groups, `group=option` selections and
dotted overrides (counterpart of contouring_uncertainty_tpu/config)."""

from contouring_uncertainty_torch.config.compose import compose, deep_merge
