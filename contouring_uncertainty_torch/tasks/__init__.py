"""Tasks: the method layer (DSNT-AL and DSNT-skew: serving and training)."""

from contouring_uncertainty_torch.tasks.dsnt_al import DSNTAleatoric
from contouring_uncertainty_torch.tasks.dsnt_skew import DSNTSkew, SkewUNet
