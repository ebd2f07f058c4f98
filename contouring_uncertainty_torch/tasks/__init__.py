"""Tasks: the method layer (DSNT-AL: serving and training)."""

from contouring_uncertainty_torch.tasks.dsnt_al import DSNTAleatoric
