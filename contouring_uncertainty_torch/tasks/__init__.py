"""Tasks: the method layer (DSNT-AL serving so far)."""

from contouring_uncertainty_torch.tasks.dsnt_al import DSNTAleatoric
