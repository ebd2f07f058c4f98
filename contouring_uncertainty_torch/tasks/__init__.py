"""Tasks: the method layer (DSNT-AL, DSNT-skew and epistemic contour tasks;
the segmentation baselines): serving and training."""

from contouring_uncertainty_torch.tasks.dsnt_al import DSNTAleatoric
from contouring_uncertainty_torch.tasks.dsnt_skew import DSNTSkew, SkewUNet
from contouring_uncertainty_torch.tasks.epistemic import EpistemicUncertainty
from contouring_uncertainty_torch.tasks.segmentation import (
    AleatoricUncertainty,
    McDropoutUncertainty,
    SegmentationUncertaintyTask,
    StochasticSegmentationNetwork,
    TTAUncertainty,
)
