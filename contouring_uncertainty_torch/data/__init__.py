"""Data layer: tags/contracts, the in-memory synthetic CAMUS-like source, the
JSRT chest X-ray source and the training augmentation."""

from contouring_uncertainty_torch.data.config import (
    BatchResult,
    DataParams,
    Label,
    Tags,
)
