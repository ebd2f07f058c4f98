"""Data layer: tags/contracts and the in-memory synthetic CAMUS-like source."""

from contouring_uncertainty_torch.data.config import (
    BatchResult,
    DataParams,
    Label,
    Tags,
)
