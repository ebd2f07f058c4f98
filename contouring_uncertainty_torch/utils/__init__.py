"""Uncertainty projection and uncertainty maps, the Dice metric, the
clinical metrics, phase timing and the model summary."""
