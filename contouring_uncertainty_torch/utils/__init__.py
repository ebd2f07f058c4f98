"""Uncertainty projection and uncertainty maps, the Dice metric, phase timing
and the model summary."""
