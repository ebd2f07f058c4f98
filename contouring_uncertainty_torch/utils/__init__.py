"""Uncertainty projection and uncertainty-map utilities."""
