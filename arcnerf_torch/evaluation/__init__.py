"""Evaluation layer: the eval loop."""
