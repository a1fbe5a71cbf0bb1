"""Synthetic datasets (numpy generators, tensors on the requested device)."""
from .gp_synthetic import make_gp_dataset

__all__ = ["make_gp_dataset"]
