"""Synthetic datasets (numpy generators, tensors on the requested device)."""
from .gp_synthetic import make_clustered_dataset, make_gp_dataset

__all__ = ["make_clustered_dataset", "make_gp_dataset"]
