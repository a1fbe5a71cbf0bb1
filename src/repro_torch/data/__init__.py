"""Data pipelines: the paper's Eq. 21 GP datasets and the deterministic LM
token stream (numpy generators, tensors on the requested device)."""
from .gp_synthetic import make_clustered_dataset, make_gp_dataset
from .lm_synthetic import TokenStream

__all__ = ["make_clustered_dataset", "make_gp_dataset", "TokenStream"]
