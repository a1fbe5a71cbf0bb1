"""Synthetic GP regression data, paper Section 3, Eq. 21:

    y = sum_{i=1..p} cos(x_i) + nu,   nu ~ N(0, sigma_n^2)

Counterpart of ``repro/data/gp_synthetic.py::make_gp_dataset``: the same
numpy generator, so a seed gives the same data in both packages; the
arrays are returned as float32 tensors on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["make_gp_dataset"]


def make_gp_dataset(
    N: int,
    p: int,
    *,
    noise: float = 0.05,
    lo: float = -1.0,
    hi: float = 1.0,
    seed: int = 0,
    test_frac: float = 0.1,
    device=None,
):
    """Returns (X, y, Xs, ys): train/test splits of the Eq. 21 function."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_test = max(1, int(N * test_frac))
    X_all = rng.uniform(lo, hi, size=(N + n_test, p)).astype(np.float32)
    f = np.sum(np.cos(X_all), axis=1)
    y_all = (f + noise * rng.standard_normal(N + n_test)).astype(np.float32)
    out = (X_all[:N], y_all[:N], X_all[N:], y_all[N:])
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in out)
