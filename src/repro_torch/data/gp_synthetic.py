"""Synthetic GP regression data, paper Section 3, Eq. 21:

    y = sum_{i=1..p} cos(x_i) + nu,   nu ~ N(0, sigma_n^2)

Counterpart of ``repro/data/gp_synthetic.py``: ``make_gp_dataset`` and
the clustered 2-D spatial data of the Vecchia family
(``make_clustered_dataset``), the same numpy generators, so a seed gives
the same data in both packages; the arrays are returned as float32
tensors on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["make_clustered_dataset", "make_gp_dataset"]


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
    return _split(X_all, y_all, N, dev)


def _split(X_all, y_all, N: int, dev):
    out = (X_all[:N], y_all[:N], X_all[N:], y_all[N:])
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in out)


def make_clustered_dataset(
    N: int,
    *,
    n_clusters: int = 12,
    spread: float = 0.35,
    extent: float = 4.0,
    length_scale: float = 0.3,
    n_bumps: int = 60,
    noise: float = 0.05,
    seed: int = 0,
    test_frac: float = 0.1,
    device=None,
):
    """Clustered 2-D spatial regression, the regime the Vecchia family is
    built for: inputs around ``n_clusters`` random centres on
    [-extent, extent]^2 (Gaussian spread per cluster), targets a fixed sum
    of ``n_bumps`` random short-length-scale SE bumps plus noise; test
    points around the same centres.  Returns (X, y, Xs, ys) like
    :func:`make_gp_dataset`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_test = max(1, int(N * test_frac))
    n_all = N + n_test
    centers = rng.uniform(-extent, extent, size=(n_clusters, 2))
    which = rng.integers(0, n_clusters, size=n_all)
    X_all = (centers[which] + spread * rng.standard_normal((n_all, 2))).astype(np.float32)
    # f(x) = sum_j a_j exp(-|x - c_j|^2 / (2 l^2)), in the reference's order
    bump_c = rng.uniform(-extent - 1.0, extent + 1.0, size=(n_bumps, 2))
    bump_a = rng.standard_normal(n_bumps)
    d2 = np.sum((X_all[:, None, :] - bump_c[None, :, :]) ** 2, axis=-1)
    f = (np.exp(-d2 / (2.0 * length_scale**2)) @ bump_a).astype(np.float32)
    y_all = (f + noise * rng.standard_normal(n_all)).astype(np.float32)
    return _split(X_all, y_all, N, dev)
