"""Rank-K Cholesky update L <- chol(L L^T + W^T W) as K sequential rank-1
LINPACK sweeps, all in one launch, for one system (L (M, M), W (K, M)) or a
batch of G independent ones (L (G, M, M), W (G, K, M)).

This step is not a TPU kernel: the JAX package runs
``repro/core/fagp.py::_chol_rank1_update`` as one compiled ``lax.scan``
inside ``_update_arrays`` (whenever K * 8 <= M), vmapped over the update
groups by ``repro/bank/bank.py::_bank_update_scatter_impl``.  Eagerly in
PyTorch that sweep is K * M dependent steps, several launches each, so on
the card it is a kernel of its own.

CUDA kernel: ``csrc/chol_update.cu``.  Bound on the H100: ideally one pass
over the M x M triangle; in practice the latency of the column chain.  One
block walks the columns in panels of 8: warp 0 computes the panel's
rotation parameters from the panel rows held in registers, then all 1024
threads apply them to the rows below; a batch launches one such block per
system.  Its plain version, :func:`chol_update_plain`, is the faithful
column loop, vectorised over the batch (one launch per step covers every
system, not one per system).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["chol_rank1_update", "chol_update_plain", "chol_update_cuda",
           "COUNTER", "MAX_K"]

COUNTER = _build.LaunchCounter("chol_update")
MAX_K = 2048  # 3 * K * 8 floats of shared memory must fit in 227 KB


def chol_rank1_update(L: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Cholesky of L L^T + w w^T, in place on L (..., M, M) and w (..., M),
    O(M^2) per system: the column-sequential positive update sweep of
    ``repro/core/fagp.py::_chol_rank1_update``, written with in-place fused
    ops over any leading batch axes so that each column costs a dozen small
    launches on a card, however many systems there are."""
    M = L.shape[-1]
    for k in range(M):
        Lkk = L[..., k, k]
        wk = w[..., k]
        r = torch.sqrt(torch.addcmul(Lkk * Lkk, wk, wk))
        c = (r / Lkk)[..., None]
        s = (wk / Lkk)[..., None]
        col = L[..., k + 1:, k]              # views: updated in place
        wt = w[..., k + 1:]
        col.addcmul_(s, wt).div_(c)          # (col + s w) / c
        wt.mul_(c).addcmul_(s.neg(), col)    # c w - s col
        L[..., k, k] = r
    return L


def chol_update_plain(L: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Plain version: the K rank-1 sweeps, one after the other, on copies;
    L (M, M) and W (K, M), or a batch L (G, M, M) and W (G, K, M)."""
    L = L.clone()
    W = W.clone()
    for k in range(W.shape[-2]):
        chol_rank1_update(L, W[..., k, :])
    return L


def chol_update_cuda(L: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/chol_update.cu`` on L's stream, one block per system;
    L and W are copied first (the kernel works in place), so the caller's
    tensors are never written.  Counted as variant "batched" for a batch
    L (G, M, M), "" for one system."""
    batched = L.ndim == 3
    G = L.shape[0] if batched else 1
    M = L.shape[-1]
    K = W.shape[-2]
    out = L.clone()
    if G == 0 or M == 0 or K == 0:
        return out
    if K > MAX_K:
        raise ValueError(f"chol_update takes at most {MAX_K} rows at once, got {K}")
    work = W.clone()
    lib = _build.library("chol_update")
    fn = lib.repro_chol_update
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(L.device).cuda_stream
    rc = fn(_build.ptr(out), _build.ptr(work), G, M, K, ctypes.c_void_p(stream))
    _build.check_launch(rc, "chol_update")
    COUNTER.add("batched" if batched else "")
    return out
