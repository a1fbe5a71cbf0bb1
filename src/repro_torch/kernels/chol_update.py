"""Rank-K Cholesky update L <- chol(L L^T + W^T W) as K sequential rank-1
LINPACK sweeps, all in one launch.

This step is not a TPU kernel: the JAX package runs
``repro/core/fagp.py::_chol_rank1_update`` as one compiled ``lax.scan``
inside ``_update_arrays`` (whenever K * 8 <= M).  Eagerly in PyTorch that
sweep is K * M dependent steps, several launches each, so on the card it
is a kernel of its own.

CUDA kernel: ``csrc/chol_update.cu``.  Bound on the H100: ideally one pass
over the M x M triangle; in practice the latency of the column chain.  One
block walks the columns in panels of 8: warp 0 computes the panel's
rotation parameters from the panel rows held in registers, then all 1024
threads apply them to the rows below.  Its plain version,
:func:`chol_update_plain`, is the faithful loop (used on the CPU at small M).
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
    """Cholesky of L L^T + w w^T, in place on L (and w), O(M^2): the
    column-sequential positive update sweep of
    ``repro/core/fagp.py::_chol_rank1_update``, written with in-place
    fused ops so that each column costs a dozen small launches on a card."""
    M = L.shape[0]
    for k in range(M):
        Lkk = L[k, k]
        wk = w[k]
        r = torch.sqrt(torch.addcmul(Lkk * Lkk, wk, wk))
        c = r / Lkk
        s = wk / Lkk
        col = L[k + 1:, k]                   # views: updated in place
        wt = w[k + 1:]
        col.addcmul_(s, wt).div_(c)          # (col + s w) / c
        wt.mul_(c).addcmul_(s.neg(), col)    # c w - s col
        L[k, k] = r
    return L


def chol_update_plain(L: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Plain version: the K rank-1 sweeps, one after the other, on copies."""
    L = L.clone()
    for w in W.clone():
        chol_rank1_update(L, w)
    return L


def chol_update_cuda(L: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/chol_update.cu`` on L's stream; L and W are copied
    first (the kernel works in place)."""
    M = L.shape[0]
    K = W.shape[0]
    out = L.clone()
    if M == 0 or K == 0:
        return out
    if K > MAX_K:
        raise ValueError(f"chol_update takes at most {MAX_K} rows at once, got {K}")
    work = W.clone()
    lib = _build.library("chol_update")
    fn = lib.repro_chol_update
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(L.device).cuda_stream
    rc = fn(_build.ptr(out), _build.ptr(work), M, K, ctypes.c_void_p(stream))
    _build.check_launch(rc, "chol_update")
    COUNTER.add()
    return out
