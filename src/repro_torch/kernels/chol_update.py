"""Rank-K Cholesky update L <- chol(L L^T + W^T W) as K sequential rank-1
LINPACK sweeps, all in one launch, for one system (L (M, M), W (K, M)) or a
batch of G independent ones (L (G, M, M), W (G, K, M)).

This step is not a TPU kernel: the JAX package runs
``repro/core/fagp.py::_chol_rank1_update`` as one compiled ``lax.scan``
inside ``_update_arrays`` (whenever K * 8 <= M), vmapped over the update
groups by ``repro/bank/bank.py::_bank_update_scatter_impl``.  Eagerly in
PyTorch that sweep is K * M dependent steps, several launches each, so on
the card it is a kernel of its own.

CUDA kernels: ``csrc/chol_update.cu``.  Bound on the H100: ideally one pass
over the M x M triangle; in practice the chain of dependent rotations and
one grid-wide step per column panel.  One system runs a persistent
cooperative kernel over every SM: rows in groups of 32 spread over the
blocks with their columns of W in shared memory; each 32-column panel is
factored in the block that owns its rows, by two warps walking the panel's
anti-diagonals while the rows' own warp still applies the previous panel
to them, and published to all blocks by one ``grid.sync()``.  A batch
runs one block per system (panels of 8).  Both round every rotation alike,
so the two give bitwise equal factors.  Its plain version,
:func:`chol_update_plain`, is the faithful column loop, vectorised over the
batch (one launch per step covers every system, not one per system).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["chol_rank1_update", "chol_update_plain", "chol_update_cuda",
           "chol_update_plan", "COUNTER", "MAX_K"]

COUNTER = _build.LaunchCounter("chol_update")
MAX_K = 2048  # 3 * K * 8 floats of shared memory must fit in 227 KB
_PLAN_KEYS = ("blocks", "threads", "w_chunk", "groups_per_block", "smem_bytes")


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


def _lib() -> ctypes.CDLL:
    lib = _build.library("chol_update")
    lib.repro_chol_update.restype = ctypes.c_int
    lib.repro_chol_update.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_void_p]
    lib.repro_chol_update_scratch.restype = ctypes.c_longlong
    lib.repro_chol_update_scratch.argtypes = [ctypes.c_int]
    lib.repro_chol_update_plan.restype = ctypes.c_int
    lib.repro_chol_update_plan.argtypes = [ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_longlong)]
    return lib


def chol_update_plan(M: int, K: int) -> dict:
    """The single-system sweep's launch on the current card: its grid
    (occupancy x SMs, capped by the 32-row groups), threads per block, the
    chunk of W kept in shared memory, row groups per block and shared
    bytes per block."""
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    _build.check_launch(_lib().repro_chol_update_plan(M, K, out), "chol_update (plan)")
    return dict(zip(_PLAN_KEYS, out))


def chol_update_cuda(L: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/chol_update.cu`` on L's stream: the cooperative sweep
    for one system (L (M, M), or a batch of one), one block per system for
    a batch of G > 1.  The kernels work in place on a row-major copy of L,
    made in one pass whatever L's layout; a batch of G > 1 sweeps a copy of
    W too, one system only reads it.  The caller's tensors are never
    written.  A refused cooperative launch raises.  Counted as variant ""
    for the cooperative sweep, "batched" for the one-block kernel."""
    G = L.shape[0] if L.ndim == 3 else 1
    M = L.shape[-1]
    K = W.shape[-2]
    out = L.clone(memory_format=torch.contiguous_format)
    if G == 0 or M == 0 or K == 0:
        return out
    if K > MAX_K:
        raise ValueError(f"chol_update takes at most {MAX_K} rows at once, got {K}")
    lib = _lib()
    if G == 1:
        work = W   # only read by the cooperative sweep
        scratch = torch.empty((lib.repro_chol_update_scratch(K),), dtype=torch.float32,
                              device=L.device)
    else:
        work = W.clone()
        scratch = None
    stream = torch.cuda.current_stream(L.device).cuda_stream
    rc = lib.repro_chol_update(_build.ptr(out), _build.ptr(work), G, M, K,
                               _build.ptr(scratch), ctypes.c_void_p(stream))
    _build.check_launch(rc, "chol_update")
    COUNTER.add("" if G == 1 else "batched")
    return out
