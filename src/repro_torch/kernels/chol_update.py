"""Rank-K Cholesky update L <- chol(L L^T + W^T W) as K sequential rank-1
LINPACK sweeps, all in one launch, for one system (L (M, M), W (K, M)) or a
batch of G independent ones (L (G, M, M), W (G, K, M)).

This step is not a TPU kernel: the JAX package runs
``repro/core/fagp.py::_chol_rank1_update`` as one compiled ``lax.scan``
inside ``_update_arrays`` (whenever K * 8 <= M), vmapped over the update
groups by ``repro/bank/bank.py::_bank_update_scatter_impl``.  Eagerly in
PyTorch that sweep is K * M dependent steps, several launches each, so on
the card it is a kernel of its own.

CUDA kernels: ``csrc/chol_update.cu``, one sweep run two ways.  Bound on
the H100: ideally one pass over the M x M triangle; in practice the chain
of dependent rotations, (M / 32) (K + 31) pivot steps.  Rows come in groups
of 32 with their columns of W in shared memory; each 32-column panel is
factored by two warps walking its anti-diagonals while the warp that owns
the next panel's rows still applies the previous panel to them.  One
system runs a persistent cooperative kernel over every SM (the row groups
spread over the blocks, one ``grid.sync()`` per panel); a batch runs the
same sweep in one block of 3 warps per system, each factor column-major,
sized by :func:`chol_update_batch_plan` (at the fleet's 512 systems of
M = 625, K = 16: 4 blocks per SM, one wave; 1.25 ms on an NVIDIA H100
80GB HBM3 at 700 W, against 15.0 ms for the batched library refactor).
Both round every rotation alike, so the two give bitwise equal factors.
Its plain version, :func:`chol_update_plain`, is the faithful column loop,
vectorised over the batch (one launch per step covers every system, not
one per system).

The downdate, chol(L L^T - W^T W) (``repro/bank/bank.py::_chol_rank1_downdate``
and ``_downdate_arrays``, a ``lax.scan`` vmapped over the groups of
``_bank_downdate_scatter``), is the batch's sweep with hyperbolic rotations
(``chol_downdate_batch_kernel``, a template instance of the same body, for
any G including one), written out of place, with one ``ok`` flag per
system: False where a pivot was lost (r^2 <= 1e-6 Lkk^2, the reference's
``_DOWNDATE_TOL``), the factor then garbage for the caller to discard.  It
has no refactorization branch: subtracting and refactoring NaNs silently
where a pivot is lost.  Its plain version, :func:`chol_downdate_plain`, is
the reference's column loop, vectorised over the batch.  Counted as
variant "downdate".
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["chol_rank1_update", "chol_update_plain", "chol_update_cuda",
           "chol_update_plan", "chol_update_batch_plan", "chol_rank1_downdate",
           "chol_downdate_plain", "chol_downdate_cuda", "chol_downdate_batch_plan",
           "DOWNDATE_TOL", "COUNTER"]

COUNTER = _build.LaunchCounter("chol_update")
_PLAN_KEYS = ("blocks", "threads", "w_chunk", "groups_per_block", "smem_bytes")
_BATCH_PLAN_KEYS = ("threads", "w_chunk", "w_in_shared", "smem_bytes",
                    "resident_blocks_per_sm", "scratch_floats")
# a downdated pivot is lost when r^2 <= DOWNDATE_TOL Lkk^2: the reference's
# repro/bank/bank.py::_DOWNDATE_TOL (float32 eps is ~1.2e-7; anything this
# small is noise-dominated and the refit takes over)
DOWNDATE_TOL = 1e-6


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


def chol_rank1_downdate(L: torch.Tensor, w: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Cholesky of L L^T - w w^T, in place on L (..., M, M) and w (..., M),
    O(M^2) per system: the hyperbolic sweep of
    ``repro/bank/bank.py::_chol_rank1_downdate`` column by column, in its
    order of operations; ``ok`` (bool, the batch shape) is cleared in place
    where a pivot is lost.  A zero w is an exact identity."""
    M = L.shape[-1]
    for k in range(M):
        Lkk = L[..., k, k]
        wk = w[..., k]
        r2 = Lkk * Lkk - wk * wk
        ok &= r2 > DOWNDATE_TOL * Lkk * Lkk
        r = torch.sqrt(torch.clamp(r2, min=1e-30))
        c = (r / Lkk)[..., None]
        s = (wk / Lkk)[..., None]
        col = L[..., k + 1:, k]              # views: updated in place
        wt = w[..., k + 1:]
        col.sub_(s * wt).div_(c)             # (col - s w) / c
        wt.mul_(c).sub_(s * col)             # c w - s col
        L[..., k, k] = r
    return L


def chol_downdate_plain(L: torch.Tensor, W: torch.Tensor):
    """Plain version of the downdate: the K hyperbolic sweeps, one after
    the other, on copies; L (M, M) and W (K, M), or a batch L (G, M, M) and
    W (G, K, M).  Returns (factor, ok)."""
    L = L.clone()
    W = W.clone()
    ok = torch.ones(L.shape[:-2], dtype=torch.bool, device=L.device)
    for k in range(W.shape[-2]):
        chol_rank1_downdate(L, W[..., k, :], ok)
    return L, ok


def _lib() -> ctypes.CDLL:
    lib = _build.library("chol_update")
    lib.repro_chol_update.restype = ctypes.c_int
    lib.repro_chol_update.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_void_p]
    lib.repro_chol_update_scratch.restype = ctypes.c_longlong
    lib.repro_chol_update_scratch.argtypes = [ctypes.c_int]
    lib.repro_chol_update_batch.restype = ctypes.c_int
    lib.repro_chol_update_batch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p]
    lib.repro_chol_downdate_batch.restype = ctypes.c_int
    lib.repro_chol_downdate_batch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    for fn in (lib.repro_chol_update_plan, lib.repro_chol_update_batch_plan,
               lib.repro_chol_downdate_batch_plan):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    return lib


def chol_update_plan(M: int, K: int) -> dict:
    """The single-system sweep's launch on the current card: its grid
    (occupancy x SMs, capped by the 32-row groups), threads per block, the
    chunk of W kept in shared memory, row groups per block and shared
    bytes per block."""
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    _build.check_launch(_lib().repro_chol_update_plan(M, K, out), "chol_update (plan)")
    return dict(zip(_PLAN_KEYS, out))


def chol_update_batch_plan(M: int, K: int) -> dict:
    """A batch's launch on the current card (one block per system): threads
    per block, the chunk of W swept at once, whether W is kept in shared
    memory (else in global scratch), shared bytes per block, resident
    blocks per SM and scratch floats per system."""
    out = (ctypes.c_longlong * len(_BATCH_PLAN_KEYS))()
    _build.check_launch(_lib().repro_chol_update_batch_plan(M, K, out),
                        "chol_update (batch plan)")
    return dict(zip(_BATCH_PLAN_KEYS, out))


def chol_downdate_batch_plan(M: int, K: int) -> dict:
    """The downdate's launch on the current card, as
    :func:`chol_update_batch_plan` gives the update's."""
    out = (ctypes.c_longlong * len(_BATCH_PLAN_KEYS))()
    _build.check_launch(_lib().repro_chol_downdate_batch_plan(M, K, out),
                        "chol_downdate (batch plan)")
    return dict(zip(_BATCH_PLAN_KEYS, out))


def chol_downdate_cuda(L: torch.Tensor, W: torch.Tensor):
    """Launch ``csrc/chol_update.cu``'s downdate on L's card and stream: one block
    per system (a 2-D L is a batch of one), each factor read column-major
    from L (no copy where L is already column-major, as the factors of
    ``torch.linalg.cholesky`` are) into a new column-major tensor; W is only
    read.  Returns (factor, ok) with ``ok`` a bool tensor on the card."""
    with _build.on_device(L):
        one = L.ndim == 2
        Lb, Wb = (L[None], W[None]) if one else (L, W)
        G, M, K = Lb.shape[0], Lb.shape[-1], Wb.shape[-2]
        src = Lb.mT.contiguous()      # each factor column-major: L^T row-major
        ok = torch.ones((G,), dtype=torch.int32, device=L.device)
        if G == 0 or M == 0 or K == 0:
            out = src.clone()
        else:
            out = torch.empty_like(src)
            scratch = torch.empty((G * chol_downdate_batch_plan(M, K)["scratch_floats"],),
                                  dtype=torch.float32, device=L.device)
            stream = ctypes.c_void_p(torch.cuda.current_stream(L.device).cuda_stream)
            rc = _lib().repro_chol_downdate_batch(_build.ptr(src), _build.ptr(out), _build.ptr(Wb),
                                                  G, M, K, _build.ptr(scratch), _build.ptr(ok),
                                                  stream)
            _build.check_launch(rc, "chol_downdate (batch)")
            COUNTER.add("downdate")
        out, ok = out.mT, ok.bool()
        return (out[0], ok[0]) if one else (out, ok)


def chol_update_cuda(L: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/chol_update.cu`` on L's card and stream: the cooperative sweep
    for one system (L (M, M), or a batch of one) in place on a row-major
    copy of L, made in one pass whatever L's layout; for a batch of G > 1
    one block per system, each factor column-major, read from L (no copy
    where L is already column-major, as the factors of
    ``torch.linalg.cholesky`` are) into a new column-major tensor.  W is
    only read.  The caller's tensors are never written.  A refused launch
    raises.  Counted as variant "" for the cooperative sweep, "batched" for
    the one-block kernel."""
    with _build.on_device(L):
        G = L.shape[0] if L.ndim == 3 else 1
        M = L.shape[-1]
        K = W.shape[-2]
        lib = _lib()
        stream = ctypes.c_void_p(torch.cuda.current_stream(L.device).cuda_stream)
        if G > 1:
            src = L.mT.contiguous()   # each factor column-major: L^T row-major
            out = torch.empty_like(src)
            if M == 0 or K == 0:
                return src.clone().mT
            scratch = torch.empty((G * chol_update_batch_plan(M, K)["scratch_floats"],),
                                  dtype=torch.float32, device=L.device)
            rc = lib.repro_chol_update_batch(_build.ptr(src), _build.ptr(out), _build.ptr(W),
                                             G, M, K, _build.ptr(scratch), stream)
            _build.check_launch(rc, "chol_update (batch)")
            COUNTER.add("batched")
            return out.mT
        out = L.clone(memory_format=torch.contiguous_format)
        if G == 0 or M == 0 or K == 0:
            return out
        scratch = torch.empty((lib.repro_chol_update_scratch(K),), dtype=torch.float32,
                              device=L.device)
        rc = lib.repro_chol_update(_build.ptr(out), _build.ptr(W), G, M, K,
                                   _build.ptr(scratch), stream)
        _build.check_launch(rc, "chol_update")
        COUNTER.add("")
        return out
