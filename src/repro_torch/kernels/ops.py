"""Public wrappers around the kernels.

Counterpart of ``repro/kernels/ops.py``.  Each wrapper checks dtype,
device, shapes and contiguity, then dispatches by device: on a CUDA tensor
it launches the hand-written kernel (or raises: there is no fallback), on a
CPU tensor it runs the kernel's plain PyTorch version.  No padding is
needed: the kernels mask their own ragged edges.

Launch counts: every kernel module keeps a ``COUNTER`` that its launch
function bumps right after a launch; :func:`launch_counts` reads them all
and :func:`reset_launch_counts` sets them to zero.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import chol_update as _chol
from . import diag_quad as _dq
from . import gram as _sgram
from . import hermite_phi as _phi
from . import phi_gram as _gram
from .hermite_phi import TileArgs

__all__ = [
    "TileArgs", "expansion_phi", "fused_fit_moments",
    "bank_fused_fit_moments", "scaled_gram", "diag_quad", "chol_update",
    "chol_downdate", "launch_counts", "reset_launch_counts",
]

_COUNTERS = (_phi.COUNTER, _gram.COUNTER, _dq.COUNTER, _chol.COUNTER,
             _sgram.COUNTER)
_F32_I32 = (torch.float32, torch.int32)


def launch_counts() -> dict:
    """{kernel: {variant: launches}} since the last reset."""
    return {c.name: dict(c.counts) for c in _COUNTERS}


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        c.reset()


def _on_cuda(name: str, *tensors: torch.Tensor, dtypes: tuple = _F32_I32) -> bool:
    """True for CUDA inputs, False for CPU inputs; raises on anything else
    (mixed devices, a dtype outside ``dtypes`` -- float32 and int32 unless a
    wrapper widens it -- or a non-contiguous input)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {sorted(map(str, devices))}")
    dev = devices.pop()
    for t in tensors:
        if t.dtype not in dtypes:
            want = " or ".join(str(d).replace("torch.", "") for d in dtypes)
            raise TypeError(f"{name}: expected {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: input of shape {tuple(t.shape)} is not contiguous")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {dev}")


def _check_tile(name: str, tile: TileArgs, p: int, stacked: Optional[int] = None) -> None:
    """A tile of p inputs: shared, or where the caller takes one, stacked
    with ``stacked`` slot maps (``TileArgs.slots``)."""
    if tile.kind not in ("hermite", "rff"):
        raise ValueError(f"{name}: unknown tile kind {tile.kind!r}")
    C = tile.slots
    if C is not None and C != stacked:
        raise ValueError(f"{name}: a stacked tile of {C} slot maps where "
                         f"{'a shared tile' if stacked is None else f'{stacked} maps'} "
                         f"is taken")
    lead = () if C is None else (C,)
    if tile.kind == "hermite":
        if tile.consts.shape != lead + (p, 3) or tile.idx.shape != (tile.M, p) \
                or tile.coef.shape[0] != 2 or tile.coef.shape[1] < tile.n_max:
            raise ValueError(f"{name}: Hermite tile does not match p={p}")
        if tile.idx.dtype != torch.int32:
            raise TypeError(f"{name}: the index table must be int32")
    elif tile.table.shape != lead + (p + 1, tile.M):
        raise ValueError(f"{name}: RFF table must be {lead + (p + 1, tile.M)}, "
                         f"got {tuple(tile.table.shape)}")


def _check_slots(name: str, tile: TileArgs, slots: Optional[torch.Tensor], N: int) -> None:
    """Per-row slots (N,) int32 into a stacked Hermite tile, or None.  The
    caller keeps them in [0, C): the kernel does not check them."""
    if slots is None:
        return
    if tile.kind != "hermite" or tile.slots is None:
        raise ValueError(f"{name}: per-row slots take a stacked Hermite tile (an RFF "
                         f"caller scales its rows instead)")
    if slots.dtype != torch.int32 or tuple(slots.shape) != (N,):
        raise ValueError(f"{name}: slots must be ({N},) int32, got {tuple(slots.shape)} "
                         f"{slots.dtype}")


def expansion_phi(X: torch.Tensor, tile: TileArgs,
                  slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phi(X): (N, p) -> (N, M) features of the expansion ``tile``; with
    ``slots`` (N,) int32, row r under slot ``slots[r]``'s constants of a
    stacked Hermite tile (values in [0, C), not checked on the card)."""
    X = X.contiguous()
    _check_tile("expansion_phi", tile, X.shape[1], None if slots is None else tile.slots)
    _check_slots("expansion_phi", tile, slots, X.shape[0])
    extra = [] if slots is None else [slots.contiguous()]
    if _on_cuda("expansion_phi", X, *tile.tensors(), *extra):
        return _phi.phi_features_cuda(X, tile, *extra)
    return _phi.phi_features_plain(X, tile, *extra)


def fused_fit_moments(
    X: torch.Tensor,
    y: torch.Tensor,
    tile: TileArgs,
    sqrtlam: Optional[torch.Tensor],
    sig2: float,
    mask: Optional[torch.Tensor] = None,
    *,
    scale: bool = True,
    block_rows: int = _gram.PLAIN_BLOCK,
):
    """Streaming fit statistics, Phi never materialized on the card.

    scale=True  -> (B, b), B = I + D Phi^T Phi D / sig2, D = diag(sqrtlam)
    scale=False -> (G, b), G = Phi^T Phi (sqrtlam and sig2 unused)
    b = Phi^T (mask * y) in both cases; rows with mask 0 contribute nothing.
    ``block_rows`` is the row block of the plain version (a CPU tensor's
    only Phi buffer); the kernel streams its own tiles.
    """
    X = X.contiguous()
    N, p = X.shape
    y = y.reshape(-1).contiguous()
    if y.shape[0] != N:
        raise ValueError(f"fused_fit_moments: y has {y.shape[0]} rows, X has {N}")
    if mask is None:
        mask = torch.ones((N,), dtype=torch.float32, device=X.device)
    mask = mask.reshape(-1).to(torch.float32).contiguous()
    if mask.shape[0] != N:
        raise ValueError(f"fused_fit_moments: mask has {mask.shape[0]} rows, X has {N}")
    if scale:
        if sqrtlam is None or sqrtlam.shape != (tile.M,):
            raise ValueError("fused_fit_moments: scale=True needs sqrtlam of shape (M,)")
        d = sqrtlam.contiguous()
    else:
        d = torch.ones((tile.M,), dtype=torch.float32, device=X.device)
    _check_tile("fused_fit_moments", tile, p)
    sig2 = float(sig2)
    if _on_cuda("fused_fit_moments", X, y, mask, d, *tile.tensors()):
        return _gram.phi_gram_cuda(X, y, mask, tile, d, sig2, scale)
    return _gram.phi_gram_plain(X, y, mask, tile, d, sig2, scale, block_rows)


def bank_fused_fit_moments(
    Xb: torch.Tensor,
    yb: torch.Tensor,
    tile: TileArgs,
    mask: Optional[torch.Tensor] = None,
):
    """Raw fit moments of a bank of B independent models in one launch:
    G (B, M, M) with G_s = Phi_s^T Phi_s and b (B, M) with
    b_s = Phi_s^T (mask_s * y_s), Phi never materialized on the card.
    Xb (B, N, p), yb (B, N), mask (B, N): rows with mask 0 contribute
    nothing (ragged per-slot N on a fixed stack).  ``tile`` is shared, or
    stacked with one map per slot (B of them)."""
    Xb = Xb.contiguous()
    if Xb.ndim != 3:
        raise ValueError(f"bank_fused_fit_moments: Xb must be (B, N, p), got {tuple(Xb.shape)}")
    B, N, p = Xb.shape
    yb = yb.contiguous()
    if tuple(yb.shape) != (B, N):
        raise ValueError(f"bank_fused_fit_moments: yb must be {(B, N)}, got {tuple(yb.shape)}")
    if mask is None:
        mask = torch.ones((B, N), dtype=torch.float32, device=Xb.device)
    mask = mask.to(torch.float32).contiguous()
    if tuple(mask.shape) != (B, N):
        raise ValueError(f"bank_fused_fit_moments: mask must be {(B, N)}, got {tuple(mask.shape)}")
    _check_tile("bank_fused_fit_moments", tile, p, B)
    if _on_cuda("bank_fused_fit_moments", Xb, yb, mask, *tile.tensors()):
        return _gram.bank_phi_gram_cuda(Xb, yb, mask, tile)
    return _gram.bank_phi_gram_plain(Xb, yb, mask, tile)


def scaled_gram(Phi: torch.Tensor, sqrtlam: torch.Tensor, sig2) -> torch.Tensor:
    """B = I + D Phi^T Phi D / sig2, D = diag(sqrtlam), from a materialized
    Phi (N, M) in float32 or bfloat16; accumulated and returned in
    float32 (M, M)."""
    Phi = Phi.contiguous()
    if Phi.ndim != 2:
        raise ValueError(f"scaled_gram: Phi must be (N, M), got {tuple(Phi.shape)}")
    d = sqrtlam.reshape(-1).to(torch.float32).contiguous()
    if d.shape[0] != Phi.shape[1]:
        raise ValueError(f"scaled_gram: sqrtlam has {d.shape[0]} entries, "
                         f"Phi {Phi.shape[1]} columns")
    sig2 = float(sig2)
    if _on_cuda("scaled_gram", Phi, d, dtypes=(torch.float32, torch.bfloat16)):
        return _sgram.scaled_gram_cuda(Phi, d, sig2)
    return _sgram.scaled_gram_plain(Phi, d, sig2)


def diag_quad(A: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """diag(A C A^T): (N,) without the N x N matrix.  A column-major C (as
    ``torch.cholesky_inverse`` returns B^-1) is read as its row-major
    transpose, never copied: diag(A C^T A^T) is the same function."""
    A = A.contiguous()
    if not C.is_contiguous() and C.mT.is_contiguous():
        C = C.mT
    C = C.contiguous()
    if A.ndim != 2 or C.shape != (A.shape[1], A.shape[1]):
        raise ValueError(f"diag_quad: shapes {tuple(A.shape)} and {tuple(C.shape)}")
    if _on_cuda("diag_quad", A, C):
        return _dq.diag_quad_cuda(A, C)
    return _dq.diag_quad_plain(A, C)


def chol_update(L: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """chol(L L^T + W^T W) for lower-triangular L (M, M) and W (K, M), by K
    sequential rank-1 sweeps, or for a batch of G independent systems,
    L (G, M, M) and W (G, K, M), in one launch.  Returns a new tensor: the
    inputs are never written.  L may have any layout (a column-major
    factor from torch.linalg.cholesky too): both versions copy it first."""
    W = W.contiguous()
    if L.ndim not in (2, 3) or W.ndim != L.ndim or L.shape[-1] != L.shape[-2] \
            or W.shape[-1] != L.shape[-1] or L.shape[:-2] != W.shape[:-2]:
        raise ValueError(f"chol_update: shapes {tuple(L.shape)} and {tuple(W.shape)}")
    if L.device != W.device or L.dtype != W.dtype:
        raise ValueError(f"chol_update: L is {L.dtype} on {L.device}, W {W.dtype} on {W.device}")
    if _on_cuda("chol_update", W):
        return _chol.chol_update_cuda(L, W)
    return _chol.chol_update_plain(L, W)


def chol_downdate(L: torch.Tensor, W: torch.Tensor):
    """chol(L L^T - W^T W) for lower-triangular L (M, M) and W (K, M), by K
    sequential hyperbolic rank-1 sweeps, or for a batch of G independent
    systems, L (G, M, M) and W (G, K, M), in one launch.  Returns (factor,
    ok): ``ok`` (bool, () or (G,)) is False for a system that lost a pivot
    (r^2 <= 1e-6 Lkk^2), whose factor is then garbage for the caller to
    discard.  New tensors: the inputs are never written.  L may have any
    layout."""
    W = W.contiguous()
    if L.ndim not in (2, 3) or W.ndim != L.ndim or L.shape[-1] != L.shape[-2] \
            or W.shape[-1] != L.shape[-1] or L.shape[:-2] != W.shape[:-2]:
        raise ValueError(f"chol_downdate: shapes {tuple(L.shape)} and {tuple(W.shape)}")
    if L.device != W.device or L.dtype != W.dtype:
        raise ValueError(f"chol_downdate: L is {L.dtype} on {L.device}, W {W.dtype} on "
                         f"{W.device}")
    if _on_cuda("chol_downdate", W):
        return _chol.chol_downdate_cuda(L, W)
    return _chol.chol_downdate_plain(L, W)
