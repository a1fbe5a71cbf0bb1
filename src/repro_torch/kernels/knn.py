"""Blocked k-nearest-neighbour search: the Vecchia conditioning sets.

Counterpart of ``repro/kernels/knn.py`` in plain PyTorch.  The Vecchia
approximation (``core/vecchia.py``) needs, for every query (or every
training row), the indices of its k nearest training rows.  The training
set streams through in blocks of ``block_t`` rows; each block's squared
distances (``sq_dists``: q^2 + t^2 - 2 q.t, as in the JAX package) are
concatenated with the running best k and cut back to k.  No Q x N or
N x N tensor is formed.

Where the JAX package maps over query blocks of ``block_q`` rows one at a
time, this module takes as many query rows together as fit in
``_CANDIDATES`` floats of distance tile: rows = max(block_q,
_CANDIDATES // block_t), rounded down to whole query blocks.  A pass over
one training block holds a few (rows, block_t) float tiles (the cross
term, the distances) and the (rows, k + block_t) candidate set with its
int64 indices and sort: at most five such tiles and twelve four-byte
words a candidate, bounded by the block sizes, never by Q or N
(``chip_smoke.py`` holds the card's peak bytes to that bound).  A row's
result does not depend on which rows share its pass: every operation is
per element or per row, and the candidates are cut back by a stable
sort, so ties in distance keep the lower training index, as
``jax.lax.top_k`` and a stable ``argsort`` do.

The cross term q.t is a sum over the p input axes taken element by
element, not a matrix product, so it is full float32 on the card whatever
the TF32 settings (``torch.backends.cuda.matmul.allow_tf32``).

``ordered_topk`` adds the Vecchia ordering: row i conditions only on rows
j < i.  Training blocks wholly at or beyond a pass's last row are
skipped: every candidate in them is inadmissible.
"""
from __future__ import annotations

import torch

__all__ = ["knn_search", "ordered_topk", "rows_per_pass", "sq_dists"]

# candidate-tile budget of one pass (floats of the (rows, block_t) tile)
_CANDIDATES = 1 << 23


def sq_dists(Xq: torch.Tensor, Xt: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (Bq, Bt) between two point blocks."""
    q2 = torch.sum(Xq * Xq, dim=1)[:, None]
    t2 = torch.sum(Xt * Xt, dim=1)[None, :]
    cross = Xq[:, 0, None] * Xt[None, :, 0]
    for j in range(1, Xq.shape[1]):
        cross = cross + Xq[:, j, None] * Xt[None, :, j]
    return torch.clamp(q2 + t2 - 2.0 * cross, min=0.0)


def rows_per_pass(block_q: int, block_t: int) -> int:
    """Query rows taken together against each training block."""
    return max(block_q, (_CANDIDATES // block_t) // block_q * block_q)


def _scan_topk(Xq, Xt, k: int, block_t: int, first=None):
    """Streamed top-k of the query rows Xq (R, p) over the training rows Xt
    (N, p).  ``first``, if given, is the global row index of Xq's first
    row, and admits only training rows j below each query's own index.
    Returns (dists (R, k) ascending, idx (R, k) int64); inadmissible slots
    hold +inf and index 0."""
    R, N = Xq.shape[0], Xt.shape[0]
    best_d = torch.full((R, k), float("inf"), dtype=Xq.dtype, device=Xq.device)
    best_i = torch.zeros((R, k), dtype=torch.int64, device=Xq.device)
    stop = N
    if first is not None:
        iq = torch.arange(first, first + R, device=Xq.device)
        stop = min(N, first + R - 1)
    for lo in range(0, stop, block_t):
        hi = min(lo + block_t, N)
        d = sq_dists(Xq, Xt[lo:hi])                            # (R, Bt)
        j = torch.arange(lo, hi, device=Xq.device)
        if first is not None:
            d = torch.where(j[None, :] >= iq[:, None], float("inf"), d)
        cand_d = torch.cat([best_d, d], dim=1)                 # (R, k + Bt)
        cand_i = torch.cat([best_i, j[None, :].expand(R, -1)], dim=1)
        srt, pos = torch.sort(cand_d, dim=1, stable=True)
        # copies, so that the (R, k + Bt) sort outputs do not outlive the
        # next block's sort (a view would keep them to the end of the pass)
        best_d = srt[:, :k].contiguous()
        best_i = torch.gather(cand_i, 1, pos[:, :k])
    return best_d, best_i


def knn_search(Xq: torch.Tensor, Xt: torch.Tensor, k: int, *,
               block_q: int = 128, block_t: int = 512):
    """For each query row, the k nearest training rows.

    Returns (dists (Q, k), idx (Q, k) int64): squared distances ascending
    and the matching training indices.  No Q x N distance matrix is
    formed (see the module docstring)."""
    Q, N = Xq.shape[0], Xt.shape[0]
    if k < 1 or k > N:
        raise ValueError(f"knn_search needs 1 <= k <= N={N}, got k={k}")
    block_q = max(1, min(block_q, Q))
    block_t = max(1, min(block_t, N))
    step = rows_per_pass(block_q, block_t)
    out = [_scan_topk(Xq[lo:lo + step], Xt, k, block_t) for lo in range(0, Q, step)]
    return torch.cat([d for d, _ in out]), torch.cat([i for _, i in out])


def ordered_topk(X: torch.Tensor, k: int, *, block_q: int = 128, block_t: int = 512):
    """Vecchia conditioning sets under the natural ordering: for each row
    i, the (up to) k nearest rows among j < i.

    Returns (idx (N, k) int64, mask (N, k) in X's dtype): ``mask[i, s] ==
    1`` marks a valid neighbour; rows i < k have spare slots masked 0, their
    index clamped to 0 so gathers stay in bounds."""
    N = X.shape[0]
    if k < 1 or k > N:
        raise ValueError(f"ordered_topk needs 1 <= k <= N={N}, got k={k}")
    block_q = max(1, min(block_q, N))
    block_t = max(1, min(block_t, N))
    step = rows_per_pass(block_q, block_t)
    out = [_scan_topk(X[lo:lo + step], X, k, block_t, first=lo)
           for lo in range(0, N, step)]
    d = torch.cat([d for d, _ in out])
    i = torch.cat([i for _, i in out])
    mask = torch.isfinite(d)
    return torch.where(mask, i, 0), mask.to(X.dtype)
