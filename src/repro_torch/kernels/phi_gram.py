"""Streaming fused fit: G = Phi^T Phi and b = Phi^T y with Phi never
written to device memory, and with ``scale`` the epilogue
B = I + D G D / sigma^2.  The CUDA kernel replaces the TPU kernels
``repro/kernels/phi_gram.py::phi_gram_kernel`` (one model) and
``repro/kernels/phi_gram.py::bank_phi_gram_kernel`` (a bank of B models:
unscaled G_s and b_s for every slot s in one launch, the slot a grid axis).

CUDA kernel: ``csrc/phi_gram.cu``.  Bound on the H100: float32 operations
on the CUDA cores (N M (M + 1) flops for the symmetric Gram; 32 ms at
N = 10^4, M = 14,641).  Each block owns one 128 x 128 tile of the upper
triangle and loops over all N rows itself (no atomics, no carry between
blocks), 8 x 8 register tiles a thread, so a feature built feeds 64 FMAs.
The feature tiles are rebuilt from X in shared memory through a two-stage
ring: the next 32 rows' features are built while this step's FMAs run,
one barrier a step, each Hermite feature p shared loads at offsets staged
once per block.  Every entry is summed in the reference kernel's two
levels, in strips of 1,024 rows (four of its ``block_k`` tiles; one fmaf
per row, in row order) added in row order, the running totals waiting in
the block's own output tile between strips, so B is exactly symmetric
and bitwise the scaled
Gram of the stored features
(``csrc/scaled_gram.cu``).  On an NVIDIA H100 80GB HBM3 at 700 W it takes
62.4-62.9 ms at N = 10^4, M = 14,641 (``Phi^T Phi`` on a stored Phi: 81
ms), the bank 71.9 ms at 512 slots of 10^4 rows, M = 625 (``bmm``: 78 ms),
5-6% above the one-chain sums it replaced.  :func:`phi_gram_plan` reports the launch.  Its
plain version, :func:`phi_gram_plain`, materializes one row block of Phi at
a time; it is what a CPU tensor runs.  The bank's plain version,
:func:`bank_phi_gram_plain`, runs it slot by slot, so it never forms a
(B, N, M) Phi either.

The bank entry also takes a stacked tile (``TileArgs.slots``: one Hermite
constant table or RFF table per slot, a heterogeneous bank's refit): each
block reads its slot's map at a slot stride, so with every slot's map
equal the moments are bitwise those of the shared launch.  It is counted
as variant "bank_slots" (the shared map: "bank").
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .hermite_phi import KINDS, TileArgs, plain_tile, slot_tile

__all__ = ["phi_gram_plain", "phi_gram_cuda", "phi_gram_plan",
           "bank_phi_gram_plain", "bank_phi_gram_cuda", "COUNTER"]

COUNTER = _build.LaunchCounter("phi_gram")
PLAIN_BLOCK = 4096
MAX_BANK = 65535  # slots are the grid's y axis
_PLAN_KEYS = ("tile", "rows_per_step", "stages", "steps", "tile_rows",
              "blocks_per_slot", "blocks", "smem_bytes", "resident_blocks_per_sm",
              "strip_rows")


def phi_gram_plain(X, y, mask, tile: TileArgs, d, sig2, scale: bool,
                   block_rows: int = PLAIN_BLOCK):
    """Plain version: (B or G (M, M), b (M,)) accumulated over row blocks
    of ``block_rows`` masked features, b = Phi^T (mask * y)."""
    M = tile.M
    G = torch.zeros((M, M), dtype=torch.float32, device=X.device)
    b = torch.zeros((M,), dtype=torch.float32, device=X.device)
    for lo in range(0, X.shape[0], block_rows):
        m = mask[lo:lo + block_rows]
        Phi = plain_tile(X[lo:lo + block_rows], tile) * m[:, None]
        G += Phi.T @ Phi
        b += Phi.T @ (y[lo:lo + block_rows] * m)
    if scale:
        G = G * (d[:, None] * d[None, :] / sig2) \
            + torch.eye(M, dtype=torch.float32, device=X.device)
    return G, b


def phi_gram_plan(N: int, M: int, nbank: int = 1, kind: str = "hermite",
                  p: int = 1, n: int = 1, device=None) -> dict:
    """The kernel's launch for N rows of a bank of ``nbank`` slots (1: the
    one-model kernel) at M features of a ``kind`` tile with p inputs and
    recurrence depth n: the tile edge, rows per step, ring stages, steps,
    tile rows, blocks per slot and in all, shared bytes per block, the
    resident blocks per SM the card gives it and the rows a strip sums
    before it joins the running total."""
    dev = torch.device("cuda" if device is None else device)
    lib = _build.library("phi_gram")
    fn = lib.repro_phi_gram_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    with torch.cuda.device(dev):
        _build.check_launch(fn(N, M, nbank, KINDS[kind], p, n, out), "phi_gram (plan)")
    return dict(zip(_PLAN_KEYS, out))


def phi_gram_cuda(X, y, mask, tile: TileArgs, d, sig2: float, scale: bool):
    """Launch ``csrc/phi_gram.cu`` on X's card and stream -> (B or G, b)."""
    N, p = X.shape
    M = tile.M
    out = torch.empty((M, M), dtype=torch.float32, device=X.device)
    b = torch.empty((M,), dtype=torch.float32, device=X.device)
    if M == 0:
        return out, b
    lib = _build.library("phi_gram")
    fn = lib.repro_phi_gram
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    with _build.on_device(X):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = fn(_build.ptr(X), _build.ptr(y), _build.ptr(mask), N, p, M, KINDS[tile.kind],
                tile.n_max, _build.ptr(tile.consts), _build.ptr(tile.coef),
                _build.ptr(tile.idx), _build.ptr(tile.table), _build.ptr(d), float(sig2),
                int(bool(scale)), _build.ptr(out), _build.ptr(b), ctypes.c_void_p(stream))
    _build.check_launch(rc, "phi_gram")
    COUNTER.add("scale" if scale else "moments")
    return out, b


def bank_phi_gram_plain(Xb, yb, maskb, tile: TileArgs):
    """Plain version of the bank kernel: unscaled (G (B, M, M), b (B, M)),
    slot by slot in row blocks (each under its own map of a stacked tile)."""
    B = Xb.shape[0]
    G = torch.empty((B, tile.M, tile.M), dtype=torch.float32, device=Xb.device)
    b = torch.empty((B, tile.M), dtype=torch.float32, device=Xb.device)
    for s in range(B):
        ts = tile if tile.slots is None else slot_tile(tile, s)
        G[s], b[s] = phi_gram_plain(Xb[s], yb[s], maskb[s], ts, None, 1.0, False)
    return G, b


def bank_phi_gram_cuda(Xb, yb, maskb, tile: TileArgs):
    """Launch ``csrc/phi_gram.cu``'s bank entry on Xb's card and stream: one launch
    for all B slots -> unscaled (G (B, M, M), b (B, M)); a stacked tile
    gives each slot its own map."""
    B, N, p = Xb.shape
    M = tile.M
    G = torch.empty((B, M, M), dtype=torch.float32, device=Xb.device)
    b = torch.empty((B, M), dtype=torch.float32, device=Xb.device)
    if B == 0 or M == 0:
        return G, b
    if B > MAX_BANK:
        raise ValueError(f"the bank kernel takes at most {MAX_BANK} slots, got {B}")
    lib = _build.library("phi_gram")
    fn = lib.repro_bank_phi_gram
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong]
    per = tile.consts if tile.kind == "hermite" else tile.table
    stride = 0 if tile.slots is None else per[0].numel()
    with _build.on_device(Xb):
        stream = torch.cuda.current_stream(Xb.device).cuda_stream
        rc = fn(_build.ptr(Xb), _build.ptr(yb), _build.ptr(maskb), B, N, p, M,
                KINDS[tile.kind], tile.n_max, _build.ptr(tile.consts),
                _build.ptr(tile.coef), _build.ptr(tile.idx), _build.ptr(tile.table),
                _build.ptr(G), _build.ptr(b), ctypes.c_void_p(stream), stride)
    _build.check_launch(rc, "phi_gram (bank)")
    COUNTER.add("bank" if tile.slots is None else "bank_slots")
    return G, b
