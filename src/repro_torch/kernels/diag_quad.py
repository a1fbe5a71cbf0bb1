"""Diagonal of a quadratic form, var_i = a_i^T C a_i, without the N x N
matrix.  The CUDA kernel replaces the TPU kernel
``repro/kernels/diag_quad.py::diag_quad_kernel``.

CUDA kernel: ``csrc/diag_quad.cu``.  Bound on the H100: float32 operations
(2 N M^2 per call; 0.82 ms for a 128-row microbatch at M = 14,641, ahead of
the 0.26 ms read of C).  A block computes a 128 x 128 tile of A C (all
128 rows of a microbatch against one 128-column strip of C, so C is read
once) in 8 x 8 register tiles fed by a 3-stage ``cp.async`` ring; the k axis
is split S ways so the strips fill whole waves of the card, and a second
small kernel sums the per-block partials in a fixed order.  C need not be
symmetric.  Its plain version, :func:`diag_quad_plain`, is what a CPU
tensor runs.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["diag_quad_plain", "diag_quad_cuda", "diag_quad_plan", "COUNTER"]

COUNTER = _build.LaunchCounter("diag_quad")
_PLANS: dict = {}


def diag_quad_plain(A: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Plain version: sum_l (A C)_il A_il -> (N,)."""
    return torch.sum((A @ C) * A, dim=1)


def diag_quad_plan(N: int, M: int, device=None) -> dict:
    """The kernel's launch for A (N, M) on a card: 128-column strips, the
    split S of the k axis, 32-deep slices per part, row tiles and the
    resident blocks it was sized for (from the card's occupancy)."""
    dev = torch.device("cuda" if device is None else device)
    # keyed by the card's index: each card has its own occupancy
    key = (N, M, dev.index if dev.index is not None else torch.cuda.current_device())
    if key not in _PLANS:
        lib = _build.library("diag_quad")
        fn = lib.repro_diag_quad_plan
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        out = (ctypes.c_int * 5)()
        with torch.cuda.device(key[2]):
            _build.check_launch(fn(N, M, out), "diag_quad (plan)")
        _PLANS[key] = dict(zip(("strips", "S", "slices_per_part", "row_tiles",
                                "resident_blocks"), out))
    return _PLANS[key]


def diag_quad_cuda(A: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/diag_quad.cu`` on A's card and stream -> (N,)."""
    N, M = A.shape
    out = torch.empty((N,), dtype=torch.float32, device=A.device)
    if N == 0:
        return out
    if M == 0:
        return out.zero_()
    plan = diag_quad_plan(N, M, A.device)
    partial = torch.empty((plan["strips"] * plan["S"], N), dtype=torch.float32,
                          device=A.device)
    lib = _build.library("diag_quad")
    fn = lib.repro_diag_quad
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    with _build.on_device(A):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = fn(_build.ptr(A), _build.ptr(C), N, M, plan["S"], plan["slices_per_part"],
                _build.ptr(partial), _build.ptr(out), ctypes.c_void_p(stream))
    _build.check_launch(rc, "diag_quad")
    COUNTER.add()
    return out
