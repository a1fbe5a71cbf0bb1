"""Scaled Gram matrix from a materialized feature matrix:
B = I + D (Phi^T Phi) D / sigma^2, D = diag(d), accumulated in float32
from a float32 or bfloat16 Phi.  The CUDA kernel replaces the TPU kernel
``repro/kernels/gram.py::scaled_gram_kernel``, the paper's own
formulation (Phi written out, its Gram from one product).

CUDA kernel: ``csrc/scaled_gram.cu``, the fused fit's FMA core
(``csrc/phi_gram.cu``) fed from the stored Phi.  Bound on the H100:
float32 operations on the CUDA cores (N M (M + 1) flops for the symmetric
Gram; 32 ms at N = 10^4, M = 14,641).  Each block owns one 128 x 128 tile
of the upper triangle, 8 x 8 register tiles a thread, loops over all N
rows itself (no carry between blocks) and mirrors its tile below the
diagonal.  The 32-row slices of Phi come through a three-stage
shared-memory ring, loaded a quarter step at a time into registers between
the FMA rows (Phi's odd row pitch rules out 16-byte copies), so loads
overlap the FMAs, one barrier a step.  Ragged edges are masked, so Phi is
never padded.  Every entry is summed as the fused fit sums it, in strips
of 1,024 rows (one fmaf per row, in row order) added in row order: on the
same features B is bitwise the fused fit's.  On an NVIDIA H100 80GB HBM3 at
700 W it takes 54.2-54.3 ms at N = 10^4, M = 14,641 (``Phi^T Phi``: 81
ms; with one-chain sums it took 50.4-50.5).  :func:`scaled_gram_plan` reports the launch.  Its plain version,
:func:`scaled_gram_plain`, is what a CPU tensor runs.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["scaled_gram_plain", "scaled_gram_cuda", "scaled_gram_plan", "COUNTER"]

COUNTER = _build.LaunchCounter("scaled_gram")
_PLAN_KEYS = ("tile", "rows_per_step", "stages", "steps", "blocks", "smem_bytes",
              "resident_blocks_per_sm", "strip_rows")


def scaled_gram_plain(Phi: torch.Tensor, d: torch.Tensor, sig2) -> torch.Tensor:
    """Plain version: I + D (Phi^T Phi) D / sig2 in float32, exactly
    symmetric like the kernel's (the upper triangle of the product,
    mirrored, scaled by d_i d_j / sig2)."""
    Phi = Phi.to(torch.float32)
    G = Phi.T @ Phi
    G = torch.triu(G) + torch.triu(G, 1).T
    return G * (d[:, None] * d[None, :] / float(sig2)) \
        + torch.eye(G.shape[0], dtype=torch.float32, device=G.device)


def scaled_gram_plan(N: int, M: int, bf16: bool = False, device=None) -> dict:
    """The kernel's launch for Phi (N, M), float32 or bfloat16: tile edge,
    rows per step, ring stages, steps, blocks, shared bytes per block, the
    resident blocks per SM the card gives it and the rows a strip sums
    before it joins the running total."""
    lib = _build.library("scaled_gram")
    fn = lib.repro_scaled_gram_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong)]
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    with torch.cuda.device(torch.device("cuda" if device is None else device)):
        _build.check_launch(fn(N, M, int(bool(bf16)), out), "scaled_gram (plan)")
    return dict(zip(_PLAN_KEYS, out))


def scaled_gram_cuda(Phi: torch.Tensor, d: torch.Tensor, sig2: float) -> torch.Tensor:
    """Launch ``csrc/scaled_gram.cu`` on Phi's card and stream -> B (M, M)
    float32."""
    N, M = Phi.shape
    out = torch.empty((M, M), dtype=torch.float32, device=Phi.device)
    if M == 0:
        return out
    bf16 = Phi.dtype == torch.bfloat16
    lib = _build.library("scaled_gram")
    fn = lib.repro_scaled_gram_bf16 if bf16 else lib.repro_scaled_gram_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    with _build.on_device(Phi):
        stream = torch.cuda.current_stream(Phi.device).cuda_stream
        rc = fn(_build.ptr(Phi), N, M, _build.ptr(d), float(sig2), _build.ptr(out),
                ctypes.c_void_p(stream))
    _build.check_launch(rc, "scaled_gram")
    COUNTER.add("bf16" if bf16 else "")
    return out
