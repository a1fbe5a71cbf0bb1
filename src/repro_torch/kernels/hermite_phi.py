"""Expansion features Phi(X) (N, M): the plain tile builders and the CUDA
kernel that replaces the TPU kernel
``repro/kernels/hermite_phi.py::hermite_phi_kernel``.

A kernel of this package receives an expansion's feature map as a
:class:`TileArgs`: the Hermite-Mercer map as its (p, 3) constants, the
(2, n) recurrence coefficients and the (M, p) int32 multi-index table; the
random-Fourier map as its (p + 1, M) [W; phase] table.  The TPU kernel took
a one-hot (p*n, M) selection matrix and gathered with its matrix unit; on
the H100 the gather is a shared-memory read through the index table.

CUDA kernel: ``csrc/phi_features.cu``.  Bound on the H100: the (N, M)
float32 write (586 MB at N = 10^4, M = 14,641; 7.5 MB for a 128-row
serving microbatch, where the launch costs more).  Each thread owns 1 or
8 columns (an instance each), their index entries (or [W; phase] entries)
held in registers, and a block walks a strip of 32-row tiles,
building the next tile's row table in a second shared buffer while it
stores the current one; :func:`phi_features_plan` reports the launch.  On
an NVIDIA H100 80GB HBM3 at 700 W it takes 0.270 ms at 10^4 x 14,641 and
4.9 us for a 128-row microbatch (``benchmarks/torch_phi_gram_ablation.py``).

The C entry points' signatures (:data:`ARGTYPES`) are bound once, on first
use, and the handles held here, so a launch takes no Python lock and sets
no ``argtypes`` (the C plan reads its per-device residency cache under a
mutex); the stream is read raw, without building a ``Stream``.
:func:`phi_features_launch` writes into a given tensor, which it checks,
so a CUDA graph can capture it.  Its plain version,
:func:`phi_features_plain`, is what a CPU tensor runs.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ..core.mercer import hermite_psi_rows
from . import _build
from .rff_phi import rff_tile

__all__ = ["TileArgs", "phi_tile", "plain_tile", "phi_features_plain",
           "phi_features_cuda", "phi_features_launch", "phi_features_plan",
           "COUNTER"]

COUNTER = _build.LaunchCounter("phi_features")
KINDS = {"hermite": 0, "rff": 1}
_V, _I = ctypes.c_void_p, ctypes.c_int
# the C signatures of csrc/phi_features.cu's entry points
ARGTYPES = {
    "repro_phi_features": [_V, _I, _I, _I, _I, _I, _V, _V, _V, _V, _V, _V],
    "repro_phi_features_plan": [_I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_longlong)],
}
_PLAN_KEYS = ("threads", "rows_per_tile", "cols_per_thread", "col_blocks",
              "row_strips", "tiles_per_block", "blocks", "smem_bytes",
              "resident_blocks_per_sm")
_ENTRIES: dict = {}


@dataclasses.dataclass(frozen=True)
class TileArgs:
    """An expansion's feature map in the form the kernels take.

    kind:   "hermite" or "rff".
    n_max:  Hermite recurrence depth (1 for RFF).
    M:      number of features.
    consts: (p, 3) float32 [beta, delta2, rho*beta] (Hermite).
    coef:   (2, n_max) float32 recurrence coefficients (Hermite).
    idx:    (M, p) int32 multi-indices (Hermite).
    table:  (p + 1, M) float32 [W; phase] (RFF).
    """

    kind: str
    n_max: int
    M: int
    consts: Optional[torch.Tensor] = None
    coef: Optional[torch.Tensor] = None
    idx: Optional[torch.Tensor] = None
    table: Optional[torch.Tensor] = None

    def tensors(self) -> list:
        return [t for t in (self.consts, self.coef, self.idx, self.table)
                if t is not None]


def phi_tile(x: torch.Tensor, consts: torch.Tensor, idx: torch.Tensor,
             n_max: int) -> torch.Tensor:
    """(TN, p) rows -> (TN, M) Hermite-Mercer features: per dimension the
    scaled recurrence (``core/mercer.py::hermite_psi_rows``, its one home)
    times exp(-delta2 x^2), gathered through the index table and multiplied
    across dimensions in order j = 0..p-1."""
    idx = idx.to(torch.long)
    out = None
    for j in range(x.shape[1]):
        beta, delta2, zscale = consts[j, 0], consts[j, 1], consts[j, 2]
        xj = x[:, j]
        env = torch.exp(-delta2 * xj * xj)
        feats = torch.stack(hermite_psi_rows(zscale * xj, beta, n_max), dim=1)
        sel = (feats * env[:, None])[:, idx[:, j]]
        out = sel if out is None else out * sel
    return out


def plain_tile(x: torch.Tensor, tile: TileArgs) -> torch.Tensor:
    """The plain feature map of ``tile`` on rows ``x``."""
    if tile.kind == "hermite":
        return phi_tile(x, tile.consts, tile.idx, tile.n_max)
    return rff_tile(x, tile.table)


def phi_features_plain(X: torch.Tensor, tile: TileArgs) -> torch.Tensor:
    """Plain version of the features kernel: (N, p) -> (N, M)."""
    return plain_tile(X, tile)


def _entry(name: str):
    """The C entry point ``name`` of ``libphi_features``, its signature bound
    on first use and the handle held."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(_build.library("phi_features"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = ARGTYPES[name]
        _ENTRIES[name] = fn
    return fn


def _current_stream(device_index: int) -> int:
    """The raw handle of the device's current stream, as PyTorch's own
    generated kernels fetch it: a few microseconds less a call than
    ``torch.cuda.current_stream(device).cuda_stream``, which builds a
    ``Stream`` object first."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def _addr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def phi_features_plan(N: int, M: int, kind: str = "hermite", p: int = 1,
                      n: int = 1, device=None) -> dict:
    """The kernel's launch for N rows of M features of a ``kind`` tile with
    p inputs and recurrence depth n: threads a block, rows a tile, columns a
    thread, column blocks, row strips, tiles a block, blocks, shared bytes a
    block and the resident blocks per SM the card gives it."""
    dev = torch.device("cuda" if device is None else device)
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    with torch.cuda.device(dev):
        rc = _entry("repro_phi_features_plan")(N, p, M, KINDS[kind], n, out)
    _build.check_launch(rc, "phi_features (plan)")
    return dict(zip(_PLAN_KEYS, out))


def phi_features_launch(X: torch.Tensor, tile: TileArgs, out: torch.Tensor) -> None:
    """Launch ``csrc/phi_features.cu`` on the current stream of X's device,
    writing Phi(X) (N, M) into ``out``, a contiguous float32 tensor on X's
    device; allocates nothing.  Checks its inputs as ``ops.expansion_phi``
    does, and ``out``."""
    from .ops import _check_tile, _on_cuda  # ops imports this module

    N, p = X.shape
    _check_tile("phi_features_launch", tile, p)
    if not _on_cuda("phi_features_launch", X, out, *tile.tensors()):
        raise ValueError("phi_features_launch: the tensors are on the CPU, where "
                         "phi_features_plain runs")
    if tuple(out.shape) != (N, tile.M) or out.dtype != torch.float32 \
            or X.dtype != torch.float32:
        raise ValueError(f"phi_features_launch: X {X.dtype}, out {tuple(out.shape)} "
                         f"{out.dtype}; the launch takes float32 X and writes a "
                         f"({N}, {tile.M}) float32 out")
    _launch(X, tile, out)


def _launch(X: torch.Tensor, tile: TileArgs, out: torch.Tensor) -> None:
    N, p = X.shape
    rc = _entry("repro_phi_features")(
        X.data_ptr(), N, p, tile.M, KINDS[tile.kind], tile.n_max, _addr(tile.consts),
        _addr(tile.coef), _addr(tile.idx), _addr(tile.table), out.data_ptr(),
        _current_stream(X.get_device()))
    _build.check_launch(rc, "phi_features")
    COUNTER.add()


def phi_features_cuda(X: torch.Tensor, tile: TileArgs) -> torch.Tensor:
    """Launch ``csrc/phi_features.cu`` on X's stream: (N, p) -> (N, M)."""
    out = torch.empty((X.shape[0], tile.M), dtype=torch.float32, device=X.device)
    if out.numel():
        _launch(X, tile, out)
    return out
