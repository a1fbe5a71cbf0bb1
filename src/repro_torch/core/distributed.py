"""Row-sharded FAGP fit and serving over a device mesh.

Counterpart of ``repro/core/distributed.py``.  When one device is not
enough for the rows, the fit becomes:

  * X, y split by rows over every mesh axis: each shard owns N / S rows
    (N padded to a multiple of S, the pad rows masked);
  * each shard's raw moments G = Phi^T Phi (M x M) and b = Phi^T y from the
    spec's backend on its own device: on ``pallas`` one launch of the
    streaming fused fit (Phi never written), on ``jnp`` a block scan of
    ~100 MB blocks of Phi;
  * the S partial (G, b) summed in shard order on the first device, the
    counterpart of the JAX schedule's one ``psum``: O(M^2) data moved,
    independent of N, and the same order on the CPU and on a card;
  * then the scaled system, its Cholesky factor and the mean weights
    exactly as the resident fit forms them.

Serving splits the query rows over the mesh; each shard answers its rows
through the backend's own ``predict_mean_var`` route on its device (on
``pallas`` the features kernel and diag-quad, with B^{-1} formed once and
copied to each other device).  No collective after that.

The JAX package runs this as one ``shard_map`` program; the port keeps its
single controller: the host thread places each shard's rows on its mesh
device and launches there, shard after shard (distinct cards run their
queues at once).  A mesh may repeat a device
(``launch.mesh.make_local_mesh(devices=...)``).

    state = fit_distributed(X, y, spec, mesh)       # a normal FAGPState
    mu, var = predict_distributed(Xs, state, mesh)  # spec baked in

The returned state is a resident fit's equal: it feeds ``predict_mean_var``,
``fit_update`` and the ``GP`` facade.  The split
``fit_distributed(X, y, params, cfg, mesh)`` form was removed and raises
``TypeError``; ``lower_fit`` / ``lower_predict`` lower to XLA HLO for the
JAX dry run and have no meaning here (the LM half's dry run and roofline,
ROADMAP A8).
"""
from __future__ import annotations

import numpy as np
import torch

from .expansions import get_expansion
from .fagp import (
    FAGPState,
    GPSpec,
    _assemble_scaled_system,
    _binv,
    _check_backend_support,
    _check_p,
    _finish_fit,
    _idx_tensor,
    _removed,
)
from .gp import _not_ported
from .shardspec import mesh_size, spec_local

__all__ = ["fit_distributed", "predict_distributed", "lower_fit", "lower_predict"]


def _pick_nblk(N: int, M: int, dp: int = 1) -> tuple:
    """(nblk, N_padded): row blocks of ~100 MB of float32 Phi per device,
    N padded so that blocks exist and every block divides over the dp
    devices."""
    target_rows = max(dp, int(100e6 / 4 / max(M, 1)) * dp)
    nblk = min(max(1, N // target_rows), 256)
    quantum = nblk * dp
    return nblk, (N + quantum - 1) // quantum * quantum


def _devices(mesh) -> list:
    """The mesh's devices in shard order (row-major over its axes, as the
    JAX schedule numbers its shards)."""
    return list(mesh.devices.reshape(-1))


def _rows(a) -> torch.Tensor:
    """Input rows as float32 where they are (a CPU tensor for host arrays):
    each shard copies its own rows to its device."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32)
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _pad(a: torch.Tensor, n: int) -> torch.Tensor:
    if a.shape[0] == n:
        return a
    pad = torch.zeros((n - a.shape[0],) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
    return torch.cat([a, pad])


def _fit_distributed_spec(X, y, spec: GPSpec, mesh) -> FAGPState:
    X, y = _rows(X), _rows(y)
    N, p = X.shape
    _check_p(spec, p)
    backend = _check_backend_support(spec)
    devices = _devices(mesh)
    S = mesh_size(mesh)
    idx = _idx_tensor(spec, p)
    M = idx.shape[0]
    if spec.backend == "jnp":
        nblk, N_pad = _pick_nblk(N, M, S)
        block = N_pad // S // nblk
    else:
        N_pad = -(-N // S) * S
        block = max(1, N_pad // S // 16)
    N_l = N_pad // S
    X, y = _pad(X, N_pad), _pad(y, N_pad)
    parts = []
    for s, dev in enumerate(devices):
        lo = s * N_l
        mask = None
        if N_pad != N:
            mask = ((lo + torch.arange(N_l, device=dev)) < N).to(torch.float32)
        parts.append(backend.moments(X[lo:lo + N_l].to(dev), y[lo:lo + N_l].to(dev),
                                     spec_local(spec, dev), idx.to(dev), block, mask))
    G, b = parts[0]
    for G_s, b_s in parts[1:]:
        G += G_s.to(G.device)
        b += b_s.to(b.device)
    del parts
    spec0 = spec_local(spec, devices[0])
    idx0 = idx.to(devices[0])
    loglam = get_expansion(spec0.expansion).log_eigenvalues(idx0, spec0)
    sig2 = spec0.noise**2
    B, sqrtlam = _assemble_scaled_system(G, loglam, sig2)
    del G
    return _finish_fit(B, b, loglam, sqrtlam, sig2, idx0, spec0)


def fit_distributed(X, y, spec, *args) -> FAGPState:
    """Row-sharded fit returning a self-describing :class:`FAGPState` on the
    mesh's first device (Phi and y not stored: they are sharded training
    data, not serving state).

    ``fit_distributed(X, y, spec, mesh)``; ``spec.backend`` selects each
    shard's moments ('pallas': one fused-fit launch per shard, for any
    registered expansion).  The split ``fit_distributed(X, y, params, cfg,
    mesh)`` form was removed."""
    if not isinstance(spec, GPSpec):
        _removed(
            "fit_distributed(X, y, params, cfg, mesh)",
            "merge them with GPSpec.from_parts(params, cfg) and call "
            "fit_distributed(X, y, spec, mesh), which returns an FAGPState",
        )
    if len(args) != 1:
        raise TypeError("fit_distributed(X, y, spec, mesh): expected mesh")
    return _fit_distributed_spec(X, y, spec, args[0])


def _state_on(state: FAGPState, dev: torch.device) -> FAGPState:
    """``state`` on ``dev``, copied once and kept in the state's serving
    cache; on the ``pallas`` backend with the B^{-1} formed once on the
    state's own device, copied."""
    if state.spec.device == dev:
        return state
    cache = state.serving.setdefault("devices", {})
    st = cache.get(dev)
    if st is None:
        leaves = {f: getattr(state, f).to(dev)
                  for f in ("idx", "lam", "sqrtlam", "chol", "u", "b")}
        st = FAGPState(spec=spec_local(state.spec, dev), **leaves)
        if state.spec.backend != "jnp":
            st.serving["binv"] = _binv(state).to(dev)
        cache[dev] = st
    return st


def predict_distributed(Xs, state, *args):
    """Posterior mean and marginal variance with the query rows split over
    the mesh, each shard served on its device; results on the first
    device.

    ``predict_distributed(Xs, state, mesh)`` with the self-describing state
    of :func:`fit_distributed` (or a single-device ``fit``).  The
    ``predict_distributed(Xs, (u, chol, sqrtlam), params, cfg, mesh)`` form
    was removed."""
    if len(args) != 1:
        _removed(
            "predict_distributed(Xs, state_tuple, params, cfg, mesh)",
            "fit with fit_distributed(X, y, spec, mesh) and call "
            "predict_distributed(Xs, state, mesh)",
        )
    mesh = args[0]
    if not isinstance(state, FAGPState) or state.spec is None:
        raise ValueError(
            "predict_distributed(Xs, state, mesh) needs a self-describing "
            "FAGPState (from fit_distributed or fit)"
        )
    backend = _check_backend_support(state.spec)
    Xs = _rows(Xs)
    N = Xs.shape[0]
    _check_p(state.spec, Xs.shape[1])
    devices = _devices(mesh)
    S = mesh_size(mesh)
    N_pad = -(-N // S) * S
    N_l = N_pad // S
    Xs = _pad(Xs, N_pad)
    out = [backend.mean_var(_state_on(state, dev), Xs[s * N_l:(s + 1) * N_l].to(dev))
           for s, dev in enumerate(devices)]
    home = devices[0]
    mu = torch.cat([m.to(home) for m, _ in out])[:N]
    var = torch.cat([v.to(home) for _, v in out])[:N]
    return mu, var


def lower_fit(wl, mesh, *, schedule: str = "v2"):
    """Lowers the JAX fit to XLA HLO for the dry run: no PyTorch meaning."""
    _not_ported("lower_fit", "LM half's dry run and roofline (ROADMAP A8)")


def lower_predict(wl, mesh, *, schedule: str = "v2"):
    """Lowers the JAX serving to XLA HLO for the dry run: no PyTorch meaning."""
    _not_ported("lower_predict", "LM half's dry run and roofline (ROADMAP A8)")
