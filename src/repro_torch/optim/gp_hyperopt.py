"""Batched GP hyperparameter optimization: the lane engine.

Counterpart of ``repro/optim/gp_hyperopt.py``.  It minimizes the log-space
NLML per data row of every tenant and every random restart: a *lane*
(t, r) is restart r of tenant t, its parameters the leaves
``{log_eps, log_rho, log_noise}`` (positive by construction; the RFF
spectral draws ``omega`` stay fixed: they are structure, not
hyperparameters), stepped by ``repro_torch.optim.adamw``.

Anatomy of a step (``_lane_step``):

* every lane runs the same per-lane program, a plain loop: the masked NLML
  of ``core.fagp`` (``fagp._nlml_core``: its value from the spec's
  backend, on the card the fused-fit kernel, one launch a lane; its
  gradient from the streamed backward pass of ``fagp._MomentsDiff``, never
  an N x M buffer), then the lane's own gradient-norm clip.  So a lane's
  arithmetic is the same in a fleet of any size as in a run of one tenant,
  and a fleet equals a loop of single runs bitwise, by construction (the
  JAX package pads one tenant to a scan of two for the same end, an XLA
  trait this port has no need of);
* AdamW then steps the (B, R) stack elementwise;
* **convergence masks**: a lane whose NLML improved by less than ``tol``
  freezes; its parameters and its optimizer moments are carried through
  unchanged, bitwise;
* per-tenant row masks express ragged N on one (B, N, p) stack.

Restart jitter: restart 0 is always the unperturbed init; restarts
1..R-1 add N(0, jitter^2) log-space noise drawn by numpy from a generator
keyed by (seed, field) only, so every tenant sees the same R draws and a
single-tenant run with the same seed lands on the same lanes.  These draws
are the port's own: ``jax.random`` cannot be reproduced without JAX, so
with ``restarts > 1`` the port starts its restarts elsewhere than the JAX
package does for the same seed (restart 0 is the same in both).

``optimize_fleet`` drives the loop and selects the best restart per tenant
by final NLML; ``optimize_restarts`` is the single-model wrapper that
``GP.optimize`` delegates to.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core import fagp
from ..obs.watchdog import shape_tracked
from . import adamw

__all__ = ["HyperoptResult", "optimize_fleet", "optimize_restarts"]

_FIELDS = ("log_eps", "log_rho", "log_noise")
_LANE_CLIP = 10.0


@dataclasses.dataclass(frozen=True)
class HyperoptResult:
    """Per-tenant winners plus the full lane picture.

    eps/rho (B, p) and noise (B,) are the best restart's hyperparameters in
    natural space; ``nlml`` (B,) is that lane's final NLML per data row
    (the selection criterion); ``lane_nlml`` (B, R) keeps every restart's
    final value; ``frozen`` (B, R) marks lanes the convergence mask froze
    before the step budget ran out.
    """

    eps: torch.Tensor            # (B, p)
    rho: torch.Tensor            # (B, p)
    noise: torch.Tensor          # (B,)
    nlml: torch.Tensor           # (B,)   best lane's final NLML / row
    lane_nlml: torch.Tensor      # (B, R) every lane's final NLML / row
    best_restart: torch.Tensor   # (B,)
    frozen: np.ndarray           # (B, R)
    steps_run: int

    def spec_for(self, spec, t: int = 0):
        """The input spec with tenant ``t``'s learned hyperparameters."""
        return spec.replace(eps=self.eps[t], rho=self.rho[t], noise=self.noise[t])


def _hp_to_spec(spec, hp):
    return spec.replace(
        eps=torch.exp(hp["log_eps"]),
        rho=torch.exp(hp["log_rho"]),
        noise=torch.exp(hp["log_noise"]),
    )


def _init_lanes(spec, B: int, R: int, seed: int, jitter: float,
                init: Optional[dict]):
    """(B, R)-lane log-space parameter stack.  ``init`` optionally supplies
    per-tenant natural-space starting points {eps (B, p), rho (B, p),
    noise (B,)}; otherwise every tenant starts from the spec.  Restart 0
    is the unperturbed init; restarts 1..R-1 add the jitter of the module
    docstring, keyed by (seed, field) only."""
    dev = spec.device
    if init is None:
        base = {
            "log_eps": torch.log(spec.eps).expand((B,) + tuple(spec.eps.shape)),
            "log_rho": torch.log(spec.rho).expand((B,) + tuple(spec.rho.shape)),
            "log_noise": torch.log(spec.noise).expand((B,)),
        }
    else:
        base = {
            "log_eps": torch.log(fagp._f32(init["eps"], dev)),
            "log_rho": torch.log(fagp._f32(init["rho"], dev)),
            "log_noise": torch.log(fagp._f32(init["noise"], dev)),
        }
        for f, nd in (("log_eps", 2), ("log_rho", 2), ("log_noise", 1)):
            if base[f].ndim != nd or base[f].shape[0] != B:
                raise ValueError(
                    f"init[{f[4:]!r}] must have leading dim B={B} and "
                    f"ndim {nd}, got {tuple(base[f].shape)}"
                )
    out = {}
    for k, f in enumerate(_FIELDS):
        leaf = base[f].to(torch.float32)
        tail = tuple(leaf.shape[1:])
        tiled = leaf[:, None].expand((B, R) + tail).clone()
        if R > 1 and jitter:
            draw = np.random.default_rng([seed, k]).standard_normal((R,) + tail)
            draw = draw.astype(np.float32) * np.float32(jitter)
            draw[0] = 0.0
            tiled = tiled + torch.from_numpy(draw).to(dev)[None]
        out[f] = tiled
    return out


def _where_lanes(cond, a, b):
    """Select a/b per lane: cond (B, R) broadcast over trailing axes."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - 2)), a, b)


def _clip_per_lane(grads: dict, clip: float) -> dict:
    """One lane's gradients scaled by min(1, clip / norm).  AdamW's own
    clip takes the global norm of the whole stack, which would couple
    every tenant and restart through one shared scale; each lane's own
    norm keeps lanes independent."""
    sq = sum(torch.sum(torch.square(g.to(torch.float32))) for g in grads.values())
    scale = torch.clamp(clip / (torch.sqrt(sq) + 1e-9), max=1.0)
    return {f: g * scale for f, g in grads.items()}


def _lane_loss(hp, X, y, mask, spec):
    """One lane's objective: the masked NLML per data row at exp(hp)."""
    return fagp._nlml_core(X, y, _hp_to_spec(spec, hp), mask) \
        / torch.clamp(torch.sum(mask), min=1.0)


def _lane(hp, t: int, r: int) -> dict:
    return {f: hp[f][t, r].clone() for f in _FIELDS}


@shape_tracked
def _lane_step(hp, ostate, frozen, prev, data, spec, tol: float, ocfg):
    """One AdamW step over every (tenant, restart) lane; ``data`` holds
    each tenant's (X, y, mask).

    Returns (hp, ostate, frozen, prev, vals) where ``vals`` (B, R) is the
    loss at the INPUT parameters.  A lane freezes when its improvement
    since the previous step falls below ``tol``; frozen lanes carry their
    parameters and optimizer moments through unchanged (bitwise)."""
    B, R = frozen.shape
    vals = torch.empty((B, R), dtype=hp["log_noise"].dtype, device=frozen.device)
    grads = {f: torch.empty_like(hp[f]) for f in _FIELDS}
    for t, (X, y, mask) in enumerate(data):
        for r in range(R):
            lane = {f: v.requires_grad_() for f, v in _lane(hp, t, r).items()}
            val = _lane_loss(lane, X, y, mask, spec)
            g = torch.autograd.grad(val, [lane[f] for f in _FIELDS])
            g = _clip_per_lane(dict(zip(_FIELDS, g)), _LANE_CLIP)
            vals[t, r] = val.detach()
            for f in _FIELDS:
                grads[f][t, r] = g[f]
    frozen = frozen | (prev - vals < tol)
    new_hp, new_ostate, _ = adamw.apply_updates(hp, grads, ostate, ocfg)
    hp = {f: _where_lanes(frozen, hp[f], new_hp[f]) for f in _FIELDS}
    mu = {
        f: {k: _where_lanes(frozen, ostate["mu"][f][k], new_ostate["mu"][f][k])
            for k in ("m", "v")}
        for f in _FIELDS
    }
    ostate = {"mu": mu, "step": new_ostate["step"]}
    prev = torch.where(frozen, prev, vals)
    return hp, ostate, frozen, prev, vals


@shape_tracked
@torch.no_grad()
def _lane_values(hp, data, spec):
    """Final per-lane NLML/row at the CURRENT parameters (the best-restart
    selection criterion: ``_lane_step``'s vals lag one update behind)."""
    B, R = hp["log_noise"].shape
    vals = torch.empty((B, R), dtype=hp["log_noise"].dtype, device=hp["log_noise"].device)
    for t, (X, y, mask) in enumerate(data):
        for r in range(R):
            vals[t, r] = _lane_loss(_lane(hp, t, r), X, y, mask, spec)
    return vals


def _run_lanes(hp, Xb, yb, mask, spec, *, steps: int, lr: float,
               tol: Optional[float], callback: Optional[Callable]) -> HyperoptResult:
    """The optimization loop from the initial lane stack ``hp`` (see
    ``_init_lanes``) to the selected winners; ``spec.block_rows`` is the
    backward pass's row block."""
    B, R = hp["log_noise"].shape
    hp = {f: fagp._f32(hp[f], spec.device) for f in _FIELDS}
    # each tenant's rows in their own buffers: a tenant's arithmetic never
    # depends on where in the stack its rows sat
    data = [(Xb[t].clone(), yb[t].clone(), mask[t].clone()) for t in range(B)]
    # clip_norm=None: each lane clips by its own norm inside _lane_step
    ocfg = adamw.AdamWConfig(lr=lr, weight_decay=0.0, clip_norm=None)
    ostate = adamw.init(hp, ocfg)
    frozen = torch.zeros((B, R), dtype=torch.bool, device=spec.device)
    prev = torch.full((B, R), float("inf"), dtype=torch.float32, device=spec.device)
    tol_f = float(np.float32(-np.inf if tol is None else tol))

    every = max(1, steps // 10)
    steps_run = steps
    for step in range(steps):
        hp, ostate, frozen, prev, vals = _lane_step(
            hp, ostate, frozen, prev, data, spec, tol_f, ocfg)
        if callback is not None and (step % every == 0 or step == steps - 1):
            callback(step, vals.cpu().numpy(), hp)
        if tol is not None and bool(frozen.all()):
            steps_run = step + 1
            break

    final = _lane_values(hp, data, spec)                   # (B, R)
    best = torch.argmin(final, dim=1)                      # (B,)
    rows = torch.arange(B, device=best.device)
    pick = lambda f: hp[f][rows, best]                     # noqa: E731
    return HyperoptResult(
        eps=torch.exp(pick("log_eps")),
        rho=torch.exp(pick("log_rho")),
        noise=torch.exp(pick("log_noise")),
        nlml=final[rows, best],
        lane_nlml=final,
        best_restart=best,
        frozen=frozen.cpu().numpy(),
        steps_run=steps_run,
    )


def _compose_obs_callback(user_cb, metrics, tracer):
    """Wrap the optimize_fleet progress-callback contract with telemetry:
    the observer fires first (round counter, step and best-NLML gauges, a
    ``hyperopt_progress`` instant event), then the user's callback, with
    exactly the ``(step, vals, hp)`` arguments the contract specifies."""
    counter = gauge_step = gauge_best = None
    if metrics is not None:
        counter = metrics.counter(
            "hyperopt_rounds_total", "progress-callback firings")
        gauge_step = metrics.gauge(
            "hyperopt_step", "current optimizer step")
        gauge_best = metrics.gauge(
            "hyperopt_best_nlml", "best lane NLML/row at the last firing")

    def cb(step, vals, hp):
        if counter is not None:
            counter.inc()
            gauge_step.set(step)
            gauge_best.set(float(np.min(vals)))
        if tracer is not None:
            tracer.instant("hyperopt_progress", step=int(step),
                           best_nlml=float(np.min(vals)))
        if user_cb is not None:
            user_cb(step, vals, hp)

    return cb


def optimize_fleet(
    Xb,
    yb,
    spec,
    *,
    mask=None,
    restarts: int = 4,
    steps: int = 100,
    lr: float = 5e-2,
    tol: Optional[float] = None,
    jitter: float = 0.3,
    seed: int = 0,
    init: Optional[dict] = None,
    callback: Optional[Callable] = None,
    metrics=None,
    tracer=None,
) -> HyperoptResult:
    """NLML hyperparameter learning for B independent tenants with R
    random restarts each, on the spec's device.

    Xb (B, N, p), yb (B, N) (or (B, N, T) multi-output), mask (B, N) row
    validity for ragged per-tenant N.  ``tol`` (None = never) freezes lanes
    whose per-step NLML improvement drops below it; the loop exits early
    once every lane froze.  ``callback(step, vals, hp)`` fires every ~10%
    with the (B, R) loss snapshot (numpy) and the log-space lane
    parameters.

    ``metrics`` / ``tracer`` (``repro_torch.obs``) report per-round
    progress THROUGH that same callback contract: an observer composed in
    front of any user callback records a round counter, the current step
    and the best lane NLML as gauges, and a ``hyperopt_progress`` instant
    trace event per firing.  It reads the ``vals`` snapshot the callback
    already receives, so the loop pays no extra device read.

    Returns a :class:`HyperoptResult` with the best restart per tenant
    selected by final NLML.
    """
    if metrics is not None or tracer is not None:
        callback = _compose_obs_callback(callback, metrics, tracer)
    Xb, yb = fagp._f32(Xb, spec.device), fagp._f32(yb, spec.device)
    if Xb.ndim != 3 or yb.ndim not in (2, 3) or yb.shape[:2] != Xb.shape[:2]:
        raise ValueError(
            f"optimize_fleet wants Xb (B, N, p) and yb (B, N[, T]); got "
            f"{tuple(Xb.shape)} and {tuple(yb.shape)}"
        )
    B, N, p = Xb.shape
    if restarts < 1 or steps < 1:
        raise ValueError("restarts and steps must be >= 1")
    fagp._check_p(spec, p)
    fagp._check_backend_support(spec)
    if mask is None:
        mask = torch.ones((B, N), dtype=torch.float32, device=spec.device)
    else:
        mask = fagp._f32(mask, spec.device)
        if tuple(mask.shape) != (B, N):
            raise ValueError(f"mask must be (B, N) = {(B, N)}, got {tuple(mask.shape)}")
    # small tenants: a block never spans more than a tenant's rows
    spec = spec.replace(block_rows=min(spec.block_rows, max(1, N)))
    hp = _init_lanes(spec, B, restarts, seed, jitter, init)
    return _run_lanes(hp, Xb, yb, mask, spec, steps=steps, lr=lr, tol=tol,
                      callback=callback)


def optimize_restarts(
    X,
    y,
    spec,
    *,
    restarts: int = 1,
    steps: int = 100,
    lr: float = 5e-2,
    tol: Optional[float] = None,
    jitter: float = 0.3,
    seed: int = 0,
    callback: Optional[Callable] = None,
) -> HyperoptResult:
    """Single-model wrapper over :func:`optimize_fleet` (a B = 1 fleet):
    multi-start gradient NLML learning for one dataset.  ``GP.optimize``
    delegates here; the result keeps its leading B = 1 axis
    (``result.spec_for(spec)`` extracts the winner)."""
    X, y = fagp._f32(X, spec.device), fagp._f32(y, spec.device)
    if X.ndim != 2:
        raise ValueError(f"optimize_restarts wants X (N, p), got {tuple(X.shape)}")
    return optimize_fleet(
        X[None], y[None], spec, restarts=restarts, steps=steps, lr=lr,
        tol=tol, jitter=jitter, seed=seed, callback=callback,
    )
