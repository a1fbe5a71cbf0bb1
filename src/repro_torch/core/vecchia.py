"""Vecchia nearest-neighbour conditioning: the sibling approximation.

Counterpart of ``repro/core/vecchia.py``.  Where FAGP replaces the N x N
kernel inverse by a global low-rank feature system, the Vecchia
approximation is local: the joint density is factorized along the data
ordering and each conditional is cut to the k nearest preceding rows,

    p(y) ~= prod_i p(y_i | y_{c(i)}),   c(i) = k nearest rows among j < i,

and a prediction conditions each query on its k nearest training rows.
Every solve is a k x k Cholesky, batched over rows as B x k x k lanes, so
the cost is O(N k^3) with no N x N (or Q x N) intermediate: the
conditioning sets come from the streamed top-k of ``kernels/knn.py``.

    spec = GPSpec.create_vecchia([4.7, 4.7], 0.02, kernel="se", neighbors=32)
    gp = GP.fit(X, y, spec)          # the state is the data (X, y)
    mu, var = gp.mean_var(Xs)
    gp = gp.update(X_new, y_new)     # exact: a concatenation
    loss = gp.nlml(X, y)             # the ordered factorization's NLML

The kernel oracles are ``exact_gp.KERNELS``, so at full conditioning sets
prediction and the ordered NLML equal ``exact_gp``'s.  Capabilities: fit,
mean_var, update and nlml.  Refused with the structured
``UnsupportedError``, as in the JAX package: ``predict`` (the full Q x Q
covariance needs a joint conditioning set), ``optimize``, bank admission
and ``nlml(mask=)``.

The lanes.  The JAX package maps over blocks of ``_block_q(k)`` rows one
at a time.  Here a pass takes as many rows as fit in ``_LANE_WORDS``
floats of k x k lanes (whole blocks of ``_block_q(k)`` rows), so that the
Python loop stays short and the card is not left idle between launches:
at k = 32 one pass holds 4,096 rows.  A pass holds at most 3p + 12
four-byte words a lane element (the kernel's differences, the k x k
matrices) and 4 (p + T) a neighbour (the gathered rows and their
solves); ``chip_smoke.py`` holds the card's peak bytes to that bound.
``torch.linalg.cholesky_ex`` does
not synchronize with the host; a lane whose factorization failed gives
NaN, as the JAX package's Cholesky does, so ``mean_var`` and ``nlml`` make
no host-device barrier of their own.

Layering: ``fagp`` imports this module at its bottom to register the
family, so this module imports ``fagp`` only inside functions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..kernels import knn
from .approximation import Approximation, UnsupportedError, register_approximation
from .exact_gp import KERNELS

__all__ = ["VecchiaApproximation", "VecchiaState", "lane_rows"]

_BLOCK_Q = 128          # query rows per lane block (the JAX package's)
_LANE_WORDS = 1 << 22   # floats of k x k lanes one pass may hold


def _block_q(k: int) -> int:
    """Query-block size: bounded lane memory (block_q * k^2 floats)."""
    return int(max(1, min(_BLOCK_Q, (1 << 21) // max(1, k * k))))


def lane_rows(k: int) -> int:
    """Rows of k x k lanes taken together in one pass (whole blocks)."""
    bq = _block_q(k)
    return max(bq, (_LANE_WORDS // max(1, k * k)) // bq * bq)


@dataclasses.dataclass(frozen=True, eq=False)
class VecchiaState:
    """A fitted Vecchia session.  The "factorization" is the training data:
    conditioning sets and k x k solves are rebuilt per query batch, so
    ``update`` is an exact concatenation and the checkpoint leaves are
    (X, y)."""

    X: torch.Tensor                  # (N, p) training inputs
    y: torch.Tensor                  # (N,) or (N, T) training targets
    spec: Optional[Any] = None       # the GPSpec (approximation="vecchia")

    @property
    def n_train(self) -> int:
        return self.X.shape[0]

    @property
    def n_tasks(self) -> int:
        return 1 if self.y.ndim == 1 else self.y.shape[1]

    @property
    def n_features(self) -> int:
        raise UnsupportedError(
            "approximation 'vecchia' does not support 'n_features': the "
            "state is the raw data, not a feature-space factorization",
            layer="approximation", capability="n_features", spec=self.spec,
        )

    def with_spec(self, spec=None, **overrides) -> "VecchiaState":
        """As ``FAGPState.with_spec``: execution knobs (block_rows,
        backend) may change at serve time; structure (approximation,
        kernel, neighbors) and hyperparameters are frozen: refit instead."""
        from . import fagp

        if spec is None:
            spec = dataclasses.replace(self.spec, **overrides)
        elif overrides:
            raise TypeError("pass either a full spec or keyword overrides, not both")
        for f in fagp._STRUCTURAL_FIELDS:
            if getattr(spec, f) != getattr(self.spec, f):
                raise ValueError(
                    f"spec/state mismatch: state was fitted with "
                    f"{self.spec.describe()} but the new spec has "
                    f"{f}={getattr(spec, f)!r}; structural choices are "
                    f"frozen into the session — refit instead"
                )
        for f in fagp._HYPER_FIELDS:
            if not fagp._leaf_equal(getattr(spec, f), getattr(self.spec, f)):
                raise ValueError(
                    f"with_spec: spec/state mismatch: {f} differs from the "
                    f"value this state was fitted with; refit instead"
                )
        if spec.device != self.spec.device:
            raise ValueError(
                f"with_spec: the state lives on {self.spec.device}, the spec "
                f"on {spec.device}"
            )
        VECCHIA.validate(spec)
        return dataclasses.replace(self, spec=spec)


# ---------------------------------------------------------------------------
# Batched conditioning.  Each helper takes gathered neighbour blocks and
# runs B x k x k Cholesky lanes (one batched factorization per pass).
# ---------------------------------------------------------------------------


def _batched(kf):
    """kf (A, B, eps) lifted over a leading lane axis of A and B."""
    return torch.func.vmap(kf, in_dims=(0, 0, None))


def _lane_cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower factors of the lanes A (B, k, k); a lane whose factorization
    failed is NaN, as in the JAX package, with no host synchronization."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[:, None, None], L, float("nan"))


def _mean_var_lanes(X, y2, Xq, nb, eps, sig2, kf):
    """Posterior mean (B, T) and latent variance (B,) of the queries Xq
    (B, p) each conditioned on its neighbours nb (B, k).  Both reference
    kernels are unit-variance: k(x, x) = 1."""
    Xn, yn = X[nb], y2[nb]                                     # (B, k, p), (B, k, T)
    kb = _batched(kf)
    eye = torch.eye(nb.shape[1], dtype=X.dtype, device=X.device)
    L = _lane_cholesky(kb(Xn, Xn, eps) + sig2 * eye)
    ks = kb(Xq[:, None, :], Xn, eps)[:, 0, :]                  # (B, k)
    alpha = torch.cholesky_solve(yn, L)
    mu = torch.einsum("bk,bkt->bt", ks, alpha)
    w = torch.linalg.solve_triangular(L, ks[:, :, None], upper=False)[:, :, 0]
    return mu, torch.clamp(1.0 - torch.sum(w * w, dim=1), min=0.0)


def _nll_lanes(X, y2, yi, Xi, nb, m, eps, sig2, kf):
    """Sum over the rows Xi (B, p), yi (B, T) of -log N(y_i; mu_i, var_i),
    each conditioned on its (up to) k preceding neighbours nb with the mask
    m (B, k): masked slots are identity-filled, numerically inert."""
    Xc, yc = X[nb], y2[nb]
    kb = _batched(kf)
    T = y2.shape[1]
    eye = torch.eye(nb.shape[1], dtype=X.dtype, device=X.device)
    mm = m[:, :, None] * m[:, None, :]
    A = mm * (kb(Xc, Xc, eps) + sig2 * eye) + (1.0 - mm) * eye
    c = m * kb(Xi[:, None, :], Xc, eps)[:, 0, :]
    L = _lane_cholesky(A)
    alpha = torch.cholesky_solve(m[:, :, None] * yc, L)
    mu = torch.einsum("bk,bkt->bt", c, alpha)
    w = torch.linalg.solve_triangular(L, c[:, :, None], upper=False)[:, :, 0]
    var = 1.0 + sig2 - torch.sum(w * w, dim=1)
    resid = yi - mu
    nll = 0.5 * (T * torch.log(2.0 * math.pi * var) + torch.sum(resid * resid, dim=1) / var)
    return torch.sum(nll)


def _mean_var(X, y2, Xs, eps, noise, *, kernel: str, k: int, block_q: int, block_t: int):
    """Posterior mean (Q, T) and latent marginal variance (Q,): each query
    conditions on its k nearest training rows."""
    _, idx = knn.knn_search(Xs, X, k, block_q=block_q, block_t=block_t)
    step = lane_rows(k)
    out = [_mean_var_lanes(X, y2, Xs[lo:lo + step], idx[lo:lo + step], eps, noise**2,
                           KERNELS[kernel])
           for lo in range(0, Xs.shape[0], step)]
    return torch.cat([m for m, _ in out]), torch.cat([v for _, v in out])


def _nlml(X, y2, eps, noise, *, kernel: str, k: int, block_q: int, block_t: int):
    """Ordered-factorization NLML: sum_i -log N(y_i; mu_i, var_i) with
    (mu_i, var_i) the conditional of y_i given its (up to) k nearest
    preceding rows.  At k >= N - 1 the conditionals telescope to the exact
    joint, so this equals ``exact_gp.nlml``."""
    nbr, m = knn.ordered_topk(X, k, block_q=block_q, block_t=block_t)
    step = lane_rows(k)
    return sum(_nll_lanes(X, y2, y2[lo:lo + step], X[lo:lo + step], nbr[lo:lo + step],
                          m[lo:lo + step], eps, noise**2, KERNELS[kernel])
               for lo in range(0, X.shape[0], step))


# ---------------------------------------------------------------------------
# The registered family
# ---------------------------------------------------------------------------


def _as_2d(y: torch.Tensor) -> torch.Tensor:
    return y if y.ndim == 2 else y[:, None]


class VecchiaApproximation(Approximation):
    """``spec.approximation == "vecchia"``: nearest-neighbour conditioning
    with ``spec.kernel`` in {'se', 'matern52'} and ``spec.neighbors`` = k."""

    name = "vecchia"
    capabilities = frozenset({"fit", "mean_var", "update", "nlml"})
    state_type = VecchiaState

    def validate(self, spec) -> None:
        if spec.kernel not in KERNELS:
            raise ValueError(
                f"vecchia kernel must be one of {sorted(KERNELS)}, got "
                f"{spec.kernel!r}"
            )
        if spec.neighbors is None or int(spec.neighbors) < 1:
            raise ValueError(
                f"vecchia needs neighbors >= 1 (the conditioning-set size "
                f"k), got {spec.neighbors!r}"
            )
        if spec.omega is not None:
            raise ValueError(
                "vecchia takes no spectral draws (omega); it evaluates the "
                "exact kernel on k-neighbour sets"
            )

    @staticmethod
    def _blocks(spec, n_train: int) -> tuple:
        return _block_q(int(spec.neighbors)), max(1, min(int(spec.block_rows), n_train))

    def fit(self, X, y, spec) -> VecchiaState:
        from .fagp import _f32

        X, y = _f32(X, spec.device), _f32(y, spec.device)
        if X.ndim != 2:
            raise ValueError(f"X must be (N, p), got shape {tuple(X.shape)}")
        if spec.p != X.shape[1]:
            raise ValueError(
                f"spec/input mismatch: {spec.describe()} was built for "
                f"p={spec.p} input dimensions but the data has p={X.shape[1]}"
            )
        if y.shape[0] != X.shape[0]:
            raise ValueError(f"X has {X.shape[0]} rows but y has {y.shape[0]}")
        if int(spec.neighbors) > X.shape[0]:
            raise ValueError(
                f"vecchia neighbors={int(spec.neighbors)} exceeds the "
                f"training-set size N={X.shape[0]}; choose k <= N"
            )
        return VecchiaState(X=X, y=y, spec=spec)

    def mean_var(self, state: VecchiaState, Xs):
        from .fagp import _f32

        spec = state.spec
        bq, bt = self._blocks(spec, state.n_train)
        mu, var = _mean_var(
            state.X, _as_2d(state.y), _f32(Xs, spec.device), spec.eps, spec.noise,
            kernel=spec.kernel, k=int(spec.neighbors), block_q=bq, block_t=bt,
        )
        return (mu[:, 0] if state.y.ndim == 1 else mu), var

    def update(self, state: VecchiaState, X_new, y_new) -> VecchiaState:
        from .fagp import _f32

        X_new = _f32(X_new, state.spec.device)
        y_new = _f32(y_new, state.spec.device)
        if y_new.ndim != state.y.ndim or (
            y_new.ndim == 2 and y_new.shape[1] != state.y.shape[1]
        ):
            raise ValueError(
                f"update task mismatch: state holds {state.n_tasks} "
                f"task(s) but y_new has shape {tuple(y_new.shape)}"
            )
        return dataclasses.replace(
            state,
            X=torch.cat([state.X, X_new], dim=0),
            y=torch.cat([state.y, y_new], dim=0),
        )

    def nlml(self, X, y, spec, *, mask=None):
        from .fagp import _f32

        if mask is not None:
            raise UnsupportedError(
                f"approximation 'vecchia' does not support 'nlml_mask' for "
                f"{spec.describe()}: the ordered factorization has no "
                f"masked-row form yet",
                layer="approximation", capability="nlml_mask", spec=spec,
            )
        X, y = _f32(X, spec.device), _f32(y, spec.device)
        k = min(int(spec.neighbors), X.shape[0])
        bq, bt = self._blocks(spec, X.shape[0])
        return _nlml(X, _as_2d(y), spec.eps, spec.noise,
                     kernel=spec.kernel, k=k, block_q=bq, block_t=bt)

    # -- checkpoint hooks ---------------------------------------------------

    def ckpt_leaf_names(self) -> tuple:
        return ("X", "y")

    def ckpt_leaves(self, state: VecchiaState) -> dict:
        return {"X": state.X, "y": state.y}

    def ckpt_meta(self, state: VecchiaState) -> dict:
        return {"N": int(state.n_train), "n_tasks": int(state.n_tasks)}

    def ckpt_rebuild(self, spec, leaves: dict, train) -> VecchiaState:
        return VecchiaState(X=leaves["X"], y=leaves["y"], spec=spec)


VECCHIA = VecchiaApproximation()
register_approximation(VECCHIA)
