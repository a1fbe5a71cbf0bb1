"""`GP`: one facade over the predictive-posterior pipeline.

Counterpart of ``repro/core/gp.py``:

    from repro_torch.core.gp import GP, GPSpec

    spec = GPSpec.create(n=8, eps=[0.8, 0.8], noise=0.05, backend="pallas")
    gp = GP.fit(X, y, spec)              # spec baked into the session
    mu, var = gp.mean_var(Xs)            # serving path (marginal variance)
    mu, cov = gp.predict(Xs)             # full covariance
    gp = gp.update(X_new, y_new)         # rank-k ingest, no refit
    loss = gp.nlml(X, y)                 # NLML under the session's spec
    gp = GP.optimize(X, y, spec, steps=100, restarts=4)  # learn, then fit
    version = gp.save(ckpt_dir)          # versioned checkpoint
    gp = GP.load(ckpt_dir)               # newest version, onto the card

Every method dispatches through the session's registered approximation
family: ``"fagp"`` (the paper's decomposed kernel, the default) or
``"vecchia"`` (nearest-neighbour conditioning, ``core/vecchia.py``)::

    spec = GPSpec.create_vecchia([2.0, 2.0], 0.1, kernel="matern52", neighbors=32)
    gp = GP.fit(X, y, spec)              # same facade, local conditioning

An operation a family does not implement (``predict`` and ``optimize`` on
vecchia) raises the structured ``UnsupportedError``.
``predict(mode="paper")`` (the literal Eqs. 11-12 chain) needs a spec with
``store_train=True``.  Checkpoints are the JAX package's format:
``GP.save`` here loads with ``repro.core.gp.GP.load`` and back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from . import fagp  # noqa: F401  (registers the fagp family)
from .approximation import (
    Approximation,
    UnsupportedError,
    get_approximation,
    require_capability,
)
from .fagp import GPSpec

__all__ = ["GP", "GPSpec", "Approximation", "UnsupportedError"]


def _not_ported(capability: str, slice_name: str, spec: Any = None):
    raise UnsupportedError(
        f"repro_torch does not support {capability!r} yet: it comes with "
        f"the {slice_name} slice of the port (see ROADMAP.md)",
        layer="port", capability=capability, spec=spec,
    )


@dataclasses.dataclass(frozen=True, eq=False)
class GP:
    """A fitted GP session: the state (spec baked in) plus methods.
    Construct with :meth:`fit` or :meth:`from_state`."""

    state: Any

    @classmethod
    def fit(cls, X, y, spec: GPSpec) -> "GP":
        """Fit the posterior; y is (N,) or (N, T)."""
        ap = get_approximation(spec.approximation)
        require_capability(ap, "fit", spec)
        return cls(state=ap.fit(X, y, spec))

    @classmethod
    def from_state(cls, state) -> "GP":
        """Wrap an existing fitted state (e.g. from ``core/convert.py``)."""
        if getattr(state, "spec", None) is None:
            raise ValueError("state has no baked GPSpec")
        return cls(state=state)

    @classmethod
    def optimize(
        cls,
        X,
        y,
        spec: GPSpec,
        *,
        steps: int = 100,
        lr: float = 5e-2,
        restarts: int = 1,
        tol: Optional[float] = None,
        jitter: float = 0.3,
        seed: int = 0,
        callback: Optional[Callable[[int, float, GPSpec], None]] = None,
    ) -> "GP":
        """Gradient NLML hyperparameter learning, then a fit at the learned
        hyperparameters.

        Minimizes ``nlml(X, y, spec) / N`` over (eps, rho, noise) in log
        space with AdamW on the lane engine (``repro_torch.optim.
        gp_hyperopt``): ``restarts`` lanes start from log-space jittered
        inits (restart 0 is always the unperturbed spec; the jitter draws
        are the port's own, see that module), the best lane by final NLML
        wins, and ``tol`` freezes converged lanes early.  The objective's
        moments stream through the backend registry (on the card, the
        fused-fit kernel), and its gradient through the streamed backward
        pass, so no N x M feature matrix is formed on either backend.

        ``callback(step, nlml_per_row, current_spec)`` is invoked every 10%
        of the run with the currently best lane's loss and hyperparameters.
        """
        ap = get_approximation(spec.approximation)
        require_capability(ap, "optimize", spec)
        return cls(state=ap.optimize(
            X, y, spec, steps=steps, lr=lr, restarts=restarts, tol=tol,
            jitter=jitter, seed=seed, callback=callback,
        ))

    @property
    def spec(self) -> GPSpec:
        return self.state.spec

    @property
    def approximation(self) -> Approximation:
        return get_approximation(self.spec.approximation)

    @property
    def n_features(self) -> int:
        return self.state.n_features

    @property
    def n_tasks(self) -> int:
        return self.state.n_tasks

    def predict(self, Xs, *, mode: str = "fused"):
        """Posterior mean and full covariance at Xs (paper Eqs. 11-12)."""
        ap = self.approximation
        require_capability(ap, "predict", self.spec)
        return ap.predict(self.state, Xs, mode=mode)

    def mean_var(self, Xs):
        """Posterior mean and marginal variance: the serving path."""
        ap = self.approximation
        require_capability(ap, "mean_var", self.spec)
        return ap.mean_var(self.state, Xs)

    def update(self, X_new, y_new) -> "GP":
        """Absorb new observations (rank-k Cholesky update)."""
        ap = self.approximation
        require_capability(ap, "update", self.spec)
        return GP(state=ap.update(self.state, X_new, y_new))

    def nlml(self, X, y):
        """NLML of (X, y) under this session's spec."""
        ap = self.approximation
        require_capability(ap, "nlml", self.spec)
        return ap.nlml(X, y, self.spec)

    def with_spec(self, spec=None, **overrides) -> "GP":
        """Swap execution knobs (backend, block_rows); structural changes
        are rejected."""
        return GP(state=self.state.with_spec(spec, **overrides))

    def save(self, ckpt_dir, *, step: Optional[int] = None) -> int:
        """Serialize this session under ``ckpt_dir`` (versioned: each save
        lands as ``step_<version>``; ``step=None`` auto-increments).  The
        manifest records the spec's structure, so :meth:`load` round-trips
        bit-exactly (stored features included) and a restore into an
        incompatible spec raises.  Returns the version written."""
        from ..checkpoint import gpstate

        return gpstate.save_state(ckpt_dir, self.state, step=step)

    @classmethod
    def load(cls, ckpt_dir, *, step: Optional[int] = None,
             spec: Optional[GPSpec] = None, device=None) -> "GP":
        """Restore a session saved by :meth:`save` (here or by the JAX
        package; ``step=None`` loads the newest version).  The spec is
        rebuilt from the checkpoint; passing ``spec`` validates the
        checkpoint against it (structure and hyperparameters) and raises on
        a mismatch.  ``device`` defaults to ``spec``'s device when a spec
        is given, else to ``"cuda"`` (raising without a card)."""
        from ..checkpoint import gpstate

        if device is None and spec is not None:
            device = spec.device
        _, state, _ = gpstate.load_state(ckpt_dir, step=step, like_spec=spec,
                                         require_hypers_match=True, device=device)
        return cls(state=state)
