"""`GP`: one facade over the predictive-posterior pipeline.

Counterpart of ``repro/core/gp.py``:

    from repro_torch.core.gp import GP, GPSpec

    spec = GPSpec.create(n=8, eps=[0.8, 0.8], noise=0.05, backend="pallas")
    gp = GP.fit(X, y, spec)              # spec baked into the session
    mu, var = gp.mean_var(Xs)            # serving path (marginal variance)
    mu, cov = gp.predict(Xs)             # full covariance
    gp = gp.update(X_new, y_new)         # rank-k ingest, no refit
    loss = gp.nlml(X, y)                 # NLML under the session's spec
    version = gp.save(ckpt_dir)          # versioned checkpoint
    gp = GP.load(ckpt_dir)               # newest version, onto the card

Every method dispatches through the session's registered approximation
family.  ``predict(mode="paper")`` (the literal Eqs. 11-12 chain) needs a
spec with ``store_train=True``.  Checkpoints are the JAX package's format:
``GP.save`` here loads with ``repro.core.gp.GP.load`` and back.
``optimize`` is not ported yet and raises :class:`UnsupportedError` naming
the slice of the port that brings it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

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
    def optimize(cls, X, y, spec: GPSpec, **kwargs) -> "GP":
        """Gradient NLML hyperparameter learning (not ported yet)."""
        _not_ported("optimize", "NLML gradient and GP.optimize (ROADMAP A1)", spec)

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
        _, state = gpstate.load_state(ckpt_dir, step=step, like_spec=spec,
                                      device=device)
        return cls(state=state)
