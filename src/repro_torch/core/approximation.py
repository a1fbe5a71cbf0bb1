"""Approximation registry behind ``GP``: the ``fagp`` and ``vecchia``
families.

Counterpart of ``repro/core/approximation.py``: the structured refusal
:class:`UnsupportedError`, the name -> family registry that
``core/gp.py`` dispatches through, and the checkpoint hooks that
``checkpoint/gpstate.py`` serializes through.  Each family registers
itself when its module is imported (``core/fagp.py`` imports
``core/vecchia.py`` at its bottom).
"""
from __future__ import annotations

from typing import Any, Optional

__all__ = [
    "Approximation",
    "UnsupportedError",
    "available_approximations",
    "get_approximation",
    "register_approximation",
    "require_capability",
]


def _describe(spec: Any) -> str:
    describe = getattr(spec, "describe", None)
    return describe() if callable(describe) else repr(spec)


class UnsupportedError(ValueError):
    """A layer refused an operation it does not implement for this spec.

    layer:      ``"approximation"``, ``"backend"`` or ``"port"`` (an
                operation the JAX package has and this port does not yet).
    capability: what was asked of it.
    spec:       the offending ``GPSpec`` (or None).

    The message always contains "does not support".
    """

    def __init__(self, message: str, *, layer: str, capability: str,
                 spec: Any = None):
        super().__init__(message)
        self.layer = layer
        self.capability = capability
        self.spec = spec


class Approximation:
    """One registered approximation family behind the ``GP`` facade.

    Subclasses set ``name`` and ``capabilities`` and implement the
    operations they declare; ``GP`` checks the flags before calling.

    Checkpoint hooks (``checkpoint/gpstate.py`` serializes any family
    through these; the manifest records ``spec.approximation``):

    ckpt_leaf_names: the ordered array-leaf names of the state.
    ckpt_leaves:     state -> {name: tensor} for exactly those names.
    ckpt_meta:       state -> extra manifest metadata (informational).
    ckpt_rebuild:    (spec, leaves, train) -> state; ``train`` is the
                     optional stored-training-data dict (FAGP's
                     ``store_train`` path) or None.
    """

    name: str = "abstract"
    capabilities: frozenset = frozenset()

    def validate(self, spec: Any) -> None:
        raise NotImplementedError

    def fit(self, X, y, spec):
        self.refuse("fit", spec)

    def predict(self, state, Xs, *, mode: str = "fused"):
        self.refuse("predict", getattr(state, "spec", None))

    def mean_var(self, state, Xs):
        self.refuse("mean_var", getattr(state, "spec", None))

    def update(self, state, X_new, y_new):
        self.refuse("update", getattr(state, "spec", None))

    def nlml(self, X, y, spec, *, mask=None):
        self.refuse("nlml", spec)

    def optimize(self, X, y, spec, **kwargs):
        self.refuse("optimize", spec)

    def ckpt_leaf_names(self) -> tuple:
        raise NotImplementedError

    def ckpt_leaves(self, state) -> dict:
        raise NotImplementedError

    def ckpt_meta(self, state) -> dict:
        return {}

    def ckpt_rebuild(self, spec, leaves: dict, train: Optional[dict]):
        raise NotImplementedError

    def refuse(self, capability: str, spec: Any) -> None:
        raise UnsupportedError(
            f"approximation {self.name!r} does not support {capability!r} "
            f"for {_describe(spec)}; its capabilities are "
            f"{sorted(self.capabilities)}",
            layer="approximation", capability=capability, spec=spec,
        )


_APPROXIMATIONS: dict = {}


def register_approximation(approx: Approximation) -> None:
    _APPROXIMATIONS[approx.name] = approx


def get_approximation(name: str) -> Approximation:
    try:
        return _APPROXIMATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown approximation {name!r}; registered: "
            f"{available_approximations()}"
        ) from None


def available_approximations() -> list:
    return sorted(_APPROXIMATIONS)


def require_capability(approx: Approximation, capability: str,
                       spec: Any) -> None:
    """Raise the family's structured refusal unless it declares
    ``capability``."""
    if capability not in approx.capabilities:
        approx.refuse(capability, spec)
