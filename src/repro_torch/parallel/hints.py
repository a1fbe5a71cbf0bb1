"""Context-scoped sharding hints: the port of ``repro/parallel/hints.py``.

Model code stays mesh-agnostic: it calls ``constrain(x, logical_axes)``
and ``active_mesh()``; with no mesh activated (unit tests, one device)
these do nothing.  The sharded steps (``launch/steps.py``) activate the
mesh around a model call.

Logical axis vocabulary: 'dp' (pod x data), 'dpm' (every mesh axis),
'data', 'model', None.  An axis the dimension cannot divide is dropped.

The reference's ``constrain`` pins an activation's layout for XLA's SPMD
partitioner.  The port runs on A5's single controller, where no
partitioner acts on a pin: a model call under a mesh computes whole
tensors on one device, and the expert-parallel MoE path and the sharded
steps place their pieces by hand.  So ``constrain`` returns its argument
itself, no copy; :func:`constrained_spec` is the spec the reference would
pin (the tests hold it against the reference's).
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np

__all__ = ["activate", "active_mesh", "constrain", "constrained_spec", "resolve", "dp_axes",
           "sp_scope", "sp_enabled"]

_STATE = threading.local()


def dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


@contextlib.contextmanager
def activate(mesh):
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def active_mesh():
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def sp_scope(on: bool = True):
    """Scopes the sequence-parallel residual pin to training: forward-only
    paths (prefill) leave it off, as in the reference."""
    prev = getattr(_STATE, "sp", False)
    _STATE.sp = on
    try:
        yield
    finally:
        _STATE.sp = prev


def sp_enabled() -> bool:
    return getattr(_STATE, "sp", False)


def resolve(mesh, logical):
    if logical is None:
        return None
    if logical == "dp":
        return dp_axes(mesh)
    if logical == "dpm":  # every mesh axis: embarrassingly parallel row work
        return tuple(mesh.axis_names)
    return logical


def _axis_size(mesh, ax) -> int:
    if ax is None:
        return 1
    names = ax if isinstance(ax, tuple) else (ax,)
    return int(np.prod([mesh.shape[a] for a in names]))


def constrained_spec(mesh, shape, logical_axes):
    """The :class:`~repro_torch.parallel.sharding.PartitionSpec` the
    reference's ``constrain`` pins a tensor of ``shape`` to: each logical
    axis resolved on ``mesh``, dropped where it does not divide the
    dimension."""
    from .sharding import PartitionSpec

    spec = []
    for dim, ax in zip(shape, logical_axes):
        r = resolve(mesh, ax)
        spec.append(r if (r is None or dim % _axis_size(mesh, r) == 0) else None)
    return PartitionSpec(*spec)


def constrain(x, logical_axes):
    """The reference's sharding pin: ``x`` itself (no partitioner acts on a
    pin here; see the module's docstring), its spec resolved on the active
    mesh as the reference resolves it, which raises on an axis the mesh
    lacks."""
    mesh = active_mesh()
    if mesh is not None:
        constrained_spec(mesh, x.shape, logical_axes)
    return x
