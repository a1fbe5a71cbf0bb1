"""Shard-local spec plumbing shared by the sharded paths.

Counterpart of ``repro/core/shardspec.py``.  The row-sharded fit and
serving (``core/distributed.py``) and the bank-axis sharding
(``bank/sharded.py``) both rebuild a spec for each shard and probe mesh
sizes; this module is the one home of that glue.

In the JAX package ``spec_local`` rebuilds the spec from shard-local
leaves inside a ``shard_map`` body.  The port has no ``shard_map``: a
shard is a device of a :class:`~repro_torch.launch.mesh.Mesh`, so
``spec_local`` gives the spec with its leaves on that device.  The JAX
module's version shims (``shard_map``, ``has_shard_map``) have no
counterpart here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .fagp import GPSpec

__all__ = ["spec_local", "omega_args", "mesh_size", "axis_size"]


def omega_args(spec: GPSpec) -> tuple:
    """The spec's optional spectral-draw leaf as a tuple (empty unless the
    expansion carries one)."""
    return () if spec.omega is None else (spec.omega,)


def spec_local(spec: GPSpec, device) -> GPSpec:
    """``spec`` with its leaves (eps, rho, noise and any spectral draws) on
    ``device``: the spec a shard on that device fits and serves under.  The
    spec itself when it is there already."""
    device = torch.device(device)
    if spec.device == device:
        return spec
    omega = tuple(w.to(device) for w in omega_args(spec))
    return dataclasses.replace(
        spec, eps=spec.eps.to(device), rho=spec.rho.to(device),
        noise=spec.noise.to(device), omega=omega[0] if omega else None)


def mesh_size(mesh) -> int:
    """Total device count of a mesh (product over every axis)."""
    return int(np.prod(list(mesh.shape.values())))


def axis_size(mesh, axis: str, default: int = 1) -> int:
    """Size of one named mesh axis (``default`` when the axis is absent)."""
    return int(mesh.shape.get(axis, default))
