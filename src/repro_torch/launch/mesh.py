"""Device meshes: named grids of ``torch.device`` for the sharded paths.

Counterpart of ``repro/launch/mesh.py``.  The JAX package shards over a
``jax.sharding.Mesh`` of this host's devices and runs one ``shard_map``
program across it.  The port keeps that single controller: a :class:`Mesh`
is a named grid of ``torch.device``, and the sharded paths
(``core/distributed.py``, ``bank/sharded.py``, the LM half's
``parallel/``) place each shard's tensors on its grid cell and launch its
work there, one shard after another from the one host thread (each card
runs its own queue).

By default a mesh takes the visible CUDA devices and raises, naming the
count, when fewer are visible than it asks for; it never moves to the CPU
on its own.  An explicit ``devices`` list may repeat a device (``["cpu"] *
8`` in the tests, ``[cuda:0] * 4`` on one card): every shard's code path,
placement and launch count then runs on that one device, the counterpart
of the JAX tests' forced host device count.

Functions, so that importing this module touches no device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "make_production_mesh", "make_local_mesh", "make_bank_mesh"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A named grid of devices.

    devices:    ``np.ndarray`` (dtype object) of ``torch.device``, one axis
                per name; a device may appear in several cells.
    axis_names: the axes' names, in order.
    """

    devices: np.ndarray
    axis_names: tuple

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-d device grid needs as many axis "
                             f"names, got {self.axis_names!r}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _grid(shape: tuple, names: tuple, devices: Optional[Sequence], who: str) -> Mesh:
    n = int(np.prod(shape))
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        where = "CUDA devices visible"
    else:
        devices = [torch.device(d) for d in devices]
        # a bare "cuda" is the current card, by its index
        devices = [torch.device("cuda", torch.cuda.current_device())
                   if d.type == "cuda" and d.index is None else d for d in devices]
        where = "devices given"
    if len(devices) < n:
        raise ValueError(
            f"{who} wants {n} devices; only {len(devices)} {where} (pass "
            f"devices=[...] listing a device several times to put several shards "
            f"on one device)")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(shape), names)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """The LM half's pod mesh: 16 x 16 = 256 cells over ("data", "model");
    ``multi_pod`` adds the leading "pod" axis (2 x 16 x 16 = 512 cells).
    Gradient sync across "pod" is a pure all-reduce; FSDP and TP stay
    inside a pod (axes "data" and "model").  Over this host's cards (it
    raises, naming the count, with fewer), or over ``devices``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _grid(shape, axes, devices, f"make_production_mesh(multi_pod={multi_pod})")


def make_local_mesh(data: int = 1, model: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over this host's cards, or over ``devices``."""
    return _grid((data, model), ("data", "model"), devices,
                 f"make_local_mesh(data={data}, model={model})")


def make_bank_mesh(bank: int, data: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A (bank, data) mesh for the sharded fleet: 'bank' splits the tenant
    axis (``ShardedGPBank``), 'data' optionally splits each bank shard's
    fit rows.  Over this host's cards, or over ``devices``."""
    return _grid((bank, data), ("bank", "data"), devices,
                 f"make_bank_mesh(bank={bank}, data={data})")
