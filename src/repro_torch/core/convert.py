"""Carry a spec, a fitted state or a whole bank across from the JAX package.

The caller hands over the JAX ``GPSpec`` / ``FAGPState`` / ``GPBank``
leaves as numpy arrays (``np.asarray(jax_state.chol)``, ...) plus the
static fields; this module never imports JAX.  What is carried across
serves exactly as it did in the JAX package:
``GP.from_state(state_from_numpy(...)).mean_var`` and
``bank_from_numpy(...).mean_var``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .fagp import FAGPState, GPSpec, _check_backend_support
from .mercer import SEKernelParams

__all__ = ["spec_from_numpy", "state_from_numpy", "bank_from_numpy"]


def _t(x, dev, dtype=torch.float32):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return torch.as_tensor(np.array(x), dtype=dtype, device=dev).contiguous()


def spec_from_numpy(
    *,
    eps,
    rho,
    noise,
    n: int,
    index_set: str = "full",
    degree: Optional[int] = None,
    expansion: str = "hermite",
    backend: str = "jnp",
    omega=None,
    block_rows: int = 4096,
    store_train: bool = False,
    device=None,
) -> GPSpec:
    """A port ``GPSpec`` from the JAX spec's leaves (numpy) and static
    fields.  The leaves are taken as they are (no re-draw of omega)."""
    dev = resolve_device(device)
    spec = GPSpec(
        eps=_t(np.atleast_1d(eps), dev), rho=_t(np.atleast_1d(rho), dev),
        noise=_t(noise, dev), n=int(n), index_set=index_set, degree=degree,
        block_rows=int(block_rows), store_train=bool(store_train),
        backend=backend, expansion=expansion,
        omega=None if omega is None else _t(omega, dev),
    )
    _check_backend_support(spec)
    return spec


def state_from_numpy(
    *,
    idx,
    lam,
    sqrtlam,
    chol,
    u,
    b,
    Phi=None,
    y=None,
    spec: Optional[GPSpec] = None,
    device=None,
    **spec_fields,
) -> FAGPState:
    """A port ``FAGPState`` from the JAX state's leaves (numpy).  Pass the
    port ``spec``, or the fields :func:`spec_from_numpy` takes.  The index
    table must be the one the spec generates.  ``Phi`` and ``y`` are the
    stored training data of a ``store_train`` state (both or neither)."""
    if spec is None:
        spec = spec_from_numpy(device=device, **spec_fields)
    elif spec_fields:
        raise TypeError("pass either spec= or the spec fields, not both")
    idx = np.asarray(idx)
    want = spec.indices()
    if idx.shape != want.shape or not np.array_equal(idx, want):
        raise ValueError(
            f"state_from_numpy: the index table {idx.shape} is not the one "
            f"{spec.describe()} generates {want.shape}"
        )
    if (Phi is None) != (y is None):
        raise ValueError("state_from_numpy: pass both Phi and y, or neither")
    dev = spec.device
    return FAGPState(
        idx=_t(idx, dev, torch.int32), lam=_t(lam, dev),
        sqrtlam=_t(sqrtlam, dev), chol=_t(chol, dev), u=_t(u, dev),
        b=_t(b, dev), spec=spec,
        Phi=None if Phi is None else _t(Phi, dev),
        y=None if y is None else _t(y, dev),
    )


def bank_from_numpy(
    *,
    idx,
    lam,
    sqrtlam,
    chol,
    u,
    b,
    slots,
    active,
    spec: Optional[GPSpec] = None,
    hypers=None,
    device=None,
    **spec_fields,
):
    """A port ``GPBank`` from a JAX bank: its stacked leaves (numpy, leading
    capacity axis on lam/sqrtlam/chol/u/b), ``slots`` (tenant -> slot),
    ``active`` (capacity,) and the spec (the port ``spec``, or the fields
    :func:`spec_from_numpy` takes).  A heterogeneous bank's ``hypers``
    (anything with per-slot ``eps`` and ``rho`` (C, p) and ``noise`` (C,),
    a JAX ``SEKernelParams`` too) becomes the port's overlay."""
    from ..bank import GPBank

    stack = state_from_numpy(idx=idx, lam=lam, sqrtlam=sqrtlam, chol=chol, u=u,
                             b=b, spec=spec, device=device, **spec_fields)
    C, M = stack.u.shape[0], stack.n_features
    shapes = {"lam": (C, M), "sqrtlam": (C, M), "chol": (C, M, M), "u": (C, M),
              "b": (C, M)}
    for f, want in shapes.items():
        if tuple(getattr(stack, f).shape) != want:
            raise ValueError(f"bank_from_numpy: {f} must be {want}, got "
                             f"{tuple(getattr(stack, f).shape)}")
    active = np.asarray(active, bool)
    slots = {t: int(s) for t, s in dict(slots).items()}
    taken = sorted(slots.values())
    if active.shape != (C,) or taken != sorted(np.flatnonzero(active).tolist()):
        raise ValueError(
            f"bank_from_numpy: slots {slots!r} must name each active slot of "
            f"the (capacity={C},) active mask exactly once"
        )
    if hypers is not None:
        if not all(hasattr(hypers, f) for f in ("eps", "rho", "noise")):
            raise TypeError(f"bank_from_numpy: hypers must carry per-slot eps, rho and noise, "
                            f"got {type(hypers).__name__}")
        dev = stack.spec.device
        hypers = SEKernelParams(**{f: _t(getattr(hypers, f), dev)
                                   for f in ("eps", "rho", "noise")})
    return GPBank(stack=stack, active=active, slots=slots, hypers=hypers)
