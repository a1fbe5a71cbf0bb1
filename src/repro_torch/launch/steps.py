"""Step builders of the LM half (the port of ``repro/launch/steps.py``):
the train step ``launch/train.py`` drives and the prefill and decode
steps ``launch/serve.py`` drives.

Each step takes the parameters as a model or, under a mesh, as a
:class:`~repro_torch.parallel.sharding.ShardedParams` (``parallel.
sharding.place(model, param_shardings(...))``), where the reference jits
the same step with shardings.  On the port's single controller the
sharded steps do by hand what XLA does for the reference:

* the train step runs each dp cell (one (pod, data) index, its row of
  'model' cells) in cell order: the cell gathers every leaf onto its
  device (ZeRO-3's all-gather), runs forward and backward on its slice of
  the batch under its row's mesh (so an MoE layer runs expert-parallel
  over the row's model cells), and its gradients are added into the
  leaves' pieces in cell order (the reduce-scatter); AdamW then steps each
  piece on its own device, the clip's global norm summed over every
  distinct piece;
* prefill and decode run the whole batch under the mesh on its first
  cell's device: every leaf gathered there at use but the MoE experts,
  which ``models.moe.moe_apply_sharded`` uses piece by piece; the cache
  comes back placed by ``cache_shardings`` and a decode step gathers it,
  writes the new position and puts it back into its pieces.

The dense products are not split by hand (no tensor-parallel compute): a
piece is gathered at use, so the values are the reference's (its
partitioned products sum in another order).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import optim
from ..models import lm
from ..parallel import hints
from ..parallel.sharding import ShardedParams, Sharded, cache_shardings, gather_tree, place

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step"]


def make_train_step(model, ocfg: optim.AdamWConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients (``model.loss_fn`` with
    gradients on, :func:`repro_torch.models.lm.trainable`), then one AdamW
    step written into the parameters and ``opt_state`` in place (the
    reference donates both: ``donate_argnums=(0, 1)``), so no second copy
    of the model is ever whole.  ``opt_state`` is
    ``optim.init(lm.leaves(params), ocfg)``; ``metrics`` holds the loss's
    (``loss``, ``aux``, ``tokens``) and the optimizer's (``grad_norm``,
    ``lr``).  Weight decay falls on the leaves of rank >= 2 in the
    reference's tree, where a block's leaves are stacked over layers: its
    norms and biases are decayed too, the final norm and the MTP head's two
    norms are not.  Under a mesh (``params`` a ``ShardedParams``, the AdamW
    state placed by ``opt_state_shardings``) the step is the sharded one of
    the module's docstring."""
    def train_step(params, opt_state, batch):
        if isinstance(params, ShardedParams):
            return _sharded_train_step(model, ocfg, params, opt_state, batch)
        named = lm.leaves(params)
        with lm.trainable(params):
            loss, metrics = model.loss_fn(params, batch)
            grads = torch.autograd.grad(loss, list(named.values()))
        om = optim.apply_updates_(named, dict(zip(named, grads)), opt_state, ocfg,
                                  ndims=lm.ref_ndims(params))
        del grads
        return params, opt_state, {**{k: v.detach() for k, v in metrics.items()}, **om}

    return train_step


def dp_cells(mesh) -> list:
    """The mesh's dp cells in cell order: for each index over its dp axes
    ((pod,) data), the mesh of that index's row of cells (the dp axes kept
    at size 1)."""
    dp = hints.dp_axes(mesh)
    lead = [mesh.axis_names.index(a) for a in dp]
    if lead != list(range(len(dp))):
        raise ValueError(f"a mesh whose leading axes are {dp!r} is wanted, got "
                         f"{mesh.axis_names!r}")
    out = []
    for idx in np.ndindex(*mesh.devices.shape[:len(dp)]):
        grid = mesh.devices[tuple(slice(i, i + 1) for i in idx)]
        out.append(type(mesh)(grid, mesh.axis_names))
    return out


def _rows(batch: dict, r: int, n: int, B: int) -> dict:
    """dp cell r's slice of every batch leaf whose leading axis is the
    batch's (B), the others whole."""
    b = B // n
    return {k: (v[r * b:(r + 1) * b] if isinstance(v, torch.Tensor) and v.ndim
                and v.shape[0] == B else v) for k, v in batch.items()}


def _slices(bounds) -> tuple:
    return tuple(slice(*b) for b in bounds)


def _sharded_train_step(model, ocfg, params: ShardedParams, opt_state, batch):
    cells = dp_cells(params.mesh)
    n = len(cells)
    B = int(batch["tokens"].shape[0])
    if B % n:
        raise ValueError(f"a batch of {B} rows does not split over {n} dp cells")
    home = params.device
    pieces = {name: sh.unique() for name, sh in params.leaves.items()}
    acc = {name: [None] * len(ps) for name, ps in pieces.items()}
    sums = {}
    for r, row in enumerate(cells):
        dev = row.devices.flat[0]
        full = params.materialize(dev, requires_grad=True)   # ZeRO-3: gathered at use
        named = lm.leaves(full)
        with hints.activate(row):
            loss, metrics = model.loss_fn(full, _rows(batch, r, n, B))
            # the mean over the dp cells (equal token counts) is the global loss
            grads = torch.autograd.grad(loss / n, list(named.values()))
        for name, g in zip(named, grads):                   # the reduce-scatter
            for i, (b, piece) in enumerate(pieces[name]):
                part = g[_slices(b)]
                acc[name][i] = (part.to(piece.device, copy=True) if acc[name][i] is None
                                else acc[name][i] + part.to(piece.device))
        for k, v in metrics.items():
            v = v.detach().to(home)
            sums[k] = v if k not in sums else sums[k] + v
        del full, named, grads, loss, metrics
    out = {k: (v if k == "tokens" else v / n) for k, v in sums.items()}

    # the clip's global norm: every distinct slice of every leaf once
    sq = torch.zeros((), dtype=torch.float32, device=home)
    for name, ps in pieces.items():
        seen = set()
        for (b, _), g in zip(ps, acc[name]):
            if b not in seen:
                seen.add(b)
                sq = sq + torch.sum(torch.square(g.to(torch.float32))).to(home)
    gnorm = torch.sqrt(sq)

    # AdamW on each device's pieces, one call a device (its own step counter)
    groups = {}
    for name, ps in pieces.items():
        mu = opt_state["mu"][name]
        moments = [mu["m"].unique(), mu["v"].unique()]
        for i, (b, piece) in enumerate(ps):
            (bm, m), (bv, v) = moments[0][i], moments[1][i]
            if not (bm == bv == b and m.device == v.device == piece.device):
                raise ValueError(f"{name}: the AdamW state is not placed as the parameter")
            g = groups.setdefault(str(piece.device), {"p": {}, "g": {}, "mu": {}, "nd": {}})
            key = (name, i)
            g["p"][key], g["g"][key] = piece, acc[name][i]
            g["mu"][key] = {"m": m, "v": v}
            g["nd"][key] = params.ndims[name]
    steps = {str(t.device): t for _, t in opt_state["step"].unique()}
    om = None
    for dev, g in groups.items():
        res = optim.apply_updates_(g["p"], g["g"], {"mu": g["mu"], "step": steps[dev]}, ocfg,
                                   ndims=g["nd"], grad_norm=gnorm.to(dev))
        om = om or res
    return params, opt_state, {**out, **{k: v.to(home) for k, v in om.items()}}


def expert_leaf(name: str) -> bool:
    """An MoE block's expert leaf (``moe.wg``, ``moe.wu``, ``moe.wd``),
    which the sharded serving steps keep in pieces."""
    return name.rpartition(".")[0].endswith("moe") and name.rpartition(".")[2] in (
        "wg", "wu", "wd")


def make_prefill_step(model, cache_len=None):
    """``prefill_step(params, batch) -> (logits, cache)``; under a mesh
    (``params`` a ``ShardedParams``) the cache comes back placed by
    ``cache_shardings``."""
    def prefill_step(params, batch):
        if not isinstance(params, ShardedParams):
            return model.prefill(params, batch, cache_len=cache_len)
        full = params.materialize(params.device, keep=expert_leaf)
        with hints.activate(params.mesh):
            logits, cache = model.prefill(full, batch, cache_len=cache_len)
        del full
        return logits, place(cache, cache_shardings(cache, model.cfg, params.mesh))

    return prefill_step


def make_decode_step(model):
    """The decode step writes the cache in place (the reference donates
    it: ``donate_argnums=(2,)``); under a mesh into the cache's pieces."""
    def decode_step(params, batch, cache):
        if not isinstance(params, ShardedParams):
            return model.decode_step(params, batch, cache)
        full = params.materialize(params.device, keep=expert_leaf)
        whole = gather_tree(cache, params.device)
        with hints.activate(params.mesh):
            logits, whole = model.decode_step(full, batch, whole)
        for k, v in cache.items():
            if isinstance(v, Sharded):
                v.assign_(whole[k])
        return logits, cache

    return decode_step
