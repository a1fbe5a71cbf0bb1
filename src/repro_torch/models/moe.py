"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch:
the port of ``repro/models/moe.py`` as plain functions on tensors.

As there, no (T, E, C) one-hot is formed: a stable sort ranks each
assignment within its expert (token-major, so capacity drops the last
tokens first), the kept assignments fill an (E, C) table of token ids, and
the experts run as batched products (``torch.bmm``) over the gathered
(E, C, d) buffer, padding slots included.  Every table has a fixed shape
(dropped assignments go to one extra slot that is then cut off): no
``nonzero``, no boolean indexing, no host read, so a decode step holds no
host sync and can be captured in a CUDA graph.

Where the port departs from the reference's operations, and why:

* **Top-k.**  ``jax.lax.top_k`` keeps the lower index on a tie;
  ``torch.topk`` promises no order.  The experts are picked by a stable
  descending sort of the float32 probabilities, which keeps the lower
  index first.
* **A fixed-order combine.**  The reference combines with a scatter-add
  (``y.at[token_for_slot].add(ye * w)``) and its gather ``x_pad[
  token_for_slot]`` has a scatter-add for a backward pass.  On the card an
  ``index_add_`` sums with atomics in no fixed order, so two runs, or a
  block and its recomputation under ``torch.utils.checkpoint``, could
  differ.  Here :func:`_dispatch_tables` also builds the inverse table
  ``slot_of`` (T, k): each token's slots in assignment order (the top-k
  order), the drop slot ``n_local * C`` standing for a zero row.  The
  combine (:class:`_Combine`) and the gather's backward pass
  (:class:`_Dispatch`) sum a token's rows in that order, one add at a
  time **in x's dtype** (bfloat16 in the models), as the reference's
  scatter-add accumulates in ``y``'s dtype; only their order differs from
  the reference's (slot order on its CPU).  Every other scatter writes
  distinct positions (or the discarded drop slot), so a run is bitwise
  repeatable.
* Dtypes are the reference's: the router product and softmax in float32,
  the gates cast to x's dtype before the combine, the expert products and
  the combine in x's dtype.

``moe_apply_sharded`` is the reference's expert-parallel path under an
active mesh (``parallel.hints.activate``), on A5's single controller: each
(pod, data, model) cell holds E / model experts and its T / dp tokens, and
the host runs every cell's work on the cell's device, in cell order.  The
reference's collectives become host-ordered ``torch.cat`` and sums over
the cells: the all-gather of the tokens over 'data', the serve mode's
psum over 'data' of the partial products, the FSDP gather of the expert
weights at use, and the one combining psum over 'model'.  Both branches
are the reference's: the serve mode ((T_g k) // E <= 64 with FSDP: the
pod's tokens gathered, the expert pieces never move, each data member
contracting its d_model slice) and the branch that gathers the expert
weights at use.  Capacity is taken per dp shard (``capacity(T_l)``; the
serve mode's over the pod's T_g tokens), as in the reference.  An expert
leaf given as a :class:`~repro_torch.parallel.sharding.Sharded` placed on
the mesh with this path's spec is used piece by piece; a whole tensor is
sliced cell by cell (differentiably).  ``moe_dispatch`` takes this path
when a mesh is active, E divides the 'model' axis and T the dp size, and
``moe_apply`` (a ``Sharded`` leaf gathered first) otherwise.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import hints
from ..parallel.sharding import NamedSharding, PartitionSpec as P, Sharded
from .layers import dense_init

__all__ = ["moe_init", "moe_apply", "moe_apply_sharded", "moe_dispatch", "capacity"]


def capacity(T: int, cfg) -> int:
    """Slots an expert has for T tokens: capacity_factor * T * k / E,
    rounded up to a multiple of 8, at least 8."""
    c = int(math.ceil(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts))
    return max(8, int(math.ceil(c / 8) * 8))


def moe_init(gen: torch.Generator, cfg, dtype) -> dict:
    """The reference's leaves and distributions on the generator's device:
    ``router`` (d, E) float32, ``wg``, ``wu`` (E, d, fe) and ``wd`` (E,
    fe, d) N(0, 1) / sqrt(fan-in) in ``dtype``, and with shared experts
    ``shared_wg``, ``shared_wu`` (d, fs) and ``shared_wd`` (fs, d)."""
    d, fe, E = cfg.d_model, cfg.d_expert, cfg.n_experts

    def experts(shape, fan_in):
        # scaled in place: one float32 copy of the stack (15 GB at
        # deepseek-v3's 256 experts), not two
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
        return w.div_(math.sqrt(fan_in)).to(dtype)

    p = {
        "router": dense_init(gen, d, E, torch.float32),
        "wg": experts((E, d, fe), d),
        "wu": experts((E, d, fe), d),
        "wd": experts((E, fe, d), fe),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * fe
        p["shared_wg"] = dense_init(gen, d, fs, dtype)
        p["shared_wu"] = dense_init(gen, d, fs, dtype)
        p["shared_wd"] = dense_init(gen, fs, d, dtype, scale=1.0 / math.sqrt(fs))
    return p


def _expert_ranks(e_flat: torch.Tensor, n_assign: int) -> torch.Tensor:
    """Rank of each assignment within its expert group, in assignment
    order (a stable sort, O(n log n))."""
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    idx = torch.arange(n_assign, device=e_flat.device)
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    group_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank_sorted = (idx - group_start).to(e_flat.dtype)
    return torch.empty_like(e_flat).scatter_(0, order, rank_sorted)


def _route(p, x, cfg):
    """Router probabilities (float32), top-k, renormalized gates, aux
    loss: returns (topv (T, k) float32, topi (T, k) int64, aux)."""
    E, k = cfg.n_experts, cfg.top_k
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # a stable sort keeps jax.lax.top_k's order on ties: the lower index first
    topi = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    topv = torch.gather(probs, -1, topi)
    topv = topv / torch.sum(topv, dim=-1, keepdim=True)                  # renormalize
    experts = torch.arange(E, device=x.device)
    frac_tokens = torch.mean(torch.sum((topi[..., None] == experts).to(torch.float32),
                                       dim=1), dim=0)
    frac_probs = torch.mean(probs, dim=0)
    aux = cfg.router_aux_coef * E * torch.sum(frac_tokens * frac_probs)
    return topv, topi, aux


def _dispatch_tables(topi, topv, T, k, C, e_lo, n_local, dtype):
    """Tables for the experts in [e_lo, e_lo + n_local): ``token_for_slot``
    (n_local * C,) int32 (T: a padding slot) and ``w_for_slot`` (n_local *
    C,) in ``dtype``, both the reference's, and the inverse ``slot_of``
    (T, k) int64: each assignment's slot, ``n_local * C`` where it was
    dropped (over capacity, or another shard's expert).

    Ranks are computed over ALL assignments (global capacity semantics), as
    in the reference."""
    n_assign = T * k
    n_slots = n_local * C
    dev = topi.device
    e_flat = topi.reshape(-1).to(torch.int32)
    w_flat = topv.reshape(-1).to(dtype)
    rank = _expert_ranks(e_flat, n_assign)
    local = (e_flat >= e_lo) & (e_flat < e_lo + n_local)
    keep = (rank < C) & local
    dest = torch.where(keep, (e_flat - e_lo) * C + rank, n_slots).to(torch.int64)
    # the assignment in each slot (n_assign: none); kept slots are distinct,
    # so only the drop slot, cut off here, sees more than one write
    assign = torch.full((n_slots + 1,), n_assign, dtype=torch.int64, device=dev)
    assign = assign.scatter_(0, dest, torch.arange(n_assign, device=dev))[:n_slots]
    token_for_slot = torch.div(assign, k, rounding_mode="floor").to(torch.int32)
    w_for_slot = torch.cat([w_flat, w_flat.new_zeros(1)])[assign]
    return token_for_slot, w_for_slot, dest.reshape(T, k)


def _sum_rows(src: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """out[i] = rows inv[i, 0], inv[i, 1], ... of ``src`` (an index of
    len(src) standing for a zero row) added left to right, one rounding an
    add, in src's dtype."""
    pad = torch.cat([src, src.new_zeros((1, src.shape[1]))])
    out = pad[inv[:, 0]]
    for j in range(1, inv.shape[1]):
        out = out + pad[inv[:, j]]
    return out


def _gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows ``idx`` of ``src``, an index of len(src) giving a zero row."""
    return torch.cat([src, src.new_zeros((1, src.shape[1]))])[idx]


class _Dispatch(torch.autograd.Function):
    """xe = x_pad[token_for_slot]; the backward pass sums each token's slot
    gradients in ``slot_of``'s order (the transpose of :class:`_Combine`)."""

    @staticmethod
    def forward(ctx, x, token_for_slot, slot_of):
        ctx.save_for_backward(slot_of)
        return _gather_rows(x, token_for_slot)

    @staticmethod
    def backward(ctx, g):
        (slot_of,) = ctx.saved_tensors
        return _sum_rows(g, slot_of), None, None


class _Combine(torch.autograd.Function):
    """y[t] = the rows of ``contrib`` at slot_of[t], added in assignment
    order; the backward pass gathers y's gradient at ``token_for_slot``."""

    @staticmethod
    def forward(ctx, contrib, slot_of, token_for_slot):
        ctx.save_for_backward(token_for_slot)
        return _sum_rows(contrib, slot_of)

    @staticmethod
    def backward(ctx, g):
        (token_for_slot,) = ctx.saved_tensors
        return _gather_rows(g, token_for_slot), None, None


def _expert_ffn(x, token_for_slot, w_for_slot, wg, wu, wd, T, d, C, slot_of):
    """Gather -> batched expert products -> weighted fixed-order combine."""
    E_l = wg.shape[0]
    xe = _Dispatch.apply(x, token_for_slot, slot_of).reshape(E_l, C, d)
    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    ye = torch.bmm(h, wd).reshape(E_l * C, d)
    return _Combine.apply(ye * w_for_slot[:, None], slot_of, token_for_slot)


def moe_apply(p, x, cfg):
    """Single-shard path. x: (T, d) -> (y (T, d), aux_loss scalar)."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(T, cfg)
    topv, topi, aux = _route(p, x, cfg)
    token_for_slot, w_for_slot, slot_of = _dispatch_tables(topi, topv, T, k, C, 0, E,
                                                           x.dtype)
    y = _expert_ffn(x, token_for_slot, w_for_slot, p["wg"], p["wu"], p["wd"], T, d, C,
                    slot_of)
    if "shared_wg" in p:
        g = F.silu(x @ p["shared_wg"]) * (x @ p["shared_wu"])
        y = y + g @ p["shared_wd"]
    return y, aux


def _whole(p, device) -> dict:
    """``p`` with every :class:`Sharded` leaf gathered onto ``device``."""
    return {k: v.gather(device) if isinstance(v, Sharded) else v for k, v in p.items()}


def moe_apply_sharded(p, x, cfg):
    """The expert-parallel path under the active mesh (see the module's
    docstring).  x: (T, d), the GLOBAL flattened tokens, the dp shard r
    holding rows [r T / dp, (r + 1) T / dp).  Returns (y (T, d) on x's
    device, aux: the mean of the dp shards' load-balance losses)."""
    mesh = hints.active_mesh()
    if mesh is None:
        raise ValueError("moe_apply_sharded runs under a mesh: wrap the call in "
                         "parallel.hints.activate(mesh)")
    pod_axis = "pod" in mesh.axis_names
    npod = mesh.shape.get("pod", 1)
    msize = mesh.shape["model"]
    dsize = mesh.shape["data"]
    dp_size = npod * dsize
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    E_local = E // msize
    T_l = T // dp_size
    C = capacity(T_l, cfg)
    fsdp = cfg.fsdp and d % dsize == 0

    specs = {
        "router": P(None, None),
        "wg": P("model", "data", None) if fsdp else P("model", None, None),
        "wu": P("model", "data", None) if fsdp else P("model", None, None),
        "wd": P("model", None, "data") if fsdp else P("model", None, None),
    }
    if "shared_wg" in p:
        specs.update(shared_wg=P(None, "model"), shared_wu=P(None, "model"),
                     shared_wd=P("model", None))
    shardings = {n: NamedSharding(mesh, s) for n, s in specs.items()}
    # a leaf placed with this path's spec is used piece by piece; any other
    # is taken whole (gathered first if placed otherwise) and sliced a cell
    leaf = {}
    for n, sh in shardings.items():
        v = p[n]
        placed = isinstance(v, Sharded) and v.spec == sh.spec and v.mesh is mesh
        leaf[n] = v if placed or not isinstance(v, Sharded) else v.gather(x.device)

    def cell(pod, i, j):
        return (pod, i, j) if pod_axis else (i, j)

    def piece(name, c):
        v = leaf[name]
        if isinstance(v, Sharded):
            return v.piece(c)
        b = shardings[name].bounds(c, v.shape)
        return v[tuple(slice(*s) for s in b)].to(mesh.devices[c])

    # serve mode: when tokens-per-expert is tiny (decode), moving the expert
    # weights through FSDP gathers costs more than the tokens: gather the
    # pod's tokens over 'data', keep the weights where they are, contract
    # each member's d_model slice, and sum the small partial products
    T_g = T_l * dsize                       # tokens per pod row after the gather
    serve_mode = fsdp and (T_g * k) // max(E, 1) <= 64
    C_g = capacity(T_g, cfg)
    rows = [x[r * T_l:(r + 1) * T_l] for r in range(dp_size)]

    def serve_column(pod, j):
        """The serve mode's routed output of model column j of one pod:
        {data member i: (its T_l rows' partial y on its device, aux)}."""
        c0 = cell(pod, 0, j)
        dev0 = mesh.devices[c0]
        x_g = torch.cat([rows[pod * dsize + i].to(dev0) for i in range(dsize)])
        topv, topi, aux = _route({"router": piece("router", c0)}, x_g, cfg)
        tok, w, slot_of = _dispatch_tables(topi, topv, T_g, k, C_g, j * E_local, E_local,
                                           x_g.dtype)
        dloc = d // dsize
        xe = _Dispatch.apply(x_g, tok, slot_of).reshape(E_local, C_g, d)
        gh = uh = None
        for i in range(dsize):              # the psum over 'data', in cell order
            c = cell(pod, i, j)
            xg = xe[..., i * dloc:(i + 1) * dloc].to(mesh.devices[c])
            pg = torch.bmm(xg, piece("wg", c)).to(dev0)
            pu = torch.bmm(xg, piece("wu", c)).to(dev0)
            gh, uh = (pg, pu) if gh is None else (gh + pg, uh + pu)
        h = F.silu(gh) * uh
        y_parts = []
        for i in range(dsize):
            c = cell(pod, i, j)
            dev = mesh.devices[c]
            ye = torch.bmm(h.to(dev), piece("wd", c)).reshape(E_local * C_g, dloc)
            y_p = _Combine.apply(ye * w.to(dev)[:, None], slot_of.to(dev), tok.to(dev))
            y_parts.append(y_p.to(dev0))
        y_full = torch.cat(y_parts, dim=1)  # the all-gather over 'data' of d_model
        return {i: (y_full[i * T_l:(i + 1) * T_l].to(mesh.devices[cell(pod, i, j)]), aux)
                for i in range(dsize)}

    out, auxes = [], []
    for pod in range(npod):
        served = ([serve_column(pod, j) for j in range(msize)] if serve_mode else None)
        for i in range(dsize):
            r = pod * dsize + i
            y = aux_r = None
            for j in range(msize):
                c = cell(pod, i, j)
                dev = mesh.devices[c]
                x_l = rows[r].to(dev)
                if serve_mode:
                    y_c, aux = served[j][i]
                else:
                    wg, wu, wd = piece("wg", c), piece("wu", c), piece("wd", c)
                    if fsdp:                 # manual ZeRO-3: gather the experts at use
                        def gathered(name, axis):
                            return torch.cat([piece(name, cell(pod, i2, j)).to(dev)
                                              for i2 in range(dsize)], dim=axis)

                        wg, wu, wd = gathered("wg", 1), gathered("wu", 1), gathered("wd", 2)
                    topv, topi, aux = _route({"router": piece("router", c)}, x_l, cfg)
                    tok, w, slot_of = _dispatch_tables(topi, topv, T_l, k, C, j * E_local,
                                                       E_local, x_l.dtype)
                    y_c = _expert_ffn(x_l, tok, w, wg, wu, wd, T_l, d, C, slot_of)
                if "shared_wg" in p:
                    g = F.silu(x_l @ piece("shared_wg", c)) * (x_l @ piece("shared_wu", c))
                    y_c = y_c + g @ piece("shared_wd", c)   # partial over 'model'
                y_c = y_c.to(x.device)
                y = y_c if y is None else y + y_c           # the combining psum over 'model'
                if aux_r is None:
                    aux_r = aux.to(x.device)
            out.append(y)
            auxes.append(aux_r)
    return torch.cat(out), torch.mean(torch.stack(auxes))


def moe_dispatch(p, x, cfg):
    """The execution path: the expert-parallel ``moe_apply_sharded`` when
    a mesh is active, the expert count divides its 'model' axis and the
    tokens its dp size; ``moe_apply`` otherwise."""
    mesh = hints.active_mesh()
    if mesh is not None and cfg.n_experts % mesh.shape["model"] == 0:
        dp_size = int(np.prod([mesh.shape[a] for a in hints.dp_axes(mesh)]))
        if x.shape[0] % dp_size == 0:
            return moe_apply_sharded(p, x, cfg)
    return moe_apply(_whole(p, x.device), x, cfg)
