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

``moe_apply_sharded``, the expert-parallel path under a production mesh,
comes with ``parallel/`` (ROADMAP A8); without a mesh ``moe_dispatch`` is
``moe_apply``, as in the reference when no mesh is active.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.gp import _not_ported
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


def moe_apply_sharded(p, x, cfg):
    """The expert-parallel path under a production mesh: not ported yet."""
    _not_ported("moe_apply_sharded", "LM half's parallel/ part (ROADMAP A8)")


def moe_dispatch(p, x, cfg):
    """The execution path: ``moe_apply`` (the port has no production mesh
    yet, so the reference's expert-parallel branch never applies)."""
    return moe_apply(p, x, cfg)
