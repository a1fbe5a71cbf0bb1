"""The LM's parameters between the two packages' layouts.

``lm_params_from_jax`` takes the reference's ``init_params`` pytree with
its leaves as numpy arrays (``jax.tree.map(np.asarray, params)``; the
blocks stacked (L, ...) over layers in each stack, ``blocks`` for the
dense, MoE and SSM families, ``dense_blocks``, ``moe_blocks`` and
``mtp_blocks`` beside ``mtp_proj``, ``mtp_norm_h`` and ``mtp_norm_e`` for
MLA, ``mamba_groups`` stacked (G, L, ...) and ``mamba_tail`` beside the
unstacked ``shared_attn`` for the hybrid, ``cross_blocks`` (G, ...) and
``self_groups`` (G, cross_every, ...) for the VLM, ``enc_blocks`` and
``dec_blocks`` beside ``dec_pos``, ``ln_enc`` and ``ln_dec`` for the
audio family; bfloat16 leaves as ``ml_dtypes`` arrays) and returns the
port's :class:`~repro_torch.models.lm.LM` (for the audio family its
:class:`~repro_torch.models.encdec.EncDec`) holding the same values, so
that the tests hand both packages one set of weights.

The reverse: ``lm_params_to_jax`` gives the port's parameters as the
reference's nested numpy tree (float32 arrays holding the values exactly,
each stack restacked (L, ...) or (G, L, ...)),
and ``train_state_to_jax`` the parameters and AdamW state as the
reference's train-loop checkpoint tree, ``{"params": ..., "opt": {"mu":
..., "step"}}`` (``mu`` mirroring the parameters with ``{"m", "v"}``
leaves), as host tensors in their own dtypes for
:mod:`repro_torch.checkpoint`.  ``load_train_state`` writes such a tree,
read from either package's checkpoint, back into the model and the AdamW
state in place.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..device import resolve_device
from .config import ModelConfig
from . import encdec
from .lm import LM, MTP_TOP, _assemble, _dtype, _stacks, leaf_paths

__all__ = ["lm_params_from_jax", "lm_params_to_jax", "train_state_to_jax",
           "train_state_keys", "load_train_state"]


def _t(a, dtype, device) -> torch.Tensor:
    # float32 holds every bfloat16 value exactly, so the cast back is exact
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy()).to(
        device=device, dtype=dtype)


# leaves the reference keeps in float32 whatever the model dtype (``w`` and
# ``b``: a LayerNorm's)
F32_LEAVES = ("ln1", "ln2", "final_norm", "router", "q_ln", "kv_ln", "mtp_norm_h",
              "mtp_norm_e", "A_log", "D", "dt_bias", "norm_w", "gate_attn", "gate_mlp",
              "w", "b")


def lm_params_from_jax(tree: Mapping, cfg: ModelConfig, device=None) -> LM:
    """The dense, MoE, MLA, SSM or hybrid family's parameters on ``device``
    (default the card): weights and biases in the model dtype, the norms
    (an MLA block's ``q_ln`` and ``kv_ln``, the MTP head's two and a mamba
    block's ``norm_w`` among them), the MoE router and a mamba block's
    ``A_log``, ``D`` and ``dt_bias`` in float32, as the reference keeps
    them; each stack of the tree (``blocks``; ``dense_blocks``,
    ``moe_blocks`` and ``mtp_blocks``; ``mamba_groups`` (G, L, ...) and
    ``mamba_tail``; ``cross_blocks`` and ``self_groups`` (G, cross_every,
    ...); ``enc_blocks`` and ``dec_blocks``) unstacked into its layers, the
    hybrid's ``shared_attn`` taken as it is, an MoE block's expert leaves
    still stacked (E, ...) over experts; a cross block's gates and every
    LayerNorm's ``w`` and ``b`` float32."""
    device = resolve_device(device)
    dt = _dtype(cfg)

    def leaf(name, a):
        return _t(a, torch.float32 if name in F32_LEAVES else dt, device)

    def block(Block, bl, idx):
        def at(a):
            return a if idx is None else a[idx]
        return Block(**{sub: ({k: leaf(k, at(v)) for k, v in node.items()}
                              if isinstance(node, Mapping) else leaf(sub, at(node)))
                        for sub, node in bl.items()})

    audio = cfg.family == "audio"
    stacks = {name: _assemble(n, lambda idx, B=Block, bl=tree[name]: block(B, bl, idx))
              for name, Block, n in (encdec._stacks if audio else _stacks)(cfg)}
    if audio:
        def ln(name):
            return {k: leaf(k, v) for k, v in tree[name].items()}

        return encdec.EncDec(cfg, leaf("tok_emb", tree["tok_emb"]),
                             leaf("dec_pos", tree["dec_pos"]), ln("ln_enc"), ln("ln_dec"),
                             stacks)
    top = {k: leaf(k, tree[k]) for k in MTP_TOP if k in tree}
    head = None if cfg.tie_embeddings else leaf("lm_head", tree["lm_head"])
    return LM(cfg, leaf("tok_emb", tree["tok_emb"]), leaf("final_norm", tree["final_norm"]),
              stacks, head, **top)


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _stacked(params: LM, leaf) -> dict:
    """{reference path: leaf(tensors, lead)} where ``tensors`` are a block
    leaf's layers in order and ``lead`` the reference's stacked leading
    shape ((L,) or (G, L)), or the one tensor of a leaf outside the stacks
    (or of the hybrid's shared block) and None."""
    named = dict(params.named_parameters())
    groups: dict = {}
    for name, path, layer in leaf_paths(params):
        groups.setdefault(path, []).append((named[name], layer))

    def lead(layers):
        if layers[0] is None:
            return None
        return tuple(int(i) + 1 for i in np.max(np.array(layers).reshape(len(layers), -1), 0))

    return {path: leaf([t for t, _ in ts], lead([l for _, l in ts]))
            for path, ts in groups.items()}


def _host(ts, lead, of=lambda t: t) -> torch.Tensor:
    # a fresh host copy (``.to`` copies a card tensor; ``copy=True`` a CPU one)
    if lead is not None:
        return torch.stack([of(t).detach().to("cpu") for t in ts]).reshape(
            lead + tuple(ts[0].shape))
    return of(ts[0]).detach().to("cpu", copy=True)


def lm_params_to_jax(params: LM) -> dict:
    """The reference's ``init_params`` tree of the port's parameters (an
    :class:`LM` or an :class:`~repro_torch.models.encdec.EncDec`): numpy
    float32 arrays (every bfloat16 value exactly), the blocks stacked
    (L, ...) or (G, L, ...); cast each leaf to the reference's dtype to feed
    JAX."""
    return _nest(_stacked(params, lambda ts, lead: _host(ts, lead).to(torch.float32).numpy()))


def train_state_to_jax(params: LM, opt_state: dict) -> dict:
    """The reference train loop's checkpoint tree of the port's model and
    AdamW state (``optim.init(lm.leaves(params), ...)``): every leaf a
    fresh host tensor in its own dtype, the blocks stacked (L, ...) or
    (G, L, ...).  The
    copies from the card have finished when this returns."""
    mu = opt_state["mu"]
    names = {id(p): n for n, p in params.named_parameters()}

    def moment(key):
        return lambda ts, lead: _host(ts, lead, of=lambda t: mu[names[id(t)]][key])

    m = _stacked(params, moment("m"))
    v = _stacked(params, moment("v"))
    return {"params": _nest(_stacked(params, _host)),
            "opt": {"mu": _nest({path + (k,): src[path] for path in m
                                 for k, src in (("m", m), ("v", v))}),
                    "step": opt_state["step"].detach().to("cpu", copy=True)}}


def train_state_keys(params: LM) -> dict:
    """The keys of :func:`train_state_to_jax`'s tree with placeholder
    leaves: the ``like`` that ``checkpoint.restore`` reads, without copying
    the model."""
    paths = list(_stacked(params, lambda ts, lead: 0))
    return {"params": _nest({p: 0 for p in paths}),
            "opt": {"mu": _nest({p + (k,): 0 for p in paths for k in ("m", "v")}),
                    "step": 0}}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@torch.no_grad()
def load_train_state(params: LM, opt_state: dict, tree: Mapping) -> None:
    """Write a train-loop checkpoint tree (``{"params", "opt"}`` in the
    reference's layout, written by either package) into ``params`` and
    ``opt_state`` in place, layer by layer (a (G, L, ...) leaf at [g, l]),
    each leaf cast to the dtype it has here."""
    named = dict(params.named_parameters())
    for name, path, layer in leaf_paths(params):
        def src(t):
            return t if layer is None else t[layer]
        named[name].copy_(src(torch.as_tensor(_at(tree["params"], path))))
        for k in ("m", "v"):
            opt_state["mu"][name][k].copy_(
                src(torch.as_tensor(_at(tree["opt"]["mu"], path + (k,)))))
    opt_state["step"].copy_(torch.as_tensor(tree["opt"]["step"]))
