"""Decoder-only LM assembly, dense and MoE families: the port of the dense
and (non-MLA) MoE parts of ``repro/models/lm.py`` (``_dtype``, the
"dense" and "moe" blocks' init and apply, ``init_params``, ``forward``
with its per-block remat and its aux loss, ``_unembed``, ``xent_chunked``,
``loss_fn``, ``init_cache``, ``_dense_block_decode`` and
``_moe_block_decode`` (one ``_block_decode`` here), ``decode_step`` and
``prefill``).

The model is an ``nn.Module`` (:class:`LM`) holding a ``ModuleList`` of
:class:`DenseBlock` or :class:`MoEBlock`; every parameter keeps the
reference's leaf name (``tok_emb``, ``final_norm``, ``lm_head``,
``blocks.<l>.ln1``, ``blocks.<l>.attn.wq``, ``blocks.<l>.moe.wg`` ...) and
its orientation, and a block reads like the reference's parameter dict
(``lp["attn"]["wq"]``, ``lp["moe"]["router"]``).  An MoE block's FFN is
:func:`repro_torch.models.moe.moe_dispatch` over the block's (B * S, d)
tokens; its aux loss is summed over the layers in layer order, as the
reference's scan carries it.
The reference stacks the blocks (L, ...) and scans over them; here a loop
over the list does the same, and the cache is ``{"k", "v"}`` of shape
(L, B, S, K, Dh) as there.

``prefill`` fuses the reference's two passes (``forward`` for the logits,
then a second pass over the blocks for the cache): the second pass
recomputes the first's keys and values from the same inputs with the same
operations, so one pass that keeps them gives the same logits and cache.
``decode_step`` writes the cache in place (the reference donates it).

Training: the parameters are built with ``requires_grad=False``, so no
serving call records a graph; :func:`trainable` switches gradients on for
the length of a train step.  With ``cfg.remat`` and gradients on, each
block runs under ``torch.utils.checkpoint`` (the reference scans its
blocks under ``jax.checkpoint``), and :func:`xent_chunked` recomputes each
chunk's logits in the backward pass, so neither pass holds a (B, S, V)
tensor.  :func:`leaves` names the trainable tensors in the reference's
tree order.

MLA (with its MTP loss), SSM/hybrid, audio and VLM families come with A8's
later parts (``repro_torch.models`` refuses them).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import layers, moe
from .config import ModelConfig

__all__ = ["LM", "DenseBlock", "MoEBlock", "init_params", "forward", "prefill",
           "decode_step", "init_cache", "xent_chunked", "loss_fn", "leaves", "leaf_paths",
           "ref_ndims", "trainable"]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _pdict(tensors: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


class _Block(nn.Module):
    """ln1, attn, ln2 and the FFN (named ``FFN``) under the reference's
    names; ``block["attn"]`` reads like the reference's parameter dict."""

    FFN = ""

    def __init__(self, ln1, attn: dict, ln2, ffn: dict):
        super().__init__()
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.attn = _pdict(attn)
        self.ln2 = nn.Parameter(ln2, requires_grad=False)
        setattr(self, self.FFN, _pdict(ffn))

    def __getitem__(self, name: str):
        return getattr(self, name)


class DenseBlock(_Block):
    """One "dense" block: ln1, attn, ln2, mlp."""

    FFN = "mlp"


class MoEBlock(_Block):
    """One "moe" block: ln1, attn, ln2, moe (``router`` float32, ``wg``,
    ``wu``, ``wd`` stacked over experts, ``shared_w*`` with shared
    experts)."""

    FFN = "moe"


def _block_type(cfg: ModelConfig):
    """The block class of ``cfg``'s family; raises for the families that
    ``lm`` does not build."""
    if cfg.family == "dense":
        return DenseBlock
    if cfg.family == "moe" and not cfg.use_mla:
        return MoEBlock
    raise ValueError(f"lm builds the dense family and the moe family without MLA, not "
                     f"{cfg.arch_id!r} (family {cfg.family!r}, use_mla={cfg.use_mla})")


class LM(nn.Module):
    """Token embedding, a list of blocks, the final norm and (untied)
    the LM head; parameters under the reference's leaf names."""

    def __init__(self, cfg: ModelConfig, tok_emb, final_norm, blocks, lm_head=None):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Parameter(tok_emb, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        if lm_head is not None:
            self.lm_head = nn.Parameter(lm_head, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device


def _block_init(gen: torch.Generator, cfg: ModelConfig) -> _Block:
    dt = _dtype(cfg)
    d = cfg.d_model
    Block = _block_type(cfg)
    attn = layers.attn_init(gen, cfg, dt)
    ffn = (moe.moe_init(gen, cfg, dt) if Block is MoEBlock
           else layers.mlp_init(gen, d, cfg.d_ff, dt, gated=cfg.mlp_gated))
    return Block(layers.norm_init(d, device=gen.device), attn,
                 layers.norm_init(d, device=gen.device), ffn)


def init_params(gen: Union[int, torch.Generator], cfg: ModelConfig,
                device: Optional[Union[str, torch.device]] = None) -> LM:
    """Random weights with the reference's distributions: ``tok_emb`` (and
    an untied ``lm_head``) N(0, 1) * 0.02 drawn in float32 then cast,
    projections N(0, 1) / sqrt(d_in) (``wo`` / sqrt(H Dh), ``wd`` and ``w2``
    / sqrt(f)), biases 0, norms 1; an MoE block's FFN as
    :func:`repro_torch.models.moe.moe_init` draws it.  ``gen`` is a
    ``torch.Generator`` (its device is the model's) or a seed for one on
    ``device`` (default the card; ``"cpu"`` for the tests).  The numbers are
    not the reference's (``jax.random`` draws others); the tests hand both
    packages the same weights through :func:`repro_torch.models.convert`."""
    _block_type(cfg)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=resolve_device(device)).manual_seed(int(gen))
    dt = _dtype(cfg)

    def emb():
        w = torch.randn((cfg.vocab, cfg.d_model), generator=gen, dtype=torch.float32,
                        device=gen.device)
        return (w * 0.02).to(dt)

    tok_emb = emb()
    lm_head = None if cfg.tie_embeddings else emb()
    blocks = [_block_init(gen, cfg) for _ in range(cfg.n_layers)]
    return LM(cfg, tok_emb, layers.norm_init(cfg.d_model, device=gen.device), blocks,
              lm_head)


# ---------------------------------------------------------------------------
# Forward, prefill, decode
# ---------------------------------------------------------------------------


def _ffn(lp, h, cfg: ModelConfig):
    """The block's FFN on (B, S, d): (y, aux); aux is None for a dense
    block."""
    if isinstance(lp, MoEBlock):
        B, S, d = h.shape
        y, aux = moe.moe_dispatch(lp["moe"], h.reshape(B * S, d), cfg)
        return y.reshape(B, S, d), aux
    return layers.mlp_apply(lp["mlp"], h, cfg.act), None


def _block_apply(lp, x, cfg: ModelConfig, kv_out=None):
    """Full-sequence block: (x, aux), aux None for a dense block;
    ``kv_out`` (k, v) cache slices of this layer, if given, receive the
    block's keys and values."""
    a, (k, v) = layers.attn_apply(lp["attn"], layers.rmsnorm(x, lp["ln1"], cfg.norm_eps),
                                  cfg, return_kv=True)
    if kv_out is not None:
        S = k.shape[1]
        kv_out[0][:, :S] = k.to(kv_out[0].dtype)
        kv_out[1][:, :S] = v.to(kv_out[1].dtype)
    x = x + a
    y, aux = _ffn(lp, layers.rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg)
    return x + y, aux


def _embed(params: LM, tokens, cfg: ModelConfig):
    return params.tok_emb[tokens.to(params.device)].to(_dtype(cfg))


def _remat(x, lp) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or lp.ln1.requires_grad)


def forward(params: LM, batch, cfg: ModelConfig, *, cache=None):
    """Token inputs -> final hidden states (B, S, d), aux loss (float32;
    the MoE blocks' aux summed in layer order, 0 for the dense family).
    ``cache`` (from :func:`init_cache`), if given, receives every layer's
    keys and values at positions [0, S).  With ``cfg.remat`` and gradients
    on (a train step), each block's activations are recomputed in the
    backward pass."""
    x = _embed(params, batch["tokens"], cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l, lp in enumerate(params.blocks):
        if cache is None and cfg.remat and _remat(x, lp):
            x, a = checkpoint(_block_apply, lp, x, cfg, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            kv = None if cache is None else (cache["k"][l], cache["v"][l])
            x, a = _block_apply(lp, x, cfg, kv)
        if a is not None:
            aux = aux + a
    return layers.rmsnorm(x, params.final_norm, cfg.norm_eps), aux


def _unembed(params: LM, cfg: ModelConfig):
    return params.tok_emb if cfg.tie_embeddings else params.lm_head


def _logits(params: LM, h, cfg: ModelConfig):
    # in the model dtype, then cast: the reference's product is not f32
    return (h @ _unembed(params, cfg).T).to(torch.float32)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _xent_chunk(hc, emb_out, lc, mc):
    # the logits in the model dtype, then float32, as the reference's
    logits = (hc @ emb_out.T).to(torch.float32)              # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    return torch.sum((lse - gold) * mc), torch.sum(mc)


def xent_chunked(h, emb_out, labels, mask, chunk: int):
    """Chunked softmax cross-entropy over the sequence axis: ``logsumexp -
    gold`` per chunk of ``chunk`` positions, summed in chunk order, then
    the remainder chunk when S is no multiple of ``chunk``.  Never holds a
    (B, S, V) logits tensor: with gradients on, each whole chunk runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so
    the backward pass recomputes its logits; the remainder, as in the
    reference, keeps its own.  Returns (sum_loss, sum_count), float32."""
    B, S, d = h.shape
    chunk = min(chunk, S)
    nch = S // chunk
    rem = S - nch * chunk
    remat = torch.is_grad_enabled() and (h.requires_grad or emb_out.requires_grad)
    loss = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nch):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (h[:, sl], emb_out, labels[:, sl], mask[:, sl])
        if remat:
            dl, dc = checkpoint(_xent_chunk, *args, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            dl, dc = _xent_chunk(*args)
        loss, count = loss + dl, count + dc
    if rem:
        sl = slice(nch * chunk, S)
        dl, dc = _xent_chunk(h[:, sl], emb_out, labels[:, sl], mask[:, sl])
        loss, count = loss + dl, count + dc
    return loss, count


def loss_fn(params: LM, batch, cfg: ModelConfig):
    """Next-token LM loss (teacher forcing) on batch {"tokens": (B, S)}:
    position t predicts token t + 1, the last position masked out.
    Returns (loss, {"loss", "aux", "tokens"}) as the reference; ``aux`` is
    the MoE blocks' load-balance loss (0 for the dense family), added to
    the loss.  Gradients flow to the parameters inside
    :func:`trainable`."""
    tokens = batch["tokens"].to(params.device)
    B, S = tokens.shape
    labels = torch.cat([tokens[:, 1:], torch.zeros((B, 1), dtype=tokens.dtype,
                                                   device=tokens.device)], dim=1)
    mask = torch.cat([torch.ones((B, S - 1), dtype=torch.float32, device=tokens.device),
                      torch.zeros((B, 1), dtype=torch.float32, device=tokens.device)], dim=1)
    h, aux = forward(params, {**batch, "tokens": tokens}, cfg)
    loss_sum, count = xent_chunked(h, _unembed(params, cfg), labels, mask, cfg.logits_chunk)
    loss = loss_sum / torch.clamp(count, min=1.0)
    loss = loss + aux
    return loss, {"loss": loss, "aux": aux, "tokens": count}


# ---------------------------------------------------------------------------
# Trainable leaves
# ---------------------------------------------------------------------------


def leaf_paths(params: LM) -> list:
    """``(name, path, layer)`` for every parameter, in the reference's tree
    order (``jax.tree_util`` sorts dict keys; a block leaf is stacked over
    layers there, so its layers follow one another here): ``name`` is the
    module's parameter name (``blocks.3.attn.wq``), ``path`` the
    reference's key path (``("blocks", "attn", "wq")``), ``layer`` the
    block's index (None outside the blocks)."""
    out = []
    if len(params.blocks):
        b0 = params.blocks[0]
        for sub in sorted(("attn", "ln1", "ln2", b0.FFN)):
            keys = sorted(b0[sub].keys()) if isinstance(b0[sub], nn.ParameterDict) else [None]
            for k in keys:
                path = ("blocks", sub) if k is None else ("blocks", sub, k)
                for l in range(len(params.blocks)):
                    out.append((".".join(("blocks", str(l)) + path[1:]), path, l))
    for top in ("final_norm", "lm_head", "tok_emb"):
        if hasattr(params, top):
            out.append((top, (top,), None))
    return out


def leaves(params: LM) -> Dict[str, torch.Tensor]:
    """{name: parameter} in :func:`leaf_paths`' order: the dict the
    optimizer steps (``optim.init(leaves(params), ocfg)``), whose global
    norm sums the leaves in the reference's order, a block leaf layer by
    layer."""
    named = dict(params.named_parameters())
    return {name: named[name] for name, _, _ in leaf_paths(params)}


def ref_ndims(params: LM) -> Dict[str, int]:
    """{name: the leaf's rank in the reference's tree}: a block leaf is
    stacked (L, ...) there, one rank more than its layer's tensor here."""
    named = dict(params.named_parameters())
    return {name: named[name].ndim + (layer is not None)
            for name, _, layer in leaf_paths(params)}


@contextlib.contextmanager
def trainable(params: LM):
    """Gradients on every parameter inside the block, off again after it
    (each back to what it was), so serving never records a graph."""
    ps = list(params.parameters())
    was = [p.requires_grad for p in ps]
    for p in ps:
        p.requires_grad_(True)
    try:
        yield params
    finally:
        for p, w in zip(ps, was):
            p.requires_grad_(w)


def init_cache(cfg: ModelConfig, B: int, S: int, device=None) -> dict:
    """Zeroed cache for a context capacity of S tokens, on ``device``
    (default the card); the same {"k", "v"} for both families."""
    _block_type(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev)}


def _block_decode(p, x, cfg: ModelConfig, ck, cv, pos: int):
    """One block's step, the reference's ``_dense_block_decode`` and
    ``_moe_block_decode``: an MoE block's FFN routes the step's B tokens
    (capacity for B tokens: 8 slots an expert at a small batch), its aux
    dropped."""
    a, ck, cv = layers.attn_decode(p["attn"], layers.rmsnorm(x, p["ln1"], cfg.norm_eps),
                                   cfg, ck, cv, pos)
    x = x + a
    y, _ = _ffn(p, layers.rmsnorm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + y, ck, cv


def decode_step(params: LM, batch, cache, cfg: ModelConfig):
    """One serve step: batch {'token': (B, 1) integer, 'pos': int}.  Writes
    the cache at ``pos`` in place and returns (logits (B, vocab) float32,
    cache)."""
    pos = int(batch["pos"])
    x = _embed(params, batch["token"], cfg)
    for l, lp in enumerate(params.blocks):
        x, _, _ = _block_decode(lp, x, cfg, cache["k"][l], cache["v"][l], pos)
    h = layers.rmsnorm(x, params.final_norm, cfg.norm_eps)
    return _logits(params, h[:, 0, :], cfg), cache


def prefill(params: LM, batch, cfg: ModelConfig, cache_len: Optional[int] = None):
    """Forward over the prompt, building the decode cache (capacity
    ``cache_len``, default the prompt's length; positions past the prompt
    stay 0).  Returns (last-token logits (B, vocab) float32, cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = init_cache(cfg, B, cache_len or S, device=params.device)
    h, _ = forward(params, batch, cfg, cache=cache)
    return _logits(params, h[:, -1, :], cfg), cache
