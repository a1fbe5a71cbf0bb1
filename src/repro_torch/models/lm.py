"""Decoder-only LM assembly, every family but audio (that is
:mod:`repro_torch.models.encdec`): dense, MoE, MLA, SSM, hybrid and VLM,
the port of ``repro/models/lm.py`` (``_dtype``, the "dense", "moe",
"mla_dense", "mla_moe", "mamba" and "cross" blocks' init and apply,
``init_params``, ``forward`` with its per-block remat and its aux
loss, ``_unembed``, ``xent_chunked``, ``loss_fn`` with the MLA family's
MTP term, ``init_cache``, ``_dense_block_decode``, ``_moe_block_decode``,
``_mla_block_decode`` and ``_mamba_block_decode`` (one ``_block_decode``
here), ``decode_step``, ``prefill`` and ``_ssm_prefill_cache``).

The model is an ``nn.Module`` (:class:`LM`) holding the reference's
stacks as ``ModuleList``\\ s of blocks: ``blocks`` (:class:`DenseBlock`,
:class:`MoEBlock` or :class:`MambaBlock`) for the dense, MoE and SSM
families; ``dense_blocks`` (:class:`MLADenseBlock`, the first
``moe_layer_start`` layers), ``moe_blocks`` (:class:`MLAMoEBlock`, the
rest) and, with ``cfg.mtp_depth``, ``mtp_blocks`` (:class:`MLAMoEBlock`)
beside ``mtp_proj``, ``mtp_norm_h`` and ``mtp_norm_e`` for the MLA family
(deepseek-v3); for the hybrid family (zamba2) ``mamba_groups``, G
``ModuleList``\\ s of L :class:`MambaBlock`\\ s (stacked (G, L, ...) in the
reference), ``shared_attn``, **one** :class:`DenseBlock` that runs before
every group, and ``mamba_tail``; for the VLM family (llama-3.2-vision)
``cross_blocks``, G :class:`CrossBlock`\\ s, and ``self_groups``, G
``ModuleList``\\ s of ``cross_every`` :class:`DenseBlock`\\ s (stacked (G,
...) and (G, cross_every, ...) in the reference), G = ``n_layers //
(cross_every + 1)``: each group runs its cross block, which attends to the
batch's image embeddings ``img`` (B, T, d) without RoPE and scales its
attention and MLP by tanh of its float32 gates, then its self blocks
(RoPE at ``rope_theta``).  Every parameter keeps the reference's
leaf name (``tok_emb``, ``final_norm``, ``lm_head``, ``blocks.<l>.attn.wq``,
``moe_blocks.<l>.moe.wg``, ``mamba_groups.<g>.<l>.ssm.A_log``,
``shared_attn.mlp.wg`` ...) and its orientation, and a block reads like
the reference's parameter dict (``lp["attn"]["wq"]``, ``lp["ssm"]["D"]``).
An MoE block's FFN is :func:`repro_torch.models.moe.moe_dispatch` over the
block's (B * S, d) tokens; its aux loss is summed over the layers in layer
order, a stack at a time, as the reference's scans carry it.  An MLA
block's attention is :mod:`repro_torch.models.mla`: the expanded form over
a sequence, the absorbed form for a decode step.  A mamba block is
:mod:`repro_torch.models.ssm`'s.  The reference stacks the blocks and
scans over them; here a loop over the list does the same.  The cache is
the reference's: ``{"k", "v"}`` of shape (L, B, S, K, Dh); for MLA
``{"latent_dense", "latent_moe"}`` of shape (layers, B, S, kv_lora +
rope); for SSM ``{"conv_x", "conv_BC", "ssm"}`` of shapes (L, B, K - 1,
d_inner), (L, B, K - 1, 2 g n) and (L, B, h, p, n), whatever the context;
for the hybrid ``attn_k`` / ``attn_v`` (G, B, S, K, Dh), one a shared
invocation, the three mamba entries (G, L, ...) and their ``*_tail``
twins (T, ...); for the VLM ``k`` / ``v`` (G, cross_every, B, S, K, Dh)
and ``img_k`` / ``img_v`` (G, B, T, K, Dh), the image's written once by
the prefill.

``prefill`` fuses the reference's two passes (``forward`` for the logits,
then a second pass over the blocks for the cache): the second pass
recomputes the first's keys and values (a mamba block's raw projections
and SSD state) from the same inputs with the same operations, so one pass
that keeps them gives the same logits and cache (an MLA block writes
``mla_prefill_cache`` of its normed input, a mamba block the last K - 1
rows of its raw x and BC projections and SSD's final state, as the
reference's second pass does).  ``decode_step`` writes the cache in place
(the reference donates it).

Training: the parameters are built with ``requires_grad=False``, so no
serving call records a graph; :func:`trainable` switches gradients on for
the length of a train step.  With ``cfg.remat`` and gradients on, each
block runs under ``torch.utils.checkpoint`` (the reference scans its
blocks under ``jax.checkpoint``), the MTP blocks and the hybrid's shared
block too, and :func:`xent_chunked` recomputes each chunk's logits in the
backward pass, so neither pass holds a (B, S, V) tensor.  :func:`leaves`
names the trainable tensors in the reference's tree order.

The reference's sequence-parallel pins stand where it has them
(``parallel.hints.constrain`` of the embeddings, of a mamba block's input
under ``cfg.ssm_seq_parallel``, of each block's residual input under
``cfg.sp_residual`` in a train step's ``sp_scope``, and of the loss's
hidden states); on the port's single controller a pin returns its
argument itself, so no value changes under a mesh.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..parallel import hints
from . import layers, mla, moe, ssm
from .config import ModelConfig

__all__ = ["LM", "DenseBlock", "MoEBlock", "MLADenseBlock", "MLAMoEBlock", "MambaBlock",
           "CrossBlock", "vlm_groups", "init_params",
           "forward", "prefill", "decode_step", "init_cache", "xent_chunked", "loss_fn",
           "leaves", "leaf_paths", "ref_ndims", "trainable"]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _pdict(tensors: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


class _Block(nn.Module):
    """A block's leaves under the reference's names (``ln1``, ``attn``,
    ``ln2`` and the FFN, named ``FFN``; or ``ln1`` and ``ssm``), each given
    as a tensor or a dict of tensors; ``block["attn"]`` reads like the
    reference's parameter dict.  ``MLA``: the attention is
    :mod:`repro_torch.models.mla`'s; ``SSM``: a mamba block."""

    FFN = ""
    MLA = False
    SSM = False
    CROSS = False

    def __init__(self, **leaves):
        super().__init__()
        for name, v in leaves.items():
            setattr(self, name, _pdict(v) if isinstance(v, dict)
                    else nn.Parameter(v, requires_grad=False))

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


class MLADenseBlock(_Block):
    """One "mla_dense" block: ln1, attn (``wq_a``, ``q_ln``, ``wq_b``,
    ``wkv_a``, ``kv_ln``, ``wkv_b``, ``wo``; the norms float32), ln2, mlp
    (gated)."""

    FFN = "mlp"
    MLA = True


class MLAMoEBlock(_Block):
    """One "mla_moe" block: ln1, attn (MLA), ln2, moe."""

    FFN = "moe"
    MLA = True


class MambaBlock(_Block):
    """One "mamba" block: ln1, ssm (``in_z``, ``in_x``, ``in_BC``,
    ``in_dt``, the two convs' weights and biases, ``out_proj``; ``A_log``,
    ``D``, ``dt_bias`` and ``norm_w`` float32)."""

    SSM = True


class CrossBlock(_Block):
    """One "cross" block of the VLM family: ln1, attn (cross-attention to
    the image embeddings: no bias, no RoPE), gate_attn (1,) float32, ln2,
    mlp (gated), gate_mlp (1,) float32; each branch scaled by tanh of its
    gate, both 0 at init."""

    FFN = "mlp"
    CROSS = True


def _stacks(cfg: ModelConfig) -> list:
    """(name, block class, layers) of each stack of ``cfg``'s family, in the
    reference's init order: ``layers`` is a count, (G, L) for the hybrid's
    groups and the VLM's ``self_groups`` (G, cross_every), or None for the
    hybrid's one shared block; ``mtp_blocks`` (run by the loss only) last.
    Raises for the families that ``lm`` does not build (the audio family is
    :mod:`repro_torch.models.encdec`'s)."""
    if cfg.family == "dense":
        return [("blocks", DenseBlock, cfg.n_layers)]
    if cfg.family == "moe" and not cfg.use_mla:
        return [("blocks", MoEBlock, cfg.n_layers)]
    if cfg.family == "moe":
        nd = cfg.moe_layer_start
        out = [("dense_blocks", MLADenseBlock, nd),
               ("moe_blocks", MLAMoEBlock, cfg.n_layers - nd)]
        if cfg.mtp_depth:
            out.append(("mtp_blocks", MLAMoEBlock, cfg.mtp_depth))
        return out
    if cfg.family == "ssm":
        return [("blocks", MambaBlock, cfg.n_layers)]
    if cfg.family == "hybrid":
        out = [("mamba_groups", MambaBlock, (cfg.hybrid_groups, cfg.hybrid_group_len)),
               ("shared_attn", DenseBlock, None)]
        if cfg.hybrid_tail:
            out.append(("mamba_tail", MambaBlock, cfg.hybrid_tail))
        return out
    if cfg.family == "vlm":
        G = vlm_groups(cfg)
        return [("cross_blocks", CrossBlock, G), ("self_groups", DenseBlock, (G, cfg.cross_every))]
    raise ValueError(f"lm builds the dense, moe (with or without MLA), ssm, hybrid and vlm "
                     f"families, not {cfg.arch_id!r} (family {cfg.family!r})")


def vlm_groups(cfg: ModelConfig) -> int:
    """The VLM family's G groups, each one cross block then ``cross_every``
    self blocks (the reference's ``n_layers // (cross_every + 1)``)."""
    return cfg.n_layers // (cfg.cross_every + 1)


def _assemble(layers_, make) -> nn.Module:
    """A stack's module from ``make(index)``: the one block (``layers_``
    None, index None), a ``ModuleList`` of ``layers_`` blocks (index l), or
    of G ``ModuleList``\\ s of L (``layers_`` (G, L), index (g, l))."""
    if layers_ is None:
        return make(None)
    if isinstance(layers_, tuple):
        G, L = layers_
        return nn.ModuleList(nn.ModuleList(make((g, l)) for l in range(L)) for g in range(G))
    return nn.ModuleList(make(l) for l in range(layers_))


# the stacks forward runs, in order, and the cache entries each one's
# layers write: k and v, or the MLA latent (a mamba stack writes MAMBA_CACHE)
_CACHE = {"blocks": ("k", "v"), "dense_blocks": ("latent_dense",),
          "moe_blocks": ("latent_moe",)}
MAMBA_CACHE = ("conv_x", "conv_BC", "ssm")
# the MTP head's leaves outside its blocks
MTP_TOP = ("mtp_proj", "mtp_norm_h", "mtp_norm_e")


class LM(nn.Module):
    """Token embedding, the stacks of blocks, the final norm, (untied) the
    LM head and (MLA with MTP) the MTP head; parameters under the
    reference's leaf names.  ``stacks`` is {stack name: its module, as
    :func:`_assemble` builds it}; ``top`` holds the MTP head's
    ``mtp_proj``, ``mtp_norm_h`` and ``mtp_norm_e``."""

    def __init__(self, cfg: ModelConfig, tok_emb, final_norm, stacks, lm_head=None, **top):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Parameter(tok_emb, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        if lm_head is not None:
            self.lm_head = nn.Parameter(lm_head, requires_grad=False)
        for name, t in top.items():
            setattr(self, name, nn.Parameter(t, requires_grad=False))
        for name, module in stacks.items():
            setattr(self, name, module)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device


def _segments(params: LM, cache=None) -> list:
    """(blocks, cache entries) of each run of blocks ``forward`` takes, in
    order: a stack; for the hybrid family the shared block before each
    group, the group, then the tail; for the VLM family each group's cross
    block, then its self blocks.  The entries are the cache tensors whose
    leading axis follows the run's blocks (None without a cache): the
    shared block's run at group g reads ``attn_k[g:g + 1]``, the cross
    block's ``img_k[g:g + 1]``."""
    def entries(keys, at=slice(None)):
        return None if cache is None else [cache[k][at] for k in keys]

    if hasattr(params, "cross_blocks"):
        out = []
        for g, (cross, group) in enumerate(zip(params.cross_blocks, params.self_groups)):
            out.append(([cross], entries(("img_k", "img_v"), slice(g, g + 1))))
            out.append((group, entries(("k", "v"), g)))
        return out
    if hasattr(params, "shared_attn"):
        out = []
        for g, group in enumerate(params.mamba_groups):
            out.append(([params.shared_attn], entries(("attn_k", "attn_v"), slice(g, g + 1))))
            out.append((group, entries(MAMBA_CACHE, g)))
        if hasattr(params, "mamba_tail"):
            out.append((params.mamba_tail, entries(tuple(k + "_tail" for k in MAMBA_CACHE))))
        return out
    return [(blocks, entries(MAMBA_CACHE if blocks[0].SSM else _CACHE[name]))
            for name, blocks in ((n, getattr(params, n)) for n in _CACHE if hasattr(params, n))]


def _block_init(gen: torch.Generator, cfg: ModelConfig, Block) -> _Block:
    dt = _dtype(cfg)
    d = cfg.d_model

    def ln():
        return layers.norm_init(d, device=gen.device)

    if Block.SSM:
        return Block(ln1=ln(), ssm=ssm.mamba_init(gen, cfg, dt))
    if Block.CROSS:
        def gate():
            return torch.zeros((1,), dtype=torch.float32, device=gen.device)

        return Block(ln1=ln(), attn=layers.attn_init(gen, cfg, dt, cross=True),
                     gate_attn=gate(), ln2=ln(), mlp=layers.mlp_init(gen, d, cfg.d_ff, dt),
                     gate_mlp=gate())
    attn = mla.mla_init(gen, cfg, dt) if Block.MLA else layers.attn_init(gen, cfg, dt)
    if Block.FFN == "moe":
        ffn = moe.moe_init(gen, cfg, dt)
    else:        # the reference's mla_dense MLP is gated whatever cfg.mlp_gated
        ffn = layers.mlp_init(gen, d, cfg.d_ff, dt, gated=cfg.mlp_gated or Block.MLA)
    return Block(ln1=ln(), attn=attn, ln2=ln(), **{Block.FFN: ffn})


def init_params(gen: Union[int, torch.Generator], cfg: ModelConfig,
                device: Optional[Union[str, torch.device]] = None) -> LM:
    """Random weights with the reference's distributions: ``tok_emb`` (and
    an untied ``lm_head``) N(0, 1) * 0.02 drawn in float32 then cast,
    projections N(0, 1) / sqrt(d_in) (``wo`` / sqrt(H Dh) or, MLA, /
    sqrt(H dv), ``wd`` and ``w2`` / sqrt(f)), biases 0, norms 1; an MoE
    block's FFN as :func:`repro_torch.models.moe.moe_init` draws it, an MLA
    block's attention as :func:`repro_torch.models.mla.mla_init`, a mamba
    block's leaves as :func:`repro_torch.models.ssm.mamba_init`, a cross
    block's gates 0 (float32, shape (1,)) and its MLP gated; with
    ``cfg.mtp_depth`` the MTP head (``mtp_proj`` (2d, d), two norms,
    ``mtp_depth`` "mla_moe" blocks).  ``gen`` is a ``torch.Generator`` (its
    device is the model's) or a seed for one on ``device`` (default the
    card; ``"cpu"`` for the tests).  The numbers are not the reference's
    (``jax.random`` draws others); the tests hand both packages the same
    weights through :func:`repro_torch.models.convert`."""
    specs = _stacks(cfg)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=resolve_device(device)).manual_seed(int(gen))
    dt = _dtype(cfg)
    dev = gen.device

    def emb():
        w = torch.randn((cfg.vocab, cfg.d_model), generator=gen, dtype=torch.float32,
                        device=dev)
        return (w * 0.02).to(dt)

    tok_emb = emb()
    lm_head = None if cfg.tie_embeddings else emb()
    stacks = {name: _assemble(n, lambda _, B=Block: _block_init(gen, cfg, B))
              for name, Block, n in specs}
    top = {}
    if "mtp_blocks" in stacks:
        top = {"mtp_proj": layers.dense_init(gen, 2 * cfg.d_model, cfg.d_model, dt),
               "mtp_norm_h": layers.norm_init(cfg.d_model, device=dev),
               "mtp_norm_e": layers.norm_init(cfg.d_model, device=dev)}
    return LM(cfg, tok_emb, layers.norm_init(cfg.d_model, device=dev), stacks, lm_head,
              **top)


# ---------------------------------------------------------------------------
# Forward, prefill, decode
# ---------------------------------------------------------------------------


def _ffn(lp, h, cfg: ModelConfig):
    """The block's FFN on (B, S, d): (y, aux); aux is None for a dense
    block."""
    if lp.FFN == "moe":
        B, S, d = h.shape
        y, aux = moe.moe_dispatch(lp["moe"], h.reshape(B * S, d), cfg)
        return y.reshape(B, S, d), aux
    return layers.mlp_apply(lp["mlp"], h, cfg.act), None


def _gated(gate, y):
    # tanh of the float32 gate, cast to the activation dtype, then the product
    return torch.tanh(gate).to(y.dtype) * y


def _block_apply(lp, x, cfg: ModelConfig, cache_out=None, img=None):
    """Full-sequence block: (x, aux), aux None for a block without MoE;
    ``cache_out``, this layer's cache slices (k and v, the MLA latent, or a
    mamba block's two conv windows and SSM state; a cross block's image K/V),
    if given, receive the block's keys and values (its latents; the states a
    decode continues from).  A cross block attends to ``img`` (B, T, d)."""
    if (lp.SSM and cfg.ssm_seq_parallel and x.ndim == 3
            and (cfg.family == "ssm" or hints.sp_enabled())):
        # sequence-parallel SSM: per-token work shards over 'model' on the
        # sequence axis (the hybrid scopes it to training, ssm._ssm_mode)
        x = hints.constrain(x, ("dp", "model", None))
    h = layers.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if lp.SSM:
        if cache_out is None:
            return x + ssm.mamba_apply(lp["ssm"], h, cfg), None
        y, *states = ssm.mamba_prefill(lp["ssm"], h, cfg)
        for dst, src in zip(cache_out, states):
            dst.copy_(src)
        return x + y, None
    if lp.MLA:
        a = mla.mla_apply(lp["attn"], h, cfg)
        new = () if cache_out is None else (mla.mla_prefill_cache(lp["attn"], h, cfg),)
    elif lp.CROSS:
        a, new = layers.attn_apply(lp["attn"], h, cfg, kv_x=img, causal=False,
                                   use_rope=False, return_kv=True)
    else:
        a, new = layers.attn_apply(lp["attn"], h, cfg, return_kv=True)
    if cache_out is not None:
        for dst, src in zip(cache_out, new):
            dst[:, :src.shape[1]] = src.to(dst.dtype)
    if lp.CROSS:
        x = x + _gated(lp["gate_attn"], a)
        h = layers.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        return x + _gated(lp["gate_mlp"], layers.mlp_apply(lp["mlp"], h, cfg.act)), None
    x = x + a
    y, aux = _ffn(lp, layers.rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg)
    return x + y, aux


def _embed(params: LM, tokens, cfg: ModelConfig):
    return params.tok_emb[tokens.to(params.device)].to(_dtype(cfg))


def _remat(x, lp) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad
                                        or next(lp.parameters()).requires_grad)


def _run_stack(blocks, x, cfg: ModelConfig, cache_entries=None, img=None):
    """x through one stack: (x, the stack's aux summed in layer order from
    0, as the reference's scan carries it).  ``cache_entries``: the
    stack's cache tensors (L, B, ...), layer l's written at [l]; ``img``:
    what a cross block attends to."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kw = {} if img is None else {"img": img}
    for l, lp in enumerate(blocks):
        if cfg.sp_residual and hints.sp_enabled() and x.ndim == 3:
            # the saved-for-backward residual stack, sequence-sharded
            x = hints.constrain(x, ("dp", "model", None))
        if cache_entries is None and cfg.remat and _remat(x, lp):
            x, a = checkpoint(_block_apply, lp, x, cfg, None, use_reentrant=False,
                              preserve_rng_state=False, **kw)
        else:
            x, a = _block_apply(lp, x, cfg,
                                None if cache_entries is None else [c[l] for c in cache_entries],
                                **kw)
        if a is not None:
            aux = aux + a
    return x, aux


def _img(params: LM, batch, cfg: ModelConfig):
    """The VLM family's image embeddings (B, T, d) in the model dtype on the
    model's device; None for the other families."""
    if cfg.family != "vlm":
        return None
    return batch["img"].to(device=params.device, dtype=_dtype(cfg))


def forward(params: LM, batch, cfg: ModelConfig, *, cache=None):
    """Token (+ image, ``batch["img"]`` (B, T, d) for the VLM family)
    inputs -> final hidden states (B, S, d), aux loss (float32; the MoE
    blocks' aux summed in layer order, a stack at a time, 0 for the other
    families).  ``cache`` (from :func:`init_cache`), if given, receives
    every layer's keys and values (MLA: latents) at positions [0, S), every
    mamba layer's conv windows and SSM state, and every cross block's image
    K/V.  With ``cfg.remat`` and gradients on (a train step), each block's
    activations are recomputed in the backward pass."""
    x = hints.constrain(_embed(params, batch["tokens"], cfg), ("dp", None, None))
    img = _img(params, batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blocks, entries in _segments(params, cache):
        x, a = _run_stack(blocks, x, cfg, entries, img)
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


def _shift(t, fill_dtype):
    """t (B, S) one position to the left, a zero column appended."""
    return torch.cat([t[:, 1:], torch.zeros((t.shape[0], 1), dtype=fill_dtype,
                                            device=t.device)], dim=1)


def loss_fn(params: LM, batch, cfg: ModelConfig):
    """Next-token LM loss (teacher forcing) on batch {"tokens": (B, S)}:
    position t predicts token t + 1, the last position masked out.  With
    MLA and ``cfg.mtp_depth``, the reference's depth-1 multi-token
    prediction: [rmsnorm(h_t) ; rmsnorm(emb(t + 1))] @ ``mtp_proj`` through
    the MTP blocks predicts token t + 2, its loss added at 0.1 and its
    blocks' aux to the aux.  Returns (loss, {"loss", "aux", "tokens"}) as
    the reference; ``aux`` is the MoE blocks' load-balance loss (0 for the
    dense family), added to the loss.  Gradients flow to the parameters
    inside :func:`trainable`."""
    tokens = batch["tokens"].to(params.device)
    B, S = tokens.shape
    labels = _shift(tokens, tokens.dtype)
    mask = _shift(torch.ones((B, S), dtype=torch.float32, device=tokens.device),
                  torch.float32)
    with hints.sp_scope(True):
        h, aux = forward(params, {**batch, "tokens": tokens}, cfg)
    h = hints.constrain(h, ("dp", None, None))
    emb_out = _unembed(params, cfg)
    loss_sum, count = xent_chunked(h, emb_out, labels, mask, cfg.logits_chunk)
    loss = loss_sum / torch.clamp(count, min=1.0)

    if cfg.use_mla and cfg.mtp_depth and hasattr(params, "mtp_blocks"):
        emb_next = params.tok_emb[labels].to(h.dtype)
        cat = torch.cat([layers.rmsnorm(h, params.mtp_norm_h, cfg.norm_eps),
                         layers.rmsnorm(emb_next, params.mtp_norm_e, cfg.norm_eps)], dim=-1)
        hm, a = _run_stack(params.mtp_blocks, cat @ params.mtp_proj, cfg)
        aux = aux + a
        l2, c2 = xent_chunked(hm, emb_out, _shift(labels, labels.dtype),
                              _shift(mask, torch.float32), cfg.logits_chunk)
        loss = loss + 0.1 * l2 / torch.clamp(c2, min=1.0)

    loss = loss + aux
    return loss, {"loss": loss, "aux": aux, "tokens": count}


# ---------------------------------------------------------------------------
# Trainable leaves
# ---------------------------------------------------------------------------


def _indexed_blocks(module) -> list:
    """[(index, block)] of a stack in order: its one block (index None),
    each block of a ``ModuleList`` (l), or of a list of groups ((g, l))."""
    if isinstance(module, _Block):
        return [(None, module)]
    out = []
    for i, m in enumerate(module):
        if isinstance(m, nn.ModuleList):
            out += [((i, l), b) for l, b in enumerate(m)]
        else:
            out.append((i, m))
    return out


def leaf_paths(params: nn.Module) -> list:
    """``(name, path, layer)`` for every parameter of an :class:`LM` or an
    :class:`~repro_torch.models.encdec.EncDec`, in the reference's tree
    order (``jax.tree_util`` sorts dict keys, upper case first, so the
    stacks and the leaves outside them interleave by name: ``dense_blocks``,
    ``final_norm``, ``lm_head``, ``moe_blocks``, ``mtp_blocks``,
    ``mtp_norm_e`` ...; or ``final_norm``, ``lm_head``, ``mamba_groups``,
    ``mamba_tail``, ``shared_attn``, ``tok_emb``; or ``cross_blocks``,
    ``final_norm``, ``lm_head``, ``self_groups``, ``tok_emb``; or
    ``dec_blocks``, ``dec_pos``, ``enc_blocks``, ``ln_dec``, ``ln_enc``,
    ``tok_emb``; a block leaf is stacked over layers there, so its layers
    follow one another here, g-major for the hybrid's and the VLM's
    groups): ``name`` is the module's parameter name
    (``blocks.3.attn.wq``, ``mamba_groups.1.0.ssm.A_log``,
    ``enc_blocks.0.ln1.b``), ``path`` the reference's key path
    (``("blocks", "attn", "wq")``), ``layer`` the block's index in its
    stack: l, (g, l) in the groups, None outside the stacks and for the
    hybrid's shared block, which is not stacked."""
    stacks = dict(params.named_children())
    out = []
    for top in sorted(list(stacks) + [n for n, _ in params.named_parameters(recurse=False)]):
        if top not in stacks:
            out.append((top, (top,), None))
            continue
        if isinstance(stacks[top], nn.ParameterDict):      # a LayerNorm's w and b
            out += [(f"{top}.{k}", (top, k), None) for k in sorted(stacks[top].keys())]
            continue
        blocks = _indexed_blocks(stacks[top])
        if not blocks:
            continue
        b0 = blocks[0][1]
        subs = [n for n, _ in b0.named_parameters(recurse=False)] + [
            n for n, _ in b0.named_children()]
        for sub in sorted(subs):
            keys = sorted(b0[sub].keys()) if isinstance(b0[sub], nn.ParameterDict) else [None]
            for k in keys:
                path = (top, sub) if k is None else (top, sub, k)
                for idx, _ in blocks:
                    at = () if idx is None else tuple(map(str, np.atleast_1d(idx)))
                    out.append((".".join((top,) + at + path[1:]), path, idx))
    return out


def leaves(params: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: parameter} in :func:`leaf_paths`' order: the dict the
    optimizer steps (``optim.init(leaves(params), ocfg)``), whose global
    norm sums the leaves in the reference's order, a block leaf layer by
    layer."""
    named = dict(params.named_parameters())
    return {name: named[name] for name, _, _ in leaf_paths(params)}


def ref_ndims(params: nn.Module) -> Dict[str, int]:
    """{name: the leaf's rank in the reference's tree}: a block leaf is
    stacked (L, ...) there, one rank more than its layer's tensor here, two
    in the hybrid's and the VLM's (G, L, ...) groups, none in the hybrid's
    shared block (so AdamW decays a stacked ``q_ln``, ``A_log``, cross
    block ``gate_attn`` (G, 1) or encoder LayerNorm ``b`` (L, d), not
    ``mtp_norm_h``, ``ln_enc`` or the shared block's ``ln1``)."""
    named = dict(params.named_parameters())
    return {name: named[name].ndim + len(np.atleast_1d(layer) if layer is not None else ())
            for name, _, layer in leaf_paths(params)}


@contextlib.contextmanager
def trainable(params: nn.Module):
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
    (default the card): {"k", "v"} (L, B, S, K, Dh) for the dense and MoE
    families, {"latent_dense", "latent_moe"} (layers, B, S, kv_lora +
    rope) for MLA, {"conv_x", "conv_BC", "ssm"} (L, B, K - 1, d_inner),
    (L, B, K - 1, 2 g n), (L, B, h, p, n) for SSM (no S); for the hybrid
    "attn_k" / "attn_v" (G, B, S, K, Dh), the three mamba entries (G, L,
    B, ...) and, with a tail, "conv_x_tail", "conv_BC_tail", "ssm_tail"
    (T, B, ...); for the VLM "k" / "v" (G, cross_every, B, S, K, Dh) and
    "img_k" / "img_v" (G, B, ``cfg.n_img_tokens``, K, Dh)."""
    specs = dict((name, n) for name, _, n in _stacks(cfg))
    dev = resolve_device(device)
    dt = _dtype(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    if cfg.use_mla:
        shape = (B, S, cfg.kv_lora_rank + cfg.qk_rope_dim)
        return {_CACHE[name][0]: zeros(specs[name], *shape)
                for name in ("dense_blocks", "moe_blocks")}
    if cfg.family in ("ssm", "hybrid"):
        Kc, gn2 = cfg.ssm_conv - 1, 2 * cfg.ssm_ngroups * cfg.ssm_state

        def mamba(*lead):
            return dict(zip(MAMBA_CACHE, (
                zeros(*lead, B, Kc, cfg.d_inner), zeros(*lead, B, Kc, gn2),
                zeros(*lead, B, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state))))

        if cfg.family == "ssm":
            return mamba(cfg.n_layers)
        G = cfg.hybrid_groups
        kv = (G, B, S, cfg.n_kv_heads, cfg.head_dim)
        out = {"attn_k": zeros(*kv), "attn_v": zeros(*kv),
               **mamba(G, cfg.hybrid_group_len)}
        if cfg.hybrid_tail:
            out.update({k + "_tail": v for k, v in mamba(cfg.hybrid_tail).items()})
        return out
    K, Dh = cfg.n_kv_heads, cfg.head_dim
    if cfg.family == "vlm":
        G = vlm_groups(cfg)
        img = (G, B, cfg.n_img_tokens, K, Dh)
        kv = (G, cfg.cross_every, B, S, K, Dh)
        return {"k": zeros(*kv), "v": zeros(*kv), "img_k": zeros(*img), "img_v": zeros(*img)}
    shape = (cfg.n_layers, B, S, K, Dh)
    return {"k": zeros(*shape), "v": zeros(*shape)}


def _block_decode(p, x, cfg: ModelConfig, cache_slices, pos: int):
    """One block's step, the reference's ``_dense_block_decode``,
    ``_moe_block_decode``, ``_mla_block_decode`` and
    ``_mamba_block_decode``, and the VLM's cross block (its image K/V
    read, never written): writes the layer's cache slices (k and v, or
    the latent, at ``pos``; a mamba block's conv windows and SSM state) in
    place; an MoE block's FFN routes the step's B tokens (capacity for B
    tokens: 8 slots an expert at a small batch), its aux dropped."""
    h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if p.SSM:
        return x + ssm.mamba_decode(p["ssm"], h, cfg, *cache_slices)[0]
    if p.MLA:
        a, _ = mla.mla_decode(p["attn"], h, cfg, cache_slices[0], pos)
    else:
        a, _, _ = layers.attn_decode(p["attn"], h, cfg, *cache_slices, pos, cross=p.CROSS)
    if p.CROSS:
        x = x + _gated(p["gate_attn"], a)
        h = layers.rmsnorm(x, p["ln2"], cfg.norm_eps)
        return x + _gated(p["gate_mlp"], layers.mlp_apply(p["mlp"], h, cfg.act))
    x = x + a
    y, _ = _ffn(p, layers.rmsnorm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + y


def decode_step(params: LM, batch, cache, cfg: ModelConfig):
    """One serve step: batch {'token': (B, 1) integer, 'pos': int}.  Writes
    the cache in place (at ``pos`` for attention; the hybrid's shared
    block at group g into ``attn_k[g]`` / ``attn_v[g]``; the VLM's self
    blocks into ``k[g, l]`` / ``v[g, l]``, its cross blocks reading the
    image K/V the prefill wrote) and returns (logits (B, vocab) float32,
    cache)."""
    pos = int(batch["pos"])
    x = _embed(params, batch["token"], cfg)
    for blocks, entries in _segments(params, cache):
        for l, lp in enumerate(blocks):
            x = _block_decode(lp, x, cfg, [c[l] for c in entries], pos)
    h = layers.rmsnorm(x, params.final_norm, cfg.norm_eps)
    return _logits(params, h[:, 0, :], cfg), cache


def prefill(params: LM, batch, cfg: ModelConfig, cache_len: Optional[int] = None):
    """Forward over the prompt (and, for the VLM family, ``batch["img"]``),
    building the decode cache (capacity ``cache_len``, default the prompt's
    length; positions past the prompt stay 0; the SSM states hold no
    positions; the VLM's image K/V written once, here).  Returns (last-token logits
    (B, vocab) float32, cache).  A mamba layer's conv window is the
    prompt's last ``ssm_conv - 1`` raw projections, so an SSM or hybrid
    prompt shorter than that raises ``ValueError``
    (:func:`repro_torch.models.ssm.mamba_prefill`; the reference has no
    cache for it either)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = init_cache(cfg, B, cache_len or S, device=params.device)
    h, _ = forward(params, batch, cfg, cache=cache)
    return _logits(params, h[:, -1, :], cfg), cache
