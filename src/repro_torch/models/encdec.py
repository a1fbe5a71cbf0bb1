"""Whisper-style encoder-decoder backbone, the audio family: the port of
``repro/models/encdec.py`` (``sinusoids``, ``init_params``, ``encode``,
``_decode_full``, ``loss_fn``, ``init_cache``, ``prefill`` and
``decode_step``).

The conv/mel frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings ``frames`` (B, enc_len, d).  Downstream: a
bidirectional encoder with fixed sinusoidal positions, a causal decoder
with learned positions (``dec_pos``) and cross-attention to the encoder's
output, LayerNorm with bias, 2-matrix GELU MLPs (tanh approximation), no
RoPE anywhere, and the tied embedding as the output head, its product in
the model dtype and cast to float32 after (arXiv:2212.04356).

The model is an ``nn.Module`` (:class:`EncDec`) holding the reference's
leaves under their names and orientations: ``tok_emb``, ``dec_pos``,
``enc_blocks.<l>`` (:class:`EncBlock`: ``ln1`` {w, b}, ``attn``, ``ln2``,
``mlp`` {w1, b1, w2, b2}), ``dec_blocks.<l>`` (:class:`DecBlock`: ``ln1``,
``self_attn``, ``ln2``, ``cross_attn``, ``ln3``, ``mlp``), ``ln_enc`` and
``ln_dec``; the LayerNorms float32.  The reference stacks the blocks and
scans over them; here a loop over the list does the same, each block under
``torch.utils.checkpoint`` in a train step with ``cfg.remat``.
:func:`repro_torch.models.lm.leaves`, ``leaf_paths``, ``ref_ndims`` and
``trainable`` take this model as they take an ``LM``.

Each block's residual input keeps the reference's sequence-parallel pin
(``parallel.hints.constrain`` under ``cfg.sp_residual`` in the loss's
``sp_scope``), which on the port's single controller returns its argument
itself.

The cache is the reference's: ``self_k`` / ``self_v`` (L, B, S, K, Dh),
written at ``pos`` in place by every :func:`decode_step`, and ``cross_k``
/ ``cross_v`` (L, B, enc_len, K, Dh), the encoder output's keys and
values, written once by :func:`prefill`.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..parallel import hints
from . import layers
from .config import ModelConfig
from .lm import _Block, _assemble, _dtype, _pdict, _remat, _shift, xent_chunked

__all__ = ["EncDec", "EncBlock", "DecBlock", "sinusoids", "init_params", "encode",
           "loss_fn", "init_cache", "prefill", "decode_step"]


class EncBlock(_Block):
    """One encoder block: ln1 {w, b}, attn, ln2 {w, b}, mlp (2-matrix)."""


class DecBlock(_Block):
    """One decoder block: ln1, self_attn, ln2, cross_attn (no bias), ln3,
    mlp."""


def _stacks(cfg: ModelConfig) -> list:
    """(name, block class, layers) of the two stacks, as
    :func:`repro_torch.models.lm._stacks` gives an LM's."""
    return [("enc_blocks", EncBlock, cfg.n_enc_layers), ("dec_blocks", DecBlock, cfg.n_layers)]


class EncDec(nn.Module):
    """Token embedding (also the head), learned decoder positions, the
    encoder and decoder stacks and their final LayerNorms, under the
    reference's leaf names.  ``stacks`` is {"enc_blocks", "dec_blocks": a
    ``ModuleList`` of blocks}; ``ln_enc`` / ``ln_dec`` are {"w", "b"}."""

    def __init__(self, cfg: ModelConfig, tok_emb, dec_pos, ln_enc, ln_dec, stacks):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Parameter(tok_emb, requires_grad=False)
        self.dec_pos = nn.Parameter(dec_pos, requires_grad=False)
        self.ln_enc, self.ln_dec = _pdict(ln_enc), _pdict(ln_dec)
        for name, module in stacks.items():
            setattr(self, name, module)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device


def _ln_init(d: int, device) -> dict:
    return {"w": torch.ones((d,), dtype=torch.float32, device=device),
            "b": torch.zeros((d,), dtype=torch.float32, device=device)}


def _ln(x, p, eps: float):
    return layers.layernorm(x, p["w"], p["b"], eps)


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's fixed sinusoidal positions (length, channels), float32:
    computed in numpy float64, then cast, as the reference does (a float32
    ``sin`` in torch would not round as it does on every host)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32))


@functools.lru_cache(maxsize=8)
def _sinusoids_on(length: int, channels: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    # one host-to-device copy per shape, never one a call (a CUDA graph
    # cannot capture a copy from pageable host memory)
    return sinusoids(length, channels).to(device=device, dtype=dtype)


def _block_init(gen: torch.Generator, cfg: ModelConfig, Block) -> _Block:
    dt, d, dev = _dtype(cfg), cfg.d_model, gen.device

    def mlp():
        return layers.mlp_init(gen, d, cfg.d_ff, dt, gated=False)

    if Block is EncBlock:
        return Block(ln1=_ln_init(d, dev), attn=layers.attn_init(gen, cfg, dt),
                     ln2=_ln_init(d, dev), mlp=mlp())
    return Block(ln1=_ln_init(d, dev), self_attn=layers.attn_init(gen, cfg, dt),
                 ln2=_ln_init(d, dev), cross_attn=layers.attn_init(gen, cfg, dt, cross=True),
                 ln3=_ln_init(d, dev), mlp=mlp())


def init_params(gen: Union[int, torch.Generator], cfg: ModelConfig,
                device: Optional[Union[str, torch.device]] = None) -> EncDec:
    """Random weights with the reference's distributions: ``tok_emb``
    N(0, 1) * 0.02 and ``dec_pos`` N(0, 1) * 0.01 drawn in float32 then
    cast, projections N(0, 1) / sqrt(d_in) (``wo`` / sqrt(H Dh), ``w2`` /
    sqrt(f)), biases 0, LayerNorms w 1 and b 0 (float32).  ``gen`` is a
    ``torch.Generator`` (its device is the model's) or a seed for one on
    ``device`` (default the card).  The numbers are not the reference's;
    the tests hand both packages the same weights through
    :func:`repro_torch.models.convert.lm_params_from_jax`."""
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=resolve_device(device)).manual_seed(int(gen))
    dt, dev = _dtype(cfg), gen.device

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
                * scale).to(dt)

    tok_emb = normal((cfg.vocab, cfg.d_model), 0.02)
    dec_pos = normal((cfg.max_seq, cfg.d_model), 0.01)
    stacks = {name: _assemble(n, lambda _, B=Block: _block_init(gen, cfg, B))
              for name, Block, n in _stacks(cfg)}
    return EncDec(cfg, tok_emb, dec_pos, _ln_init(cfg.d_model, dev),
                  _ln_init(cfg.d_model, dev), stacks)


# ---------------------------------------------------------------------------
# Encoder, decoder
# ---------------------------------------------------------------------------


def _run(body, blocks, x, cfg: ModelConfig, *args):
    """x through ``body(lp, x, cfg, *args)`` block by block, each under
    ``torch.utils.checkpoint`` in a train step with ``cfg.remat``."""
    for lp in blocks:
        if cfg.remat and _remat(x, lp):
            x = checkpoint(body, lp, x, cfg, *args, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = body(lp, x, cfg, *args)
    return x


def _sp_pin(h, cfg: ModelConfig):
    if cfg.sp_residual and hints.sp_enabled():
        h = hints.constrain(h, ("dp", "model", None))
    return h


def _enc_block(lp, h, cfg: ModelConfig):
    h = _sp_pin(h, cfg)
    eps = cfg.norm_eps
    h = h + layers.attn_apply(lp["attn"], _ln(h, lp["ln1"], eps), cfg, causal=False,
                              use_rope=False)
    return h + layers.mlp_apply(lp["mlp"], _ln(h, lp["ln2"], eps), "gelu")


def encode(params: EncDec, frames, cfg: ModelConfig):
    """frames (B, enc_len, d) (the stub frontend's output) -> (B, enc_len,
    d) in the model dtype: frames + sinusoids, both cast to it, through the
    bidirectional encoder, then ``ln_enc``."""
    dt = _dtype(cfg)
    x = frames.to(device=params.device, dtype=dt)
    x = x + _sinusoids_on(x.shape[1], cfg.d_model, dt, x.device)
    x = _run(_enc_block, params.enc_blocks, x, cfg)
    return _ln(x, params.ln_enc, cfg.norm_eps)


def _dec_block(lp, h, cfg: ModelConfig, enc_out, cache_out=None):
    """One decoder block over the sequence; ``cache_out`` (self k, self v,
    cross k, cross v of this layer), if given, receives its keys and
    values."""
    h = _sp_pin(h, cfg)
    eps = cfg.norm_eps
    a, (sk, sv) = layers.attn_apply(lp["self_attn"], _ln(h, lp["ln1"], eps), cfg,
                                    causal=True, use_rope=False, return_kv=True)
    h = h + a
    c, (ck, cv) = layers.attn_apply(lp["cross_attn"], _ln(h, lp["ln2"], eps), cfg,
                                    kv_x=enc_out, causal=False, use_rope=False,
                                    return_kv=True)
    h = h + c
    if cache_out is not None:
        for dst, src in zip(cache_out, (sk, sv, ck, cv)):
            dst[:, :src.shape[1]] = src.to(dst.dtype)
    return h + layers.mlp_apply(lp["mlp"], _ln(h, lp["ln3"], eps), "gelu")


def _decode_full(params: EncDec, tokens, enc_out, cfg: ModelConfig, cache=None):
    """The decoder over whole sequences (B, S): the tokens' embeddings plus
    ``dec_pos[:S]``, causal self-attention, cross-attention to
    ``enc_out``, then ``ln_dec``.  ``cache`` (from :func:`init_cache`), if
    given, receives every layer's self K/V at [0, S) and cross K/V (the
    reference's ``collect_kv``; no remat then, as there)."""
    dt = _dtype(cfg)
    tokens = tokens.to(params.device)
    S = tokens.shape[1]
    x = params.tok_emb[tokens].to(dt) + params.dec_pos[:S][None].to(dt)
    if cache is None:
        x = _run(_dec_block, params.dec_blocks, x, cfg, enc_out)
    else:
        keys = ("self_k", "self_v", "cross_k", "cross_v")
        for l, lp in enumerate(params.dec_blocks):
            x = _dec_block(lp, x, cfg, enc_out, [cache[k][l] for k in keys])
    return _ln(x, params.ln_dec, cfg.norm_eps)


def _logits(params: EncDec, h):
    # the tied head's product in the model dtype, then float32
    return (h @ params.tok_emb.T).to(torch.float32)


def loss_fn(params: EncDec, batch, cfg: ModelConfig):
    """Next-token loss of the decoder on batch {"frames": (B, enc_len, d),
    "tokens": (B, S)}: position t predicts token t + 1, the last position
    masked out; :func:`repro_torch.models.lm.xent_chunked` against the tied
    embedding.  Returns (loss, {"loss", "tokens"}) as the reference (no aux
    term)."""
    tokens = batch["tokens"].to(params.device)
    B, S = tokens.shape
    with hints.sp_scope(True):
        enc_out = encode(params, batch["frames"], cfg)
        h = _decode_full(params, tokens, enc_out, cfg)
    h = hints.constrain(h, ("dp", None, None))
    labels = _shift(tokens, tokens.dtype)
    mask = _shift(torch.ones((B, S), dtype=torch.float32, device=tokens.device),
                  torch.float32)
    loss_sum, count = xent_chunked(h, params.tok_emb, labels, mask, cfg.logits_chunk)
    loss = loss_sum / torch.clamp(count, min=1.0)
    return loss, {"loss": loss, "tokens": count}


# ---------------------------------------------------------------------------
# Cache, prefill, decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, B: int, S: int, device=None) -> dict:
    """Zeroed cache on ``device`` (default the card): ``self_k`` /
    ``self_v`` (L, B, S, K, Dh) and ``cross_k`` / ``cross_v`` (L, B,
    ``cfg.enc_len``, K, Dh) in the model dtype."""
    dev = resolve_device(device)
    L, K, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim

    def zeros(n):
        return torch.zeros((L, B, n, K, Dh), dtype=_dtype(cfg), device=dev)

    return {"self_k": zeros(S), "self_v": zeros(S),
            "cross_k": zeros(cfg.enc_len), "cross_v": zeros(cfg.enc_len)}


def prefill(params: EncDec, batch, cfg: ModelConfig, cache_len: Optional[int] = None):
    """Encode ``batch["frames"]`` and run the decoder over the prompt
    ``batch["tokens"]`` (B, S), building the cache (self K/V at [0, S) of a
    capacity ``cache_len``, default S; the cross K/V of every layer).
    Returns (last-token logits (B, vocab) float32, cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = init_cache(cfg, B, cache_len or S, device=params.device)
    enc_out = encode(params, batch["frames"], cfg)
    h = _decode_full(params, tokens, enc_out, cfg, cache=cache)
    return _logits(params, h[:, -1, :]), cache


def decode_step(params: EncDec, batch, cache, cfg: ModelConfig):
    """One decoder token, batch {"token": (B, 1) integer, "pos": int},
    against the cache: its embedding plus ``dec_pos[pos]``, each layer's
    self-attention writing ``self_k[l]`` / ``self_v[l]`` at ``pos`` in
    place, its cross-attention reading ``cross_k[l]`` / ``cross_v[l]``.
    Returns (logits (B, vocab) float32, cache)."""
    pos = int(batch["pos"])
    dt, eps = _dtype(cfg), cfg.norm_eps
    x = params.tok_emb[batch["token"].to(params.device)].to(dt)
    x = x + params.dec_pos[pos:pos + 1][None].to(dt)
    for l, lp in enumerate(params.dec_blocks):
        a, _, _ = layers.attn_decode(lp["self_attn"], _ln(x, lp["ln1"], eps), cfg,
                                     cache["self_k"][l], cache["self_v"][l], pos,
                                     use_rope=False)
        x = x + a
        c, _, _ = layers.attn_decode(lp["cross_attn"], _ln(x, lp["ln2"], eps), cfg,
                                     cache["cross_k"][l], cache["cross_v"][l], pos,
                                     cross=True)
        x = x + c
        x = x + layers.mlp_apply(lp["mlp"], _ln(x, lp["ln3"], eps), "gelu")
    h = _ln(x, params.ln_dec, eps)
    return _logits(params, h[:, 0, :]), cache
