"""The JAX package's LM parameters as the port's: ``lm_params_from_jax``
takes the reference's ``init_params`` pytree with its leaves as numpy
arrays (``jax.tree.map(np.asarray, params)``; the blocks stacked (L, ...)
over layers, bfloat16 leaves as ``ml_dtypes`` arrays) and returns the
port's :class:`~repro_torch.models.lm.LM` holding the same values, so that
the tests hand both packages one set of weights.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..device import resolve_device
from .config import ModelConfig
from .lm import LM, DenseBlock, _dtype

__all__ = ["lm_params_from_jax"]


def _t(a, dtype, device) -> torch.Tensor:
    # float32 holds every bfloat16 value exactly, so the cast back is exact
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy()).to(
        device=device, dtype=dtype)


def lm_params_from_jax(tree: Mapping, cfg: ModelConfig, device=None) -> LM:
    """The dense family's parameters on ``device`` (default the card):
    weights and biases in the model dtype, norms in float32, as the
    reference keeps them."""
    if cfg.family != "dense" or cfg.use_mla:
        raise ValueError(f"lm_params_from_jax converts the dense family, not {cfg.family!r}")
    device = resolve_device(device)
    dt = _dtype(cfg)
    f32 = torch.float32
    bl = tree["blocks"]
    blocks = [
        DenseBlock(_t(bl["ln1"][l], f32, device),
                   {k: _t(v[l], dt, device) for k, v in bl["attn"].items()},
                   _t(bl["ln2"][l], f32, device),
                   {k: _t(v[l], dt, device) for k, v in bl["mlp"].items()})
        for l in range(cfg.n_layers)
    ]
    head = None if cfg.tie_embeddings else _t(tree["lm_head"], dt, device)
    return LM(cfg, _t(tree["tok_emb"], dt, device), _t(tree["final_norm"], f32, device),
              blocks, head)
