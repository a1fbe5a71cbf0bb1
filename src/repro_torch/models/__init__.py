"""Model zoo of the port: the LM half's layer library and, so far, its
dense family (qwen2-1.5b, qwen2.5-3b, smollm-360m, starcoder2-3b), its
MoE family, without MLA (olmoe-1b-7b) and with MLA and MTP (deepseek-v3),
its SSM family (mamba2-130m) and its hybrid family (zamba2-7b).

``get_model(cfg)`` gives the reference's uniform API (``init_params``,
``loss_fn``, ``prefill``, ``decode_step``, ``init_cache``, ``cfg``).  What
is not ported yet raises ``UnsupportedError`` naming ROADMAP A8: the audio
and vlm families.
"""
from types import SimpleNamespace

from ..core.gp import _not_ported
from . import config, layers, lm, mla, moe, ssm
from .config import ModelConfig

__all__ = ["ModelConfig", "get_model", "config", "layers", "lm", "mla", "moe", "ssm"]


def get_model(cfg: ModelConfig) -> SimpleNamespace:
    """Family dispatch.  ``init_params(gen, device=None)`` takes a
    ``torch.Generator`` or a seed (see :func:`lm.init_params`); ``loss_fn``,
    ``prefill``, ``decode_step`` and ``init_cache(B, S, device=None)`` are
    those of :mod:`repro_torch.models.lm`; ``device`` defaults to the
    card."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        _not_ported(f"get_model({cfg.arch_id!r}, family={cfg.family!r})",
                    f"LM half's {cfg.family} part (ROADMAP A8)")

    return SimpleNamespace(
        init_params=lambda gen, device=None: lm.init_params(gen, cfg, device),
        loss_fn=lambda params, batch: lm.loss_fn(params, batch, cfg),
        prefill=lambda params, batch, cache_len=None: lm.prefill(
            params, batch, cfg, cache_len=cache_len),
        decode_step=lambda params, batch, cache: lm.decode_step(params, batch, cache, cfg),
        init_cache=lambda B, S, device=None: lm.init_cache(cfg, B, S, device),
        cfg=cfg,
    )
