"""Model zoo of the port: the LM half's layer library and its families:
dense (qwen2-1.5b, qwen2.5-3b, smollm-360m, starcoder2-3b), MoE without
MLA (olmoe-1b-7b) and with MLA and MTP (deepseek-v3), SSM (mamba2-130m),
hybrid (zamba2-7b), VLM (llama-3.2-vision-11b, in :mod:`.lm`) and audio
(whisper-small, the encoder-decoder of :mod:`.encdec`).

``get_model(cfg)`` gives the reference's uniform API (``init_params``,
``loss_fn``, ``prefill``, ``decode_step``, ``init_cache``, ``cfg``),
dispatching the audio family to :mod:`.encdec` and every other to
:mod:`.lm`, as the reference does.
"""
from types import SimpleNamespace

from . import config, encdec, layers, lm, mla, moe, ssm
from .config import ModelConfig

__all__ = ["ModelConfig", "get_model", "config", "encdec", "layers", "lm", "mla", "moe", "ssm"]


def get_model(cfg: ModelConfig) -> SimpleNamespace:
    """Family dispatch.  ``init_params(gen, device=None)`` takes a
    ``torch.Generator`` or a seed (see :func:`lm.init_params`); ``loss_fn``,
    ``prefill``, ``decode_step`` and ``init_cache(B, S, device=None)`` are
    those of :mod:`repro_torch.models.encdec` for the audio family and of
    :mod:`repro_torch.models.lm` for the others; ``device`` defaults to the
    card."""
    mod = encdec if cfg.family == "audio" else lm
    return SimpleNamespace(
        init_params=lambda gen, device=None: mod.init_params(gen, cfg, device),
        loss_fn=lambda params, batch: mod.loss_fn(params, batch, cfg),
        prefill=lambda params, batch, cache_len=None: mod.prefill(
            params, batch, cfg, cache_len=cache_len),
        decode_step=lambda params, batch, cache: mod.decode_step(params, batch, cache, cfg),
        init_cache=lambda B, S, device=None: mod.init_cache(cfg, B, S, device),
        cfg=cfg,
    )
