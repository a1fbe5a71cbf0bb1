"""Step builders of the LM half (the port of ``repro/launch/steps.py``):
the prefill and decode steps ``launch/serve.py`` drives.  The train step
comes with A8's training part."""
from __future__ import annotations

from ..core.gp import _not_ported

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step"]


def make_train_step(model, ocfg=None):
    _not_ported("make_train_step", "LM half's training part (ROADMAP A8)")


def make_prefill_step(model, cache_len=None):
    def prefill_step(params, batch):
        return model.prefill(params, batch, cache_len=cache_len)

    return prefill_step


def make_decode_step(model):
    """The decode step writes the cache in place (the reference donates
    it: ``donate_argnums=(2,)``)."""
    def decode_step(params, batch, cache):
        return model.decode_step(params, batch, cache)

    return decode_step
