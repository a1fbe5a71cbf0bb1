"""Step builders of the LM half (the port of ``repro/launch/steps.py``):
the train step ``launch/train.py`` drives and the prefill and decode
steps ``launch/serve.py`` drives."""
from __future__ import annotations

import torch

from .. import optim
from ..models import lm

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step"]


def make_train_step(model, ocfg: optim.AdamWConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients (``model.loss_fn`` with
    gradients on, :func:`repro_torch.models.lm.trainable`), then one AdamW
    step written into the parameters and ``opt_state`` in place (the
    reference donates both: ``donate_argnums=(0, 1)``), so no second copy
    of the model is ever whole.  ``opt_state`` is
    ``optim.init(lm.leaves(params), ocfg)``; ``metrics`` holds the loss's
    (``loss``, ``aux``, ``tokens``) and the optimizer's (``grad_norm``,
    ``lr``).  Weight decay falls on the leaves of rank >= 2 in the
    reference's tree, where a block's leaves are stacked over layers: its
    norms and biases are decayed too, the final norm and the MTP head's two
    norms are not."""
    def train_step(params, opt_state, batch):
        named = lm.leaves(params)
        with lm.trainable(params):
            loss, metrics = model.loss_fn(params, batch)
            grads = torch.autograd.grad(loss, list(named.values()))
        om = optim.apply_updates_(named, dict(zip(named, grads)), opt_state, ocfg,
                                  ndims=lm.ref_ndims(params))
        del grads
        return params, opt_state, {**{k: v.detach() for k, v in metrics.items()}, **om}

    return train_step


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
