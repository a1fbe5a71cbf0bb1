"""AdamW as plain functions on dicts of tensors.

Counterpart of ``repro/optim/adamw.py``, with its defaults (b2 = 0.95,
eps = 1e-8), its global-norm clipping, its bias correction
``(m / c1) / (sqrt(v / c2) + eps)`` in that order, decoupled weight decay
(on leaves of ndim >= 2 unless ``decay_mask`` says otherwise), an optional
moment dtype, and one step counter shared by every leaf.  Every operation
is elementwise per leaf, so a stack of independent lanes steps each lane
exactly as a stack of one would (``gp_hyperopt`` relies on this, and on
selecting frozen lanes' moments afterwards, which ``torch.optim.AdamW``
cannot carry).

    state = init(params, cfg)
    params, state, metrics = apply_updates(params, grads, state, cfg)
    metrics = apply_updates_(params, grads, state, cfg)   # in place

A clipped bfloat16 gradient is scaled in float32, as the reference's
``g * scale`` promotes it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

__all__ = ["AdamWConfig", "init", "apply_updates", "apply_updates_", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: Optional[torch.dtype] = None   # None -> the parameter's dtype
    # predicate(leaf) -> apply weight decay?  default: ndim >= 2
    decay_mask: Optional[Callable] = None


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree.values()))


def init(params: dict, cfg: AdamWConfig) -> dict:
    def make(p):
        dt = cfg.state_dtype or p.dtype
        return {"m": torch.zeros(p.shape, dtype=dt, device=p.device),
                "v": torch.zeros(p.shape, dtype=dt, device=p.device)}

    device = next(iter(params.values())).device
    return {"mu": {k: make(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    lr = cfg.lr(step) if callable(cfg.lr) else cfg.lr
    return torch.as_tensor(lr, dtype=torch.float32, device=step.device)


def _prepare(grads: dict, state: dict, cfg: AdamWConfig, gnorm=None):
    """The step's shared scalars: (step, grad norm (``gnorm`` where given),
    clip scale or None, lr, c1, c2)."""
    step = state["step"] + 1
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = _lr_at(cfg, step)
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=step.device), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=step.device), stepf)
    return step, gnorm, scale, lr, c1, c2


def _decay(p, ndim: int, cfg: AdamWConfig) -> float:
    """The leaf's weight decay: on rank >= 2 unless ``decay_mask`` says."""
    if cfg.decay_mask is not None:
        return cfg.weight_decay if cfg.decay_mask(p) else 0.0
    return cfg.weight_decay if ndim >= 2 else 0.0


def _leaf(p, g, s, scale, lr, c1, c2, cfg: AdamWConfig, decay: float):
    """One leaf's (new p, new m, new v) in their dtypes."""
    if scale is not None:
        # the reference's g * scale promotes a bfloat16 g to float32
        g = g.to(torch.promote_types(g.dtype, scale.dtype)) * scale
    g32 = g.to(torch.float32)
    m = s["m"].to(torch.float32) * cfg.b1 + g32 * (1.0 - cfg.b1)
    v = s["v"].to(torch.float32) * cfg.b2 + torch.square(g32) * (1.0 - cfg.b2)
    upd = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
    p32 = p.to(torch.float32)
    sd = s["m"].dtype
    return (p32 - lr * (upd + decay * p32)).to(p.dtype), m.to(sd), v.to(sd)


def apply_updates(params: dict, grads: dict, state: dict, cfg: AdamWConfig):
    """One AdamW step.  Returns (new_params, new_state, metrics)."""
    step, gnorm, scale, lr, c1, c2 = _prepare(grads, state, cfg)
    new_p, new_s = {}, {}
    for k, p in params.items():
        new_p[k], m, v = _leaf(p, grads[k], state["mu"][k], scale, lr, c1, c2, cfg,
                               _decay(p, p.ndim, cfg))
        new_s[k] = {"m": m, "v": v}
    return new_p, {"mu": new_s, "step": step}, {"grad_norm": gnorm, "lr": lr}


# elements of a leaf that an in-place update takes at a time: cache-sized on
# the CPU, where the chain of elementwise passes over a whole embedding is
# bound by memory (3-5x slower on a 2-layer qwen2-1.5b at full width), and
# 64M on the card (a quarter of a GB a float32 temporary, a few launches
# for the largest leaf)
CHUNK = {"cpu": 1 << 20, "cuda": 1 << 26}


@torch.no_grad()
def apply_updates_(params: dict, grads: dict, state: dict, cfg: AdamWConfig, *,
                   ndims: Optional[dict] = None,
                   grad_norm: Optional[torch.Tensor] = None) -> dict:
    """:func:`apply_updates` written into ``params`` and ``state`` in place,
    leaf by leaf and, within a leaf, :data:`CHUNK` elements of its device
    at a time: the port's form of the reference's
    donated parameters and optimizer state, with no second copy of either
    ever whole.  Every operation is elementwise, so the values are those of
    :func:`apply_updates`, bit for bit.  ``ndims`` gives a leaf's rank in
    the reference's tree where it differs from the tensor's (an LM block's
    leaf is stacked over layers there, so its norms and biases are
    decayed): the default decay rule reads it.  ``grad_norm``, where given,
    is the clip's global norm (a sharded step's, over every piece of the
    model, where ``grads`` holds one device's pieces).  Returns the
    metrics."""
    step, gnorm, scale, lr, c1, c2 = _prepare(grads, state, cfg, grad_norm)
    for k, p in params.items():
        s = state["mu"][k]
        decay = _decay(p, p.ndim if ndims is None else ndims[k], cfg)
        n = CHUNK.get(p.device.type, p.numel())
        flat = [p.view(-1), grads[k].reshape(-1), s["m"].view(-1), s["v"].view(-1)]
        for i in range(0, p.numel(), n):
            pc, gc, mc, vc = (t[i:i + n] for t in flat)
            new, m, v = _leaf(pc, gc, {"m": mc, "v": vc}, scale, lr, c1, c2, cfg, decay)
            pc.copy_(new)
            mc.copy_(m)
            vc.copy_(v)
    state["step"].copy_(step)
    return {"grad_norm": gnorm, "lr": lr}
