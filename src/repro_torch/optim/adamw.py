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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

__all__ = ["AdamWConfig", "init", "apply_updates", "global_norm"]


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


def apply_updates(params: dict, grads: dict, state: dict, cfg: AdamWConfig):
    """One AdamW step.  Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        grads = {k: g * scale for k, g in grads.items()}

    lr = _lr_at(cfg, step)
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=step.device), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=step.device), stepf)

    new_p, new_s = {}, {}
    for k, p in params.items():
        s = state["mu"][k]
        g32 = grads[k].to(torch.float32)
        m = s["m"].to(torch.float32) * cfg.b1 + g32 * (1.0 - cfg.b1)
        v = s["v"].to(torch.float32) * cfg.b2 + torch.square(g32) * (1.0 - cfg.b2)
        upd = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        decay = cfg.weight_decay if p.ndim >= 2 else 0.0
        if cfg.decay_mask is not None:
            decay = cfg.weight_decay if cfg.decay_mask(p) else 0.0
        p32 = p.to(torch.float32)
        new_p[k] = (p32 - lr * (upd + decay * p32)).to(p.dtype)
        sd = s["m"].dtype
        new_s[k] = {"m": m.to(sd), "v": v.to(sd)}

    return new_p, {"mu": new_s, "step": step}, {"grad_norm": gnorm, "lr": lr}
