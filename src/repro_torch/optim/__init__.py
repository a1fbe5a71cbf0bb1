"""Optimizers of the port: AdamW on dicts of tensors (``adamw``) and the
(B tenants x R restarts) lane engine behind ``GP.optimize``
(``gp_hyperopt``).  Counterpart of ``repro/optim``; its LR schedules come
with the LM half of the port (ROADMAP A8)."""
from . import adamw
from .adamw import AdamWConfig, apply_updates, global_norm, init
from . import gp_hyperopt
from .gp_hyperopt import HyperoptResult, optimize_fleet, optimize_restarts

__all__ = [
    "adamw", "gp_hyperopt", "AdamWConfig", "apply_updates", "global_norm",
    "init", "HyperoptResult", "optimize_fleet", "optimize_restarts",
]
