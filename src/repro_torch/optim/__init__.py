"""Optimizers of the port: AdamW on dicts of tensors (``adamw``), the
learning-rate schedules (``schedules``) and the (B tenants x R restarts)
lane engine behind ``GP.optimize`` (``gp_hyperopt``).  Counterpart of
``repro/optim``."""
from . import adamw, schedules
from .adamw import AdamWConfig, apply_updates, apply_updates_, global_norm, init
from .schedules import constant, warmup_cosine, warmup_linear
from . import gp_hyperopt
from .gp_hyperopt import HyperoptResult, optimize_fleet, optimize_restarts

__all__ = [
    "adamw", "schedules", "gp_hyperopt", "AdamWConfig", "apply_updates",
    "apply_updates_", "global_norm", "init", "constant", "warmup_cosine",
    "warmup_linear", "HyperoptResult", "optimize_fleet", "optimize_restarts",
]
