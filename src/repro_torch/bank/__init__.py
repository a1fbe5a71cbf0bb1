"""Batched multi-tenant GP serving: a bank of sessions, its router, the
pipelined engine and the tiered lifecycle.

Counterpart of ``repro/bank``: ``GPBank`` keeps B fitted sessions on the
device as one stacked state and serves, fits and updates them with batched
calls; ``BankRouter`` coalesces per-tenant query and observation queues
into the padded batches the bank wants; ``FleetEngine`` serves through the
router with dispatch-ahead, deadlines and bucket autotuning; ``TieredBank``
fronts a bank with a cold tier of checkpoints and sliding-window
forgetting; ``ShardedGPBank`` spreads a bank's slots over the devices of a
mesh (``launch/mesh.py``).
"""
from .bank import GPBank
from .engine import (
    TIMEOUT_MU,
    TIMEOUT_VAR,
    FleetEngine,
    LatencyStats,
    QueueFull,
    TicketResult,
)
from .lifecycle import TieredBank
from .router import BankRouter
from .sharded import ShardedGPBank

__all__ = [
    "GPBank", "BankRouter", "FleetEngine", "LatencyStats", "QueueFull",
    "ShardedGPBank", "TicketResult", "TIMEOUT_MU", "TIMEOUT_VAR", "TieredBank",
]
