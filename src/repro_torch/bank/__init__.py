"""Batched multi-tenant GP serving: a bank of sessions and its router.

Counterpart of ``repro/bank`` for the synchronous fleet path: ``GPBank``
keeps B fitted sessions on the device as one stacked state and serves,
fits and updates them with batched calls; ``BankRouter`` coalesces
per-tenant query and observation queues into the padded batches the bank
wants.  The pipelined ``FleetEngine``, the tiered lifecycle and the sharded
bank come with later slices of the port (ROADMAP.md).
"""
from .bank import GPBank
from .router import BankRouter

__all__ = ["GPBank", "BankRouter"]
