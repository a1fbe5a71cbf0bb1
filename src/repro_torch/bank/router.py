"""BankRouter: per-tenant queues coalesced into fixed-shape fleet batches.

Counterpart of ``repro/bank/router.py``.  Callers
enqueue work addressed to individual tenants; the router coalesces it into
padded mixed-tenant batches for :class:`~repro_torch.bank.GPBank`:

* **Queries**: :meth:`submit` enqueues a query row for a tenant and returns
  a ticket; :meth:`flush` packs all pending rows (arrival order) into
  (microbatch, p) blocks, pads the tail by repeating the last real row
  (results discarded), answers each block with one ``GPBank.mean_var``
  call and returns ``ticket -> (mu, var)``.
* **Observations**: :meth:`observe` enqueues an (x, y) pair for a tenant;
  :meth:`ingest` pads each tenant's pending rows to chunks of
  ``ingest_chunk`` (row-masked) and absorbs them with batched
  ``GPBank.update`` rounds of distinct tenants; a tenant with more than one
  chunk pending is spread across rounds.

* **Staleness**: :meth:`ingest` counts the rows each tenant absorbed since
  its hyperparameters were last optimized; :meth:`stale_tenants` lists the
  tenants past a threshold and :meth:`reoptimize` re-learns theirs with one
  batched ``GPBank.optimize`` run, the bank becoming heterogeneous.

The router owns the bank reference: :meth:`ingest` and :meth:`reoptimize`
replace it with the new (immutable) bank, and later :meth:`flush` calls
serve the new posterior.  The pipelined :class:`~repro_torch.bank.FleetEngine`
drives the same queues through :meth:`take` / :meth:`requeue`.

* **Shards**: over a :class:`~repro_torch.bank.ShardedGPBank` the router
  reports per-shard occupancy and backlog (:meth:`shard_backlogs`, the
  ``bank_shard_occupancy`` / ``bank_shard_backlog`` gauges), evens out
  occupancy with :meth:`rebalance`, and leaves the group axis of an ingest
  round to the bank, which pads each shard to its own rung.
"""
from __future__ import annotations

from typing import Hashable, Optional

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from ..obs.trace import NULL_TRACER
from .bank import GPBank

__all__ = ["BankRouter"]


class BankRouter:
    """See module docstring.  Not thread-safe; one router per serving loop.

    ``ingest_rounds`` counts the distinct-tenant update rounds absorbed so
    far (what ``router_ingest_rounds_total`` counts in a registry).

    ``metrics=`` / ``tracer=`` (``repro_torch.obs``) light up telemetry:
    counters for flushed blocks, ingested rows and rounds and reoptimized
    tenants, and spans around flush, each ingest round and reoptimize,
    recorded at block or round granularity, never per row.  Both default to
    no-ops.  ``donate_updates=True`` makes each ingest round write into the
    bank's own tensors (``GPBank._update_at_slots(donate=True)``): only for
    a serving loop that owns its bank exclusively, as the pipelined engine
    does; anything holding an older bank must leave it off."""

    def __init__(self, bank: GPBank, *, microbatch: int = 64,
                 ingest_chunk: int = 16, donate_updates: bool = False,
                 metrics: Optional[obs_metrics.MetricsRegistry] = None,
                 tracer=None):
        if microbatch < 1 or ingest_chunk < 1:
            raise ValueError("microbatch and ingest_chunk must be >= 1")
        reg = obs_metrics.NULL if metrics is None else metrics
        self.registry = reg
        self.tracer = NULL_TRACER if tracer is None else tracer
        self._c_flush_blocks = reg.counter(
            "router_flush_blocks_total", "padded blocks served by flush")
        self._c_ingest_rows = reg.counter(
            "router_ingest_rows_total", "observation rows absorbed")
        self._c_ingest_rounds = reg.counter(
            "router_ingest_rounds_total", "distinct-tenant update rounds")
        self._c_reopt_rounds = reg.counter(
            "router_reopt_rounds_total", "batched reoptimize calls")
        self._c_reopt_tenants = reg.counter(
            "router_reopt_tenants_total", "tenants reoptimized")
        self._c_rebalance = reg.counter(
            "bank_rebalance_total", "cross-shard tenant moves applied by "
            "rebalance")
        if not isinstance(reg, obs_metrics.NullRegistry):
            reg.add_collector(self._publish_shards)
        self.donate_updates = bool(donate_updates)
        self.bank = bank
        self.microbatch = int(microbatch)
        self.ingest_chunk = int(ingest_chunk)
        self.ingest_rounds = 0
        self._pending: list = []
        self._observations: dict = {}
        self._next_ticket = 0
        self._since_reopt: dict = {}   # tenant -> rows absorbed since its last optimize

    # -- shard placement awareness ------------------------------------------

    @property
    def _sharded(self) -> bool:
        return getattr(self.bank, "mesh", None) is not None

    def shard_backlogs(self) -> np.ndarray:
        """(S,) pending query rows per shard (empty when the bank is not
        sharded): the router-side load signal beside the bank's
        occupancy."""
        if not self._sharded:
            return np.zeros(0, np.int64)
        depth = np.zeros(self.bank.n_shards, np.int64)
        for _, tenant, _ in self._pending:
            if tenant in self.bank.slots:
                depth[self.bank.shard_of(tenant)] += 1
        return depth

    def _publish_shards(self) -> None:
        """Scrape-time collector: per-shard occupancy and backlog gauges
        (published only while the bank is sharded)."""
        if not self._sharded:
            return
        occ = self.bank.shard_occupancy()
        backlog = self.shard_backlogs()
        for s in range(self.bank.n_shards):
            self.registry.gauge("bank_shard_occupancy", "active tenants on this shard",
                                shard=s).set(int(occ[s]))
            self.registry.gauge("bank_shard_backlog", "pending query rows bound for "
                                "this shard", shard=s).set(int(backlog[s]))

    def rebalance(self, *, threshold: int = 2, max_moves: Optional[int] = None) -> int:
        """Even out per-shard occupancy when the spread reaches
        ``threshold``: swap in the rebalanced bank
        (:meth:`~repro_torch.bank.ShardedGPBank.rebalance`) and count the
        moves.  A no-op on a resident bank and on a balanced fleet; returns
        the number of tenants moved."""
        if not self._sharded:
            return 0
        occ = self.bank.shard_occupancy()
        if int(occ.max()) - int(occ.min()) < max(1, int(threshold)):
            return 0
        with self.tracer.span("rebalance", spread=int(occ.max() - occ.min())):
            self.bank, moves = self.bank.rebalance(max_moves=max_moves)
        self._c_rebalance.inc(moves)
        return moves

    # -- staleness + periodic re-optimization -------------------------------

    def stale_tenants(self, min_rows: int, *, retain=()) -> list:
        """Tenants that absorbed at least ``min_rows`` observations since
        their hyperparameters were last optimized (insertion order): the
        candidates for the next :meth:`reoptimize`.

        Counters of tenants no longer in the bank are dropped here, so an
        id evicted and later re-inserted starts fresh, unless ``retain``
        names it (a tiered bank's cold tenants keep their drift record;
        they are still never returned as stale)."""
        keep = set(retain)
        self._since_reopt = {t: c for t, c in self._since_reopt.items()
                             if t in self.bank.slots or t in keep}
        return [t for t in self.bank.slots if self._since_reopt.get(t, 0) >= min_rows]

    def reoptimize(self, tenant_ids, Xb, yb, mask=None, **kw) -> None:
        """Re-learn the hyperparameters of ``tenant_ids`` (typically
        :meth:`stale_tenants`) from their accumulated data, Xb (B, N, p),
        yb (B, N), mask (B, N), and swap the optimized bank in: one batched
        ``GPBank.optimize`` run (``**kw`` forwards restarts, steps, lr, tol,
        seed), the staleness counters reset on success."""
        ids = list(tenant_ids)
        if not ids:
            return
        if self.registry is not obs_metrics.NULL:
            kw.setdefault("metrics", self.registry)
        if self.tracer is not NULL_TRACER:
            kw.setdefault("tracer", self.tracer)
        with self.tracer.span("reopt", tenants=len(ids)):
            self.bank = self.bank.optimize(Xb, yb, tenant_ids=ids, mask=mask, **kw)
        self._c_reopt_rounds.inc()
        self._c_reopt_tenants.inc(len(ids))
        for t in ids:
            self._since_reopt[t] = 0

    # -- query path ---------------------------------------------------------

    def _row(self, tenant: Hashable, x, what: str) -> np.ndarray:
        self.bank.slot_of(tenant)  # fail fast on unknown tenants
        x = np.asarray(x, np.float32).reshape(-1)
        if x.shape[0] != self.bank.spec.p:
            raise ValueError(
                f"{what} row has p={x.shape[0]}, bank serves p={self.bank.spec.p}"
            )
        return x

    def submit(self, tenant: Hashable, x) -> int:
        """Enqueue one query row for ``tenant``; returns a ticket redeemed
        by the next :meth:`flush`."""
        x = self._row(tenant, x, "query")
        ticket = self._next_ticket
        self._next_ticket += 1
        self._pending.append((ticket, tenant, x))
        return ticket

    @property
    def pending(self) -> int:
        return len(self._pending)

    def take(self, k: int) -> list:
        """Pop up to ``k`` pending query entries in arrival order, as opaque
        ``(ticket, tenant, x)`` triples for :meth:`requeue` /
        ``_pack_block``."""
        k = max(0, int(k))
        taken, self._pending = self._pending[:k], self._pending[k:]
        return taken

    def requeue(self, entries) -> None:
        """Push taken entries back to the FRONT of the queue: arrival order
        is preserved and every ticket stays redeemable."""
        self._pending = list(entries) + self._pending

    def _pack_block(self, block, size: int):
        """Pad a taken block to ``size`` rows by repeating the last real row
        (fixed shapes; padded results are discarded).  Returns (tenant
        list, (size, p) float32 array)."""
        pad = size - len(block)
        tenants = [t for _, t, _ in block] + [block[-1][1]] * pad
        Xq = np.stack([x for _, _, x in block] + [block[-1][2]] * pad)
        return tenants, Xq

    def flush(self) -> dict:
        """Serve every pending query; returns ``ticket -> (mu, var)``
        (floats), in fixed (microbatch, p) blocks.

        If a block fails mid-flush, the WHOLE backlog (served blocks
        included: queries are idempotent reads whose results would die
        with the exception) is restored to the queue before the error
        propagates, so every ticket stays redeemable once the caller
        repairs the bank."""
        if not self._pending:
            return {}
        todo, self._pending = self._pending, []
        out: dict = {}
        mb = self.microbatch
        with self.tracer.span("flush", rows=len(todo)):
            for lo in range(0, len(todo), mb):
                block = todo[lo:lo + mb]
                tenants, Xq = self._pack_block(block, mb)
                try:
                    mu, var = self.bank.mean_var(tenants, torch.from_numpy(Xq))
                except Exception:
                    self._pending = todo + self._pending
                    raise
                mu = mu.cpu().numpy()
                var = var.cpu().numpy()
                for i, (ticket, _, _) in enumerate(block):
                    out[ticket] = (float(mu[i]), float(var[i]))
                self._c_flush_blocks.inc()
        return out

    # -- ingest path --------------------------------------------------------

    def observe(self, tenant: Hashable, x, y) -> None:
        """Enqueue one observation (x, y) for ``tenant``; absorbed by the
        next :meth:`ingest`."""
        x = self._row(tenant, x, "observation")
        self._observations.setdefault(tenant, []).append((x, float(y)))

    def ingest(self) -> int:
        """Absorb every pending observation through batched
        ``GPBank.update`` rounds; returns the number of rows absorbed.
        Each round is a distinct-tenant batch of ``ingest_chunk``-row
        groups (row-masked).  The group axis is padded to a power-of-two
        bucket with fully-masked identity groups aimed at distinct unused
        slots, so the batch shapes stay within log2(capacity) sizes (a
        sharded bank pads per shard; each round traces ``shard_ingest``
        with the groups each shard takes).

        If a round fails, its rows and everything still queued are restored
        to the observation queue before the error propagates; earlier
        rounds stay absorbed."""
        if not self._observations:
            return 0
        queues = {t: list(rows) for t, rows in self._observations.items()}
        self._observations = {}
        k = self.ingest_chunk
        absorbed = 0
        p = self.bank.spec.p
        while queues:
            slots, Xg, yg, mg = [], [], [], []
            taken: dict = {}
            round_span = self.tracer.span("ingest", tenants=len(queues))
            round_span.__enter__()
            try:
                for t in list(queues):
                    rows, rest = queues[t][:k], queues[t][k:]
                    if rest:
                        queues[t] = rest
                    else:
                        del queues[t]
                    taken[t] = rows
                    X = np.zeros((k, p), np.float32)
                    y = np.zeros((k,), np.float32)
                    m = np.zeros((k,), np.float32)
                    for i, (x, yv) in enumerate(rows):
                        X[i], y[i], m[i] = x, yv, 1.0
                    slots.append(self.bank.slot_of(t))
                    Xg.append(X)
                    yg.append(y)
                    mg.append(m)
                G = len(slots)
                if self._sharded:
                    # the sharded bank pads each shard to its own rung:
                    # global padding would only inflate the busiest shard
                    per_shard = np.bincount(np.asarray(slots) // self.bank.shard_capacity,
                                            minlength=self.bank.n_shards)
                    for s in np.flatnonzero(per_shard):
                        self.tracer.instant("shard_ingest", shard_id=int(s),
                                            groups=int(per_shard[s]))
                else:
                    bucket = min(self.bank.capacity, 1 << (G - 1).bit_length())
                    if bucket > G:
                        used = set(slots)
                        free = (s for s in range(self.bank.capacity) if s not in used)
                        for _ in range(bucket - G):
                            slots.append(next(free))
                            Xg.append(np.zeros((k, p), np.float32))
                            yg.append(np.zeros((k,), np.float32))
                            mg.append(np.zeros((k,), np.float32))
                self.bank = self.bank._update_at_slots(
                    np.array(slots, np.int64),
                    torch.from_numpy(np.stack(Xg)), torch.from_numpy(np.stack(yg)),
                    torch.from_numpy(np.stack(mg)), donate=self.donate_updates,
                )
            except Exception:
                for t, rows in taken.items():
                    queues[t] = rows + queues.get(t, [])
                for t, rows in queues.items():
                    self._observations[t] = rows + self._observations.get(t, [])
                raise
            finally:
                round_span.__exit__(None, None, None)
            round_rows = sum(len(rows) for rows in taken.values())
            absorbed += round_rows
            self.ingest_rounds += 1
            self._c_ingest_rounds.inc()
            self._c_ingest_rows.inc(round_rows)
            for t, rows in taken.items():
                self._since_reopt[t] = self._since_reopt.get(t, 0) + len(rows)
        return absorbed
