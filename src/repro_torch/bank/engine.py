"""FleetEngine — pipelined, latency-bounded serving on top of BankRouter.

Counterpart of ``repro/bank/engine.py``.  The synchronous loop
(``BankRouter.flush``) serializes host and device: pack a microbatch,
dispatch it, *block* for the result, convert, repeat — device idles while
Python packs, host idles while the kernels run.  The engine removes every
per-tick barrier:

* **Dispatch-ahead** — :meth:`pump` packs a padded block and queues its
  serving launches *without blocking*: CUDA launches are asynchronous, and
  the block's slots and rows reach the card by non-blocking copies from
  pinned host memory, its results come back the same way into pinned
  tensors followed by a CUDA event (``GPBank._serving_entry``).  Nothing on
  the dispatch path reads a device value on the host, so up to
  ``max_in_flight`` blocks ride the device queue while the host packs the
  next one; :meth:`harvest` collects blocks whose event has completed
  (``GPBank.result_ready``, an ``Event.query()``) and only ever blocks when
  asked to (``wait=True``), then on that block's event alone — never on
  the blocks queued behind it, as a ``.cpu()`` of its results would.
  PyTorch's caching host allocator hands a pinned block out again only
  after the copies recorded on it are done.  Ingest can
  additionally donate the old stack into the update
  (``BankRouter(donate_updates=True)``): the update writes in place instead
  of cloning an 800 MB stack at the fleet's width.  On the CPU the bank's
  plain versions compute each block when it is dispatched, and harvest
  finds every block ready.
* **Admission + deadlines** — :meth:`submit` enforces a queue budget
  (``QueueFull`` when ``pending + in-flight`` rows exceed it: shed load at
  the door, not after paying for padding) and stamps each ticket with a
  deadline (per-call ``deadline_s``, else the tenant's SLO in ``slo_s``,
  else ``default_slo_s``).  A ticket that expires before dispatch is
  answered with the documented timeout sentinel — ``mu = NaN``,
  ``var = inf``, ``timed_out=True`` (:data:`TIMEOUT_MU` /
  :data:`TIMEOUT_VAR`) — immediately, and never holds a seat in a padded
  block or stalls tickets behind it.  Once a ticket is dispatched its
  result is always delivered; deadlines gate admission to the device, not
  result delivery.
* **Bucket autotuning** — instead of one fixed microbatch, the dispatched
  block size is chosen per block from the *observed arrival rate* (EWMA of
  inter-submit gaps) times the EWMA block service time, rounded up to a
  power of two: light traffic gets small low-latency blocks, heavy
  traffic gets large amortizing ones — up to ``max_coalesce``
  microbatches fused into ONE dispatch when the arrival rate sustains it
  (per-dispatch host overhead is the dominant serving cost at these
  shapes, so coalescing is where the pipelined throughput win comes
  from).  When a fleet-wide SLO is configured the bucket is additionally
  capped so a ticket does not wait out its whole deadline just filling a
  block.  The bucket set is FIXED (powers of two up to
  ``microbatch * max_coalesce``), so at most ``log2``-many serving shapes
  ever exist no matter how traffic churns — the same shape-bucketing
  contract as the router's ingest group axis, pinned by the serving
  functions' shape registries (``repro_torch.obs.watchdog``) in
  ``tests/test_torch_engine.py``.
* **Lean dispatch** — the engine does not pay ``GPBank.mean_var``'s
  public-API toll (per-row tenant validation, backend re-resolution,
  redundant conversions) per block: it resolves the slot map and the
  bank's serving entry ONCE per bank version (the cache is keyed on the
  bank's object identity, so ingest/reoptimize swaps invalidate it
  automatically).
* **Sharded banks** — over a :class:`~repro_torch.bank.ShardedGPBank` a
  block carries its real rows only (the bank pads each shard to its own
  rung, so a global pad would only inflate the busiest shard); the results
  come back in packed per-shard order, one CUDA event per shard touched,
  and are put back in row order at harvest; with a tracer each dispatch
  records a ``shard_dispatch`` instant per shard it touches.
* **Latency observability** — every completed ticket records its
  submit→harvest latency per tenant into a BOUNDED reservoir
  (:class:`LatencyStats`); :meth:`metrics` reports per-tenant and overall
  p50/p99 (exactly ``numpy.percentile`` over the reservoir), timeout
  counts, bucket usage, and sustained queries/s over the engine's
  lifetime.  Passing ``metrics=`` / ``tracer=`` / ``watchdog=``
  (``repro_torch.obs``) additionally lights up fleet telemetry: pipeline-stage
  spans at block granularity (bucket_select, coalesce, dispatch,
  device_wait, harvest, expire, page_in; per-query admit events sampled
  1-in-256 so tracing cannot blow the latency budget), registry counters
  and gauges flushed through a scrape-time collector (the serving loop
  never pays per-event registry costs beyond one histogram record per
  block), and a :class:`~repro_torch.obs.RecompileWatchdog` check per pump
  so a shape leak past the bucket ladder is reported at the block where it
  appeared.  All three default to no-ops costing one attribute lookup.

Failure containment matches the router's contract: a dispatch that raises
mid-flight requeues its block at the FRONT of the router backlog before
the error propagates — every ticket stays redeemable and the bank state is
untouched (queries are reads; a failed ingest round restores its rows via
``BankRouter.ingest``).

Not thread-safe; one engine per serving loop, and the engine assumes it is
the only writer of its router's bank.
"""
from __future__ import annotations

import dataclasses
import math
import random
import time
from collections import Counter, deque
from typing import Callable, Hashable, Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from ..obs.trace import NULL_TRACER, NullTracer
from .bank import GPBank
from .router import BankRouter

__all__ = [
    "FleetEngine", "LatencyStats", "QueueFull", "TicketResult",
    "TIMEOUT_MU", "TIMEOUT_VAR",
]

# The documented deadline-timeout sentinel: deterministic, impossible to
# mistake for a real posterior (real variances are finite, real means are
# finite), and carried next to an explicit ``timed_out`` flag.
TIMEOUT_MU = float("nan")
TIMEOUT_VAR = float("inf")


class QueueFull(RuntimeError):
    """Admission refused: queue depth (pending + in-flight rows) is at the
    engine's ``queue_budget``.  Backpressure happens at :meth:`submit`
    time so overload sheds load instead of growing an unbounded backlog."""


class TicketResult(NamedTuple):
    """One redeemed ticket.  ``timed_out`` results carry the sentinel
    values (``mu = NaN``, ``var = inf``); completed results carry the
    posterior and the submit→harvest latency.  (A NamedTuple, not a
    dataclass: one is constructed per served query on the harvest hot
    path, and tuple construction is several times cheaper.)"""

    mu: float
    var: float
    timed_out: bool = False
    latency_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.timed_out


class LatencyStats:
    """Per-tenant latency samples + timeout counters, BOUNDED memory.

    Each tenant's samples live in a uniform reservoir (Vitter's
    Algorithm R) capped at ``bound`` entries: up to the bound every
    sample is retained and percentiles are EXACT; past it each new
    sample replaces a uniformly random slot with probability
    ``bound / n``, so the buffer stays a uniform random sample of the
    WHOLE stream and ``percentiles()`` returns the classical
    reservoir-sample estimator (unbiased order-statistic probabilities,
    error ~O(1/sqrt(bound)) in rank).  Under sustained traffic memory is
    O(tenants x bound) forever, instead of growing per served query.

    Percentiles are computed with ``numpy.percentile`` (linear
    interpolation — the reference semantics the unit tests pin), over
    COMPLETED tickets only; timeouts are counted separately so an SLO
    breach cannot hide inside a rosy p99.  ``counts`` tracks the TRUE
    per-tenant totals regardless of the bound; ``samples`` maps tenant
    -> current reservoir contents (arrival order below the bound).
    """

    def __init__(self, *, bound: int = 4096, seed: int = 0) -> None:
        if bound < 1:
            raise ValueError("bound must be >= 1")
        self.bound = int(bound)
        self.samples: dict[Hashable, list] = {}
        self.counts: Counter = Counter()
        self.timeouts: Counter = Counter()
        self._rng = random.Random(seed)

    def record(self, tenant: Hashable, seconds: float) -> None:
        buf = self.samples.get(tenant)
        if buf is None:
            buf = self.samples[tenant] = []
        n = self.counts[tenant]
        self.counts[tenant] = n + 1
        if n < self.bound:
            buf.append(float(seconds))
        else:
            j = self._rng.randrange(n + 1)
            if j < self.bound:
                buf[j] = float(seconds)

    def record_timeout(self, tenant: Hashable) -> None:
        self.timeouts[tenant] += 1

    def count(self, tenant: Hashable) -> int:
        """TRUE number of recorded samples (not capped at the bound)."""
        return int(self.counts[tenant])

    def percentiles(self, tenant: Optional[Hashable] = None,
                    qs=(50.0, 99.0)) -> tuple:
        """(p50, p99, ...) seconds for one tenant (or pooled over all when
        ``tenant`` is None); NaNs when no samples.  Exact while every
        reservoir is below its bound; the reservoir estimator above."""
        if tenant is None:
            vals = [s for lst in self.samples.values() for s in lst]
        else:
            vals = self.samples.get(tenant, [])
        if not vals:
            return tuple(float("nan") for _ in qs)
        return tuple(float(v) for v in np.percentile(np.asarray(vals),
                                                     list(qs)))


@dataclasses.dataclass
class _InFlight:
    """One dispatched block: its tickets, its results (pinned host tensors
    filled by copies still in flight on a card) and the events recorded
    after those copies (none on the CPU)."""

    entries: list           # [(ticket, tenant, x), ...] — real rows only
    mu: object              # (bucket,) float32 tensor; a sharded bank's: one per shard
    var: object
    events: tuple           # torch.cuda.Event per device the block ran on
    bucket: int
    t_dispatch: float
    # sharded dispatch: entry i's result sits at position order[i] of the
    # shards' packed results concatenated; None for a resident bank
    order: object = None


def _pow2_buckets(microbatch: int, max_coalesce: int = 1) -> tuple:
    """The fixed bucket ladder: powers of two below ``microbatch``, then
    ``microbatch`` itself, then its power-of-two multiples up to
    ``microbatch * max_coalesce`` — one serving shape per rung, and never
    a new one no matter how traffic churns."""
    out = []
    b = 1
    while b < microbatch:
        out.append(b)
        b *= 2
    top = microbatch * max(1, int(max_coalesce))
    b = microbatch
    while b < top:
        out.append(b)
        b *= 2
    out.append(b)
    return tuple(out)


class FleetEngine:
    """See module docstring.

    router:        the :class:`BankRouter` whose bank this engine serves.
                   The engine owns the router's queues; drive ALL traffic
                   through the engine once it exists.
    max_in_flight: dispatch-ahead depth — blocks riding the device queue
                   before :meth:`pump` stops dispatching.
    queue_budget:  admission bound on pending + in-flight rows.
    max_coalesce:  how many microbatches the autotuner may fuse into one
                   dispatch under sustained load (rounded up to a power
                   of two; 1 = never exceed the router's microbatch).
    default_slo_s: deadline stamped on tickets with no explicit
                   ``deadline_s`` and no per-tenant SLO (None = no
                   deadline).
    slo_s:         per-tenant deadline overrides (tenant -> seconds).
    auto_pump:     dispatch opportunistically from :meth:`submit` once a
                   bucketful is waiting (the steady-state pipelining
                   mode); disable for manual pump/harvest control.
    tiered:        a :class:`~repro_torch.bank.TieredBank` fronting the
                   router's bank with a cold tier.  With it, :meth:`submit`
                   / :meth:`observe` accept COLD tenants: the engine pages
                   them in through the tier (a warm restore through
                   ``GPBank.insert``; the LRU victim goes to the cold tier)
                   and swaps the restored bank into the router.  In-flight
                   blocks are never stalled by a page-in — banks are
                   immutable, so already-dispatched blocks keep computing
                   against the pre-swap stack while new dispatches see the
                   new one (the dispatch cache is keyed on bank identity).
                   Tenants with pending or in-flight work are pinned
                   against eviction.  :meth:`ingest` additionally feeds
                   absorbed rows into the tier's sliding-window
                   bookkeeping.
    clock:         injectable monotonic clock (tests drive deadlines
                   deterministically with a fake one).
    metrics:       a :class:`repro_torch.obs.MetricsRegistry`; the engine
                   registers a scrape-time collector flushing its
                   counters/gauges (admitted, completed, expired,
                   queue-full rejections, page-ins, per-bucket dispatch
                   counts, queue depth, in-flight rows, latency
                   quantiles) into it.  Default: the no-op NULL registry.
    tracer:        a :class:`repro_torch.obs.Tracer`; pipeline stages emit
                   spans at block granularity plus 1-in-64-sampled
                   per-query ``admit`` events.  Default: no-op.
    watchdog:      a :class:`repro_torch.obs.RecompileWatchdog`; checked
                   after every pump so a new serving shape (or a kernel
                   build) is reported at the block that caused it.
                   Default: None (no checks).
    """

    def __init__(
        self,
        router: BankRouter,
        *,
        max_in_flight: int = 4,
        queue_budget: int = 4096,
        max_coalesce: int = 4,
        default_slo_s: Optional[float] = None,
        slo_s: Optional[Mapping[Hashable, float]] = None,
        auto_pump: bool = True,
        tiered=None,
        clock: Callable[[], float] = time.perf_counter,
        metrics: Optional[obs_metrics.MetricsRegistry] = None,
        tracer=None,
        watchdog=None,
    ):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        if queue_budget < 1:
            raise ValueError("queue_budget must be >= 1")
        self.router = router
        self.max_in_flight = int(max_in_flight)
        self.queue_budget = int(queue_budget)
        self.default_slo_s = default_slo_s
        self.slo_s = dict(slo_s or {})
        self.auto_pump = bool(auto_pump)
        self.tiered = tiered
        if tiered is not None and tiered.bank is not router.bank:
            tiered.adopt(router.bank)
        self._clock = clock
        self.stats = LatencyStats()
        self.buckets = _pow2_buckets(router.microbatch, max_coalesce)
        self.bucket_uses: Counter = Counter()
        # lean-dispatch cache: (bank identity, slot map, dispatch fn) —
        # rebuilt whenever the router's bank is swapped (ingest/reopt)
        self._dcache: Optional[tuple] = None
        self._in_flight: deque[_InFlight] = deque()
        self._rows_in_flight = 0
        # auto-pump threshold, refreshed whenever the autotune signal
        # moves (block completion / dispatch) — submit() is the per-query
        # hot path and only does an int compare against it
        self._pump_threshold = router.microbatch
        # ticket -> (tenant, t_submit, absolute deadline)
        self._meta: dict[int, tuple] = {}
        self._done: dict[int, TicketResult] = {}
        # EWMAs: arrival rate (tickets/s) and block service time (s)
        self._arrival_rate = 0.0
        self._last_submit: Optional[float] = None
        self._service_ewma = 0.0
        self._alpha = 0.2
        # lifetime counters for sustained-QPS reporting
        self._completed = 0
        self._expired = 0
        self._t_first_submit: Optional[float] = None
        self._t_last_harvest: Optional[float] = None
        # -- telemetry (repro_torch.obs) -----------------------------------
        # plain ints on the hot path; the registry sees them through a
        # scrape-time collector (_publish), so per-event cost is zero
        reg = obs_metrics.NULL if metrics is None else metrics
        self.registry = reg
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.watchdog = watchdog
        self._trace_on = not isinstance(self.tracer, NullTracer)
        self._n_admitted = 0
        self._n_queue_full = 0
        self._n_page_ins = 0
        self._published: dict = {}       # series key -> last flushed total
        self._h_block_service = reg.histogram(
            "serve_block_service_seconds",
            "dispatch->harvest wall time per padded block",
        )
        if not isinstance(reg, obs_metrics.NullRegistry):
            reg.add_collector(self._publish)

    # -- introspection ------------------------------------------------------

    @property
    def in_flight_blocks(self) -> int:
        return len(self._in_flight)

    @property
    def in_flight_rows(self) -> int:
        return self._rows_in_flight

    @property
    def depth(self) -> int:
        """Current queue depth: rows waiting + rows on the device."""
        return self.router.pending + self.in_flight_rows

    # -- admission ----------------------------------------------------------

    def _page_in(self, tenant: Hashable) -> None:
        """Warm-restore a cold tenant through the tier and swap the
        restored bank into the router.  Tenants with pending or in-flight
        work (queries AND queued observations) are pinned — evicting one
        would fail its eventual dispatch/ingest.  Never stalls in-flight
        blocks: they were queued against the old immutable stack."""
        with self.tracer.span("page_in", tenant=str(tenant)):
            self._page_in_inner(tenant)
        self._n_page_ins += 1

    def _page_in_inner(self, tenant: Hashable) -> None:
        t = self.tiered

        def pins():
            p = {m[0] for m in self._meta.values()}
            p.update(self.router._observations)
            return p

        t.adopt(self.router.bank)
        try:
            t.page_in(tenant, pinned=pins())
        except RuntimeError:
            # every hot slot pinned.  All engine pins are SOFT: queued
            # observations can be absorbed now (early ingest), and
            # pending/in-flight queries can be run to completion — their
            # results go back into the done-buffer, so every ticket stays
            # redeemable by the next harvest.  In-flight blocks are never
            # cancelled; they complete against the old immutable stack.
            # (This fallback fires only at full pin coverage — normal
            # paging never waits on in-flight work.)
            if self.router._observations:
                self.ingest()
            if self.router.pending or self._in_flight:
                # NB: harvest() swaps self._done for a fresh dict, so the
                # drain must complete before the buffer is looked up
                redeemed = self.drain()
                self._done.update(redeemed)
            t.adopt(self.router.bank)
            t.page_in(tenant, pinned=pins())
        self.router.bank = t.bank

    def submit(self, tenant: Hashable, x, *,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue one query row; returns a ticket redeemed by a later
        :meth:`harvest` / :meth:`drain`.  Raises :class:`QueueFull` when
        the queue budget is exhausted (backpressure — nothing is
        enqueued).  With a :attr:`tiered` store, a cold tenant is paged
        in here (before admission charges anything)."""
        pending = len(self.router._pending)
        if pending + self._rows_in_flight >= self.queue_budget:
            self._n_queue_full += 1
            raise QueueFull(
                f"queue depth {pending + self._rows_in_flight} is at the "
                f"budget ({self.queue_budget}); harvest or raise the budget"
            )
        if self.tiered is not None and tenant not in self.router.bank.slots:
            self._page_in(tenant)
        now = self._clock()
        ticket = self.router.submit(tenant, x)
        # admit telemetry: a plain int plus a 1-in-256-sampled trace
        # event — submit is the per-query hot path, where a full span per
        # query would cost more than the admission itself
        self._n_admitted += 1
        if self._trace_on and not (self._n_admitted & 255):
            self.tracer.instant("admit", tenant=str(tenant), depth=pending)
        if deadline_s is None:
            deadline_s = self.slo_s.get(tenant, self.default_slo_s)
        deadline = math.inf if deadline_s is None else now + float(deadline_s)
        self._meta[ticket] = (tenant, now, deadline)
        last = self._last_submit
        if last is not None:
            gap = now - last
            self._arrival_rate = (
                self._alpha / gap + (1.0 - self._alpha) * self._arrival_rate
                if gap > 1e-9 else self._arrival_rate
            )
        else:
            self._t_first_submit = now
        self._last_submit = now
        if (pending + 1 >= self._pump_threshold
                and self.auto_pump
                and len(self._in_flight) < self.max_in_flight):
            self.pump(max_blocks=1)
        return ticket

    def observe(self, tenant: Hashable, x, y) -> None:
        """Enqueue one observation (delegates to the router; a cold
        tenant is paged in first when a :attr:`tiered` store exists)."""
        if self.tiered is not None and tenant not in self.router.bank.slots:
            self._page_in(tenant)
        self.router.observe(tenant, x, y)

    def ingest(self) -> int:
        """Absorb pending observations (``BankRouter.ingest``: batched,
        bucketed, failure-restoring — and donating old stack buffers when
        the router was built with ``donate_updates=True``).  With a
        :attr:`tiered` store, absorbed rows also enter the tier's
        sliding-window bookkeeping (so :meth:`TieredBank.age` can forget
        them later) and the updated bank is adopted back — even on a
        mid-ingest failure, the rows earlier rounds DID absorb are
        recorded before the error propagates."""
        if self.tiered is None:
            return self.router.ingest()
        before = {
            t: list(rows) for t, rows in self.router._observations.items()
        }
        try:
            return self.router.ingest()
        finally:
            # rows absorbed = queued-before minus restored-after (a failed
            # round restores its own and all still-queued rows in order,
            # so what remains is a suffix of what was there)
            after = self.router._observations
            for t, rows in before.items():
                absorbed = rows[: len(rows) - len(after.get(t, []))]
                if absorbed:
                    self.tiered.record_rows(
                        t, np.stack([x for x, _ in absorbed]),
                        np.asarray([yv for _, yv in absorbed], np.float32),
                    )
            self.tiered.adopt(self.router.bank)

    # -- bucket autotuning --------------------------------------------------

    def _target_bucket(self) -> int:
        """The arrival-rate-driven block size: expected arrivals over one
        block service time, rounded up to the fixed power-of-two ladder.
        When a fleet-wide SLO is configured the estimate is capped at the
        rows that arrive in HALF the SLO, so a ticket never spends its
        whole deadline waiting for its block to fill.  Before any signal
        exists (cold start) the router's microbatch is used — the
        historical fixed behavior."""
        est = self._arrival_rate * self._service_ewma
        if est <= 0.0:
            return self.router.microbatch
        if self.default_slo_s is not None:
            est = min(est, self._arrival_rate * self.default_slo_s * 0.5)
        for b in self.buckets:
            if b >= est:
                return b
        return self.buckets[-1]

    def _dispatch_bucket(self) -> int:
        """The padded size actually dispatched: the arrival-driven target,
        grown to cover a backlog that has already accumulated (fusing up
        to ``max_coalesce`` microbatches into one call — per-dispatch host
        overhead dominates at serving shapes, so draining a deep queue in
        few large blocks is the main throughput lever)."""
        want = max(self._target_bucket(), self.router.pending)
        for b in self.buckets:
            if b >= want:
                return b
        return self.buckets[-1]

    # -- dispatch-ahead -----------------------------------------------------

    def _dispatcher(self):
        """The lean per-bank dispatch closure: slot map + the bank's
        serving entry resolved ONCE per bank version (keyed on the bank's
        object identity — ingest/reoptimize swap in a new bank object and
        invalidate the cache).  ``GPBank.mean_var`` re-resolves all of
        this and validates per row on every call; at serving block rates
        that wrapper costs more than the kernels themselves."""
        bank = self.router.bank
        if self._dcache is not None and self._dcache[0] is bank:
            return self._dcache[1], self._dcache[2]
        sm = dict(bank.slots)
        call = bank._serving_entry()
        if self.router._sharded and self._trace_on:
            # a sharded bank packs per shard: trace the rows each shard takes
            entry, tracer = call, self.tracer
            C_l, S = bank.shard_capacity, bank.n_shards

            def call(slots, Xq):
                per_shard = np.bincount(slots // C_l, minlength=S)
                for s in np.flatnonzero(per_shard):
                    tracer.instant("shard_dispatch", shard_id=int(s),
                                   rows=int(per_shard[s]))
                return entry(slots, Xq)
        self._dcache = (bank, sm, call)
        return sm, call

    def _dispatch(self, entries: list, bucket: int):
        """Pack ``entries`` into one padded ``bucket``-row block and
        dispatch it WITHOUT blocking; returns (mu, var, events, order).
        A sharded bank takes the real rows only: it pads per shard, so
        padding to the global bucket here would only inflate the busiest
        shard.  Raises (e.g. ``KeyError`` for a tenant evicted from a
        swapped bank) without side effects — the caller requeues."""
        sm, call = self._dispatcher()
        if self.router._sharded:
            tenants = [t for _, t, _ in entries]
            Xq = np.stack([x for _, _, x in entries])
        else:
            tenants, Xq = self.router._pack_block(entries, bucket)
        slots = np.fromiter((sm[t] for t in tenants), np.int64, len(tenants))
        out = call(slots, Xq)
        if len(out) == 4:
            return out
        mu, var, event = out
        return mu, var, () if event is None else (event,), None

    def _expire(self, ticket: int, tenant: Hashable, t_submit: float,
                now: float) -> None:
        with self.tracer.span("expire"):
            self.stats.record_timeout(tenant)
            self._expired += 1
            self._done[ticket] = TicketResult(
                TIMEOUT_MU, TIMEOUT_VAR, timed_out=True,
                latency_s=now - t_submit,
            )

    def pump(self, max_blocks: Optional[int] = None) -> int:
        """Dispatch pending queries as padded blocks WITHOUT blocking on
        their results; returns the number of blocks dispatched.  Stops at
        ``max_in_flight`` in-flight blocks.  Deadline-expired tickets are
        answered with the timeout sentinel here, at dispatch time — they
        never occupy a padded seat or delay live tickets.  On a dispatch
        failure the block's live entries are requeued at the front of the
        router backlog before the error propagates."""
        dispatched = 0
        tr = self.tracer
        while (self.router.pending
               and len(self._in_flight) < self.max_in_flight
               and (max_blocks is None or dispatched < max_blocks)):
            with tr.span("bucket_select"):
                bucket = self._dispatch_bucket()
            entries = []
            now = self._clock()
            with tr.span("coalesce"):
                while len(entries) < bucket and self.router.pending:
                    for e in self.router.take(bucket - len(entries)):
                        tenant, t_sub, deadline = self._meta[e[0]]
                        if now > deadline:
                            del self._meta[e[0]]
                            self._expire(e[0], tenant, t_sub, now)
                        else:
                            entries.append(e)
            if not entries:       # the whole backlog had expired
                continue
            try:
                with tr.span("dispatch", bucket=bucket, rows=len(entries)):
                    mu, var, events, order = self._dispatch(entries, bucket)
            except Exception:
                self.router.requeue(entries)
                raise
            self._in_flight.append(
                _InFlight(entries, mu, var, events, bucket, now, order)
            )
            self._rows_in_flight += len(entries)
            self.bucket_uses[bucket] += 1
            dispatched += 1
        if dispatched:
            self._pump_threshold = self._target_bucket()
            if self.watchdog is not None:
                self.watchdog.check("pump")
        return dispatched

    # -- result harvest -----------------------------------------------------

    def _collect(self, blk: _InFlight) -> dict:
        with self.tracer.span("device_wait", bucket=blk.bucket):
            for event in blk.events:
                event.synchronize()       # this block's copies, none behind it
            mu, var = blk.mu, blk.var
            if blk.order is not None:     # a sharded block: back to row order
                order = torch.from_numpy(blk.order)
                mu, var = torch.cat(mu)[order], torch.cat(var)[order]
            mu_l = mu.tolist()          # one bulk conversion, not Q float() calls
            var_l = var.tolist()
        now = self._clock()
        self._t_last_harvest = now
        service = now - blk.t_dispatch
        self._h_block_service.record(service)
        self._service_ewma = (
            service if self._service_ewma == 0.0
            else self._alpha * service
            + (1.0 - self._alpha) * self._service_ewma
        )
        self._rows_in_flight -= len(blk.entries)
        self._pump_threshold = self._target_bucket()
        out = {}
        for i, (ticket, tenant, _) in enumerate(blk.entries):
            _, t_sub, _ = self._meta.pop(ticket)
            lat = now - t_sub
            self.stats.record(tenant, lat)
            out[ticket] = TicketResult(mu_l[i], var_l[i], False, lat)
        self._completed += len(blk.entries)
        return out

    def harvest(self, *, wait: bool = False) -> dict:
        """Collect results: every timeout sentinel recorded so far, plus
        every in-flight block whose device arrays have landed (FIFO; an
        unfinished head stops the scan so ticket results never arrive out
        of dispatch order).  ``wait=True`` additionally blocks for the
        head block (then keeps collecting whatever else finished).
        Returns ``ticket -> TicketResult``."""
        out, self._done = self._done, {}
        first = True
        while self._in_flight:
            blk = self._in_flight[0]
            if not ((wait and first)
                    or GPBank.result_ready(*blk.events)):
                break
            self._in_flight.popleft()
            with self.tracer.span("harvest", bucket=blk.bucket):
                out.update(self._collect(blk))
            first = False
        return out

    def drain(self) -> dict:
        """Pump + harvest until every ticket is answered (the pipelined
        replacement for ``BankRouter.flush``): packing of block k+1
        overlaps the device execution of block k, with no per-block
        barrier anywhere.  Returns ``ticket -> TicketResult``."""
        out: dict[int, TicketResult] = {}
        while self.router.pending or self._in_flight or self._done:
            if (self.router.pending
                    and len(self._in_flight) < self.max_in_flight):
                self.pump(max_blocks=1)
                out.update(self.harvest(wait=False))
            else:
                out.update(self.harvest(wait=True))
        return out

    # -- observability ------------------------------------------------------

    def _publish(self) -> None:
        """Flush plain-int hot-path counters into the metrics registry.
        Runs as a registry collector (i.e. at scrape/snapshot time, on
        the scraper's thread), so the serving loop never pays per-event
        registry costs.  Counters are flushed as deltas against the last
        published totals; gauges are overwritten."""
        reg = self.registry
        pub = self._published

        def flush(name, help, total, **labels):
            key = (name, tuple(sorted(labels.items())))
            delta = total - pub.get(key, 0)
            if delta:
                reg.counter(name, help, **labels).inc(delta)
                pub[key] = total

        flush("serve_admitted_total", "tickets admitted", self._n_admitted)
        flush("serve_completed_total", "tickets completed", self._completed)
        flush("serve_expired_total", "tickets answered with the timeout "
              "sentinel", self._expired)
        flush("serve_queue_full_total", "admissions refused (backpressure)",
              self._n_queue_full)
        flush("serve_page_ins_total", "cold tenants paged in through the "
              "tier", self._n_page_ins)
        for bucket, n in self.bucket_uses.items():
            flush("serve_dispatch_blocks_total", "padded blocks dispatched",
                  n, bucket=bucket)
        reg.gauge("serve_queue_depth",
                  "rows waiting + rows on the device").set(self.depth)
        reg.gauge("serve_in_flight_rows",
                  "rows riding the device queue").set(self._rows_in_flight)
        reg.gauge("serve_in_flight_blocks",
                  "blocks riding the device queue").set(
                      len(self._in_flight))
        reg.gauge("serve_arrival_rate",
                  "EWMA arrival rate, tickets/s").set(self._arrival_rate)
        reg.gauge("serve_service_ewma_seconds",
                  "EWMA block service time").set(self._service_ewma)
        # latency quantiles from the bounded reservoir (the Prometheus
        # client-side-summary pattern — a streaming per-query histogram
        # would add a record per query on the harvest path)
        p50, p99 = self.stats.percentiles(None)
        reg.gauge("serve_latency_seconds", "submit->harvest latency "
                  "(reservoir quantile)", quantile="0.5").set(p50)
        reg.gauge("serve_latency_seconds", "submit->harvest latency "
                  "(reservoir quantile)", quantile="0.99").set(p99)
        if self.watchdog is not None:
            flush("serve_recompiles_total", "serving-path executables "
                  "compiled after watchdog arm", self.watchdog.recompiles)

    def metrics(self) -> dict:
        """Latency + throughput snapshot.

        ``tenants``:  per-tenant {count, p50_s, p99_s, timeouts}
                      (percentiles over completed tickets, exactly
                      ``numpy.percentile``).
        ``overall``:  pooled percentiles, completed/expired counts, and
                      ``sustained_qps`` = completed tickets / (last
                      harvest - first submit).
        ``bucket_uses``: dispatch counts per autotuned bucket size.
        ``registry``:    the metrics-registry snapshot — engine, tier,
                         router and optimizer series in one schema (empty
                         sections when no registry was wired in).
        """
        tenants = {}
        ids = set(self.stats.samples) | set(self.stats.timeouts)
        for t in ids:
            p50, p99 = self.stats.percentiles(t)
            tenants[t] = {
                "count": self.stats.count(t),
                "p50_s": p50,
                "p99_s": p99,
                "timeouts": int(self.stats.timeouts.get(t, 0)),
            }
        p50, p99 = self.stats.percentiles(None)
        span = None
        if self._t_first_submit is not None \
                and self._t_last_harvest is not None:
            span = self._t_last_harvest - self._t_first_submit
        qps = (self._completed / span) if span and span > 0 else float("nan")
        return {
            "tenants": tenants,
            "overall": {
                "completed": self._completed,
                "expired": self._expired,
                "p50_s": p50,
                "p99_s": p99,
                "sustained_qps": qps,
            },
            "bucket_uses": dict(self.bucket_uses),
            "registry": self.registry.snapshot(),
        }
