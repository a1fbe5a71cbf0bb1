"""TieredBank — elastic tenant lifecycle in front of a fixed-capacity bank.

Counterpart of ``repro/bank/lifecycle.py``.  A :class:`~repro_torch.bank.GPBank`
is a *cache*: ``capacity`` device-resident slots.  ``TieredBank`` fronts one
with an elastic *store*: the working set stays hot on the device, every
other tenant lives as versioned checkpoints on disk, and membership churn
moves O(M^2) summary statistics — never raw training rows — between the
tiers:

* **Cold tier** — per-tenant versioned checkpoints through
  :mod:`repro_torch.checkpoint.gpstate` (the JAX package's on-disk format,
  so either package pages in the other's tier): each save lands as
  ``<cold_dir>/<tenant>/step_<version>`` with a manifest carrying the
  spec's structure and omega hash; restoring into a bank with a mismatched
  structure raises before any array loads.  Heterogeneous hyperparameters
  ride along (the unstacked state's spec carries its slot's own
  eps/rho/noise), so a tenant that was optimized, evicted and
  warm-restored serves under the hyperparameters it learned.
* **Hot/cold paging** — :meth:`mean_var` / :meth:`update` on a cold tenant
  warm-restore it through ``GPBank.insert``, evicting the least-recently
  used hot tenant to the cold tier when the bank is full.  Paging churn
  calls the same slot write every time (one shape signature:
  ``repro_torch.obs.serving_watchdog`` watches it).
* **Sliding-window forgetting** — :meth:`age` removes each tenant's rows
  beyond the newest ``window`` by the batched rank-k Cholesky downdate
  (``GPBank._downdate_at_slots``), falling back to a masked refit from the
  retained window (``GPBank._refit_at_slots``) for any tenant whose
  downdate lost positive definiteness.  Both run on power-of-two group
  buckets, padded with fully-masked groups aimed at distinct slots.
  ``serve_fleet`` wires this to ``BankRouter``'s staleness counters:
  drifted tenants get aged, then re-optimized.

Each tenant's window is kept host-side as two numpy arrays (rows (n, p)
and targets (n,), oldest first), where the JAX package keeps a list of
``(x, y)`` tuples: :meth:`age` forgets the same rows in the same order, and
a cold checkpoint's ``extra`` (``win_x``, ``win_y``) is the same.

The hot tier may be a :class:`~repro_torch.bank.ShardedGPBank`
(:meth:`adopt` takes either): a page-in then lands on the least-loaded
shard through its ``insert``, and aging runs per shard.

The bank reference is owned here between external swaps: a serving stack
that mutates the bank elsewhere (``BankRouter.ingest`` / ``reoptimize``)
hands the new bank back via :meth:`adopt` — ``FleetEngine`` does this
automatically when constructed with ``tiered=``.
"""
from __future__ import annotations

import urllib.parse
from collections import OrderedDict
from pathlib import Path
from typing import Hashable, Iterable, Optional, Sequence

import numpy as np
import torch

from ..checkpoint import gpstate
from ..core import fagp
from ..core.fagp import _f32
from ..obs import metrics as obs_metrics
from ..obs.trace import NULL_TRACER
from .bank import GPBank

__all__ = ["TieredBank"]


def _tenant_key(tenant: Hashable) -> str:
    """Filesystem-safe, reversible directory name for a tenant id.  The
    cold tier must enumerate its tenants from disk alone, so ids are
    restricted to the round-trippable types (int, str)."""
    if isinstance(tenant, bool):
        raise TypeError("bool tenant ids cannot live in a cold tier")
    if isinstance(tenant, (int, np.integer)):
        return f"i{int(tenant)}"
    if isinstance(tenant, str):
        return "s" + urllib.parse.quote(tenant, safe="")
    raise TypeError(
        f"cold-tier tenant ids must be int or str (got "
        f"{type(tenant).__name__}): the tier is enumerated from directory "
        f"names, which must round-trip"
    )


def _tenant_from_key(key: str) -> Hashable:
    if key.startswith("i"):
        return int(key[1:])
    if key.startswith("s"):
        return urllib.parse.unquote(key[1:])
    raise ValueError(f"not a tenant key: {key!r}")


def _pow2_bucket(n: int, cap: int) -> int:
    return min(cap, 1 << max(0, n - 1).bit_length())


def _host(a) -> np.ndarray:
    """A float32 host array of a tensor (any device), array or list."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def _rows_from(X, y, mask) -> tuple:
    """The (rows (n, p), targets (n,)) a tenant absorbed from X (N, p),
    y (N,) under a row mask (None: every row), as new float32 arrays."""
    X, y = _host(X), _host(y)
    if mask is None:
        return X.copy(), y.copy()
    keep = _host(mask) > 0
    return X[keep], y[keep]


def _rows_extra(rows: Optional[tuple]) -> Optional[dict]:
    """A window as a checkpoint's ``extra`` arrays (None when empty)."""
    if rows is None or not len(rows[1]):
        return None
    return {"win_x": rows[0], "win_y": rows[1]}


def _gather_groups(rows: list, k: int, p: int, bucket: int) -> tuple:
    """Groups (bucket, k, p) / (bucket, k) / mask of the given per-group
    (X, y) row sets, each zero-padded and masked to k rows; the groups past
    ``len(rows)`` are fully masked."""
    Xg = np.zeros((bucket, k, p), np.float32)
    yg = np.zeros((bucket, k), np.float32)
    mg = np.zeros((bucket, k), np.float32)
    for g, (X, y) in enumerate(rows):
        n = len(y)
        Xg[g, :n], yg[g, :n], mg[g, :n] = X, y, 1.0
    return Xg, yg, mg


def _pad_slots(slots: list, bucket: int, capacity: int) -> np.ndarray:
    """``slots`` padded to ``bucket`` entries with distinct unused slots
    (the scatters race on duplicates)."""
    used = set(slots)
    free = (s for s in range(capacity) if s not in used)
    return np.asarray(slots + [next(free) for _ in range(bucket - len(slots))], np.int64)


class TieredBank:
    """See module docstring.  Not thread-safe; one instance per serving
    loop, and between :meth:`adopt` calls it assumes it is the only
    writer of its bank.

    bank:     the hot tier (any constructed ``GPBank``).
    cold_dir: root of the cold tier (created if missing).  A directory
              that already holds checkpoints contributes its tenants as
              cold immediately — the tier is durable across processes.
    window:   sliding-window length W; 0 disables forgetting.  With
              W > 0, rows ingested through :meth:`update` /
              :meth:`record_rows` are tracked per tenant (host-side), and
              :meth:`age` downdates everything older than the newest W
              rows.  Window buffers ride cold checkpoints as ``extra``
              arrays, so paging preserves forgetting state.
    metrics:  a :class:`repro_torch.obs.MetricsRegistry`; the tier
              registers a scrape-time collector mirroring its ``stats``
              dict into ``lifecycle_*_total`` counters plus hot/cold
              tenant-count gauges.  Default: no-op.
    tracer:   a :class:`repro_torch.obs.Tracer`; checkpoint save/restore,
              evict-to-cold, and age/downdate/refit emit spans.
              Default: no-op.
    """

    def __init__(self, bank: GPBank, cold_dir, *, window: int = 0,
                 metrics: Optional[obs_metrics.MetricsRegistry] = None,
                 tracer=None):
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        self._bank = bank
        self.cold_dir = Path(cold_dir)
        self.cold_dir.mkdir(parents=True, exist_ok=True)
        self.window = int(window)
        self._lru: OrderedDict = OrderedDict((t, None) for t in bank.slots)
        self._cold: set = set()
        for p in self.cold_dir.iterdir():
            if p.is_dir() and gpstate.latest_version(p) is not None:
                t = _tenant_from_key(p.name)
                if t not in bank.slots:
                    self._cold.add(t)
        # per-tenant absorbed rows, oldest first: (X (n, p), y (n,)) — the
        # forgetting bookkeeping (window > 0 only)
        self._rows: dict = {}
        # lifecycle counters (observability + benchmark surface)
        self.stats = {
            "cold_saves": 0, "warm_restores": 0, "evictions": 0,
            "downdated_rows": 0, "refit_fallbacks": 0,
        }
        self.registry = obs_metrics.NULL if metrics is None else metrics
        self.tracer = NULL_TRACER if tracer is None else tracer
        self._published: dict = {}
        if not isinstance(self.registry, obs_metrics.NullRegistry):
            self.registry.add_collector(self._publish)

    def _publish(self) -> None:
        """Registry collector: mirror the ``stats`` dict into
        ``lifecycle_*_total`` counters (as deltas) and tier sizes into
        gauges — runs at scrape/snapshot time, never on a paging path."""
        reg = self.registry
        pub = self._published
        for key, total in self.stats.items():
            delta = total - pub.get(key, 0)
            if delta:
                reg.counter(f"lifecycle_{key}_total",
                            "TieredBank.stats mirror").inc(delta)
                pub[key] = total
        reg.gauge("lifecycle_hot_tenants",
                  "tenants resident in the hot bank").set(
                      len(self._bank.slots))
        reg.gauge("lifecycle_cold_tenants",
                  "tenants living only as cold checkpoints").set(
                      len(self._cold))

    # -- constructors --------------------------------------------------------

    @classmethod
    def fit(
        cls,
        Xb,
        yb,
        spec,
        *,
        cold_dir,
        capacity: Optional[int] = None,
        window: int = 0,
        tenant_ids: Optional[Sequence[Hashable]] = None,
        mask=None,
        metrics: Optional[obs_metrics.MetricsRegistry] = None,
        tracer=None,
    ) -> "TieredBank":
        """Fit B tenants into a tiered store with ``capacity`` hot slots:
        the first ``capacity`` tenants stay device-resident, the rest are
        fitted in batched chunks (the tenant axis padded to the hot capacity
        with fully-masked slots: one bank launch a chunk) and written
        straight to the cold tier.  Window buffers are seeded from the fit
        rows, so :meth:`age` counts them."""
        dev = spec.device
        Xb, yb = _f32(Xb, dev), _f32(yb, dev)
        B, N, p = Xb.shape
        ids = list(range(B)) if tenant_ids is None else list(tenant_ids)
        if len(ids) != B:
            raise ValueError(f"need {B} tenant ids, got {len(ids)}")
        cap = B if capacity is None else int(capacity)
        if cap < 1:
            raise ValueError(f"capacity must be >= 1, got {cap}")
        hot_n = min(cap, B)
        mask = None if mask is None else _f32(mask, dev)

        def seg(lo, hi):
            return Xb[lo:hi], yb[lo:hi], None if mask is None else mask[lo:hi]

        Xh, yh, mh = seg(0, hot_n)
        bank = GPBank.fit(Xh, yh, spec, mask=mh, tenant_ids=ids[:hot_n], capacity=cap)
        tb = cls(bank, cold_dir, window=window, metrics=metrics, tracer=tracer)
        if window:      # one host copy of the data, then per-tenant windows
            Xn, yn = _host(Xb), _host(yb)
            mn = None if mask is None else _host(mask)
            for j, t in enumerate(ids):
                tb._rows[t] = _rows_from(Xn[j], yn[j], None if mn is None else mn[j])
        # the remaining tenants: chunked batched fits through a scratch bank,
        # each chunk padded to hot_n tenants, then saved cold; only the
        # checkpoints remain
        for lo in range(hot_n, B, hot_n):
            hi = min(lo + hot_n, B)
            Xc, yc, mc = seg(lo, hi)
            n_real = hi - lo
            if n_real < hot_n:     # pad the tenant axis with masked slots
                pad = hot_n - n_real
                mc = torch.ones((n_real, N), device=dev) if mc is None else mc
                mc = torch.cat([mc, torch.zeros((pad, N), device=dev)])
                Xc = torch.cat([Xc, torch.zeros((pad, N, p), device=dev)])
                yc = torch.cat([yc, torch.zeros((pad, N), device=dev)])
            scratch = GPBank.fit(Xc, yc, spec, mask=mc, tenant_ids=range(hot_n))
            for j in range(n_real):
                t = ids[lo + j]
                gpstate.save_state(tb._cold_path(t), scratch.state(j),
                                   extra=_rows_extra(tb._rows.pop(t, None)))
                tb._cold.add(t)
                tb.stats["cold_saves"] += 1
        return tb

    # -- introspection -------------------------------------------------------

    @property
    def bank(self) -> GPBank:
        """The hot tier.  Serving stacks read this; anything that swaps
        the bank elsewhere must hand the result back via :meth:`adopt`."""
        return self._bank

    @property
    def spec(self):
        return self._bank.spec

    @property
    def capacity(self) -> int:
        return self._bank.capacity

    @property
    def hot_tenants(self) -> list:
        return self._bank.tenants

    @property
    def cold_tenants(self) -> list:
        return sorted(self._cold, key=repr)

    @property
    def tenants(self) -> list:
        return self.hot_tenants + self.cold_tenants

    def __len__(self) -> int:
        return len(self._bank.slots) + len(self._cold)

    def __contains__(self, tenant: Hashable) -> bool:
        return tenant in self._bank.slots or tenant in self._cold

    def is_hot(self, tenant: Hashable) -> bool:
        return tenant in self._bank.slots

    def version(self, tenant: Hashable) -> Optional[int]:
        """Newest cold-tier version of ``tenant`` (None when never
        saved)."""
        return gpstate.latest_version(self._cold_path(tenant))

    def _cold_path(self, tenant: Hashable) -> Path:
        return self.cold_dir / _tenant_key(tenant)

    # -- window bookkeeping (host-side) --------------------------------------

    def window_rows(self, tenant: Hashable) -> tuple:
        """``tenant``'s tracked rows, oldest first: (X (n, p), y (n,))."""
        p = self.spec.p
        return self._rows.get(tenant, (np.zeros((0, p), np.float32),
                                       np.zeros(0, np.float32)))

    def _append_rows(self, tenant: Hashable, rows: tuple) -> None:
        X0, y0 = self.window_rows(tenant)
        self._rows[tenant] = (np.concatenate([X0, rows[0]]), np.concatenate([y0, rows[1]]))

    def record_rows(self, tenant: Hashable, X, y, mask=None) -> None:
        """Append absorbed rows to ``tenant``'s window bookkeeping without
        touching the factorization — for rows that were ingested through
        an external path (``BankRouter.ingest``; ``FleetEngine`` calls
        this from its tiered ingest).  No-op when ``window == 0``."""
        if not self.window:
            return
        X = np.atleast_2d(_host(X))
        y = np.atleast_1d(_host(y))
        self._append_rows(tenant, _rows_from(X, y, mask))

    # -- cold tier: save / evict / restore -----------------------------------

    def save(self, tenant: Hashable) -> int:
        """Checkpoint a HOT tenant to the cold tier without evicting it
        (versioned: every save appends history).  Returns the version."""
        with self.tracer.span("checkpoint_save", tenant=str(tenant)):
            st = self._bank.state(tenant)  # hetero spec rides along
            ver = gpstate.save_state(self._cold_path(tenant), st,
                                     extra=_rows_extra(self._rows.get(tenant)))
        self.stats["cold_saves"] += 1
        return ver

    def evict_to_cold(self, tenant: Hashable) -> int:
        """Save ``tenant``'s current state as a new cold version, then
        free its hot slot (``GPBank.evict``).  Returns the version
        written."""
        with self.tracer.span("evict_to_cold", tenant=str(tenant)):
            ver = self.save(tenant)
            self._bank = self._bank.evict(tenant)
        self._lru.pop(tenant, None)
        self._cold.add(tenant)
        self.stats["evictions"] += 1
        return ver

    def _evict_victim(self, pinned: frozenset) -> None:
        for t in self._lru:            # oldest-touched first
            if t not in pinned:
                self.evict_to_cold(t)
                return
        raise RuntimeError(
            f"cannot page in: all {self.capacity} hot slots are pinned "
            f"(pending or in-flight work); raise the capacity or drain "
            f"first"
        )

    def page_in(self, tenant: Hashable, *,
                pinned: Iterable[Hashable] = ()) -> None:
        """Warm-restore a cold tenant into a hot slot, evicting the LRU
        unpinned tenant to the cold tier if the bank is full.  The restore
        rides ``GPBank.insert`` (the same slot write whatever the tenant).
        The checkpoint manifest is validated against the bank's spec
        structure BEFORE any array loads — a stale checkpoint from a
        different expansion/truncation/omega raises."""
        if tenant in self._bank.slots:
            return
        if tenant not in self._cold:
            raise KeyError(
                f"tenant {tenant!r} is in neither tier (hot: "
                f"{self.hot_tenants!r}; {len(self._cold)} cold)"
            )
        with self.tracer.span("checkpoint_restore", tenant=str(tenant)):
            _, st, extra = gpstate.load_state(
                self._cold_path(tenant), like_spec=self._bank.spec,
                device=self._bank.spec.device,
            )
        if self._bank.hypers is None and any(
            not fagp._leaf_equal(getattr(st.spec, f), getattr(self._bank.spec, f))
            for f in ("eps", "rho", "noise")
        ):
            # a tenant that learned its own hyperparameters cannot join a
            # homogeneous bank; promote the bank to heterogeneous (per-slot
            # overlay materialized once; B^-1 does not depend on it)
            self._bank = self._promoted(self._bank)
        if bool(np.all(self._bank.active)):     # no free slot: make one
            self._evict_victim(frozenset(pinned) | {tenant})
        self._bank = self._bank.insert(tenant, st)
        self._cold.discard(tenant)
        self._lru[tenant] = None
        self._lru.move_to_end(tenant)
        if self.window and "win_x" in extra:
            self._rows[tenant] = _rows_from(extra["win_x"], extra["win_y"], None)
        self.stats["warm_restores"] += 1

    @staticmethod
    def _promoted(bank: GPBank) -> GPBank:
        """``bank`` with its shared hyperparameters as a per-slot overlay
        (a sharded bank, homogeneous-only, refuses as in the JAX package)."""
        if getattr(bank, "mesh", None) is not None:
            raise ValueError(
                "ShardedGPBank is homogeneous-only: a tenant restored under its "
                "own hyperparameters needs a heterogeneous bank — convert with "
                "to_bank() first")
        h = bank._stacked_hypers()
        new = bank._with({}, hypers=type(h)(
            **{f: getattr(h, f).contiguous() for f in ("eps", "rho", "noise")}))
        binv = bank.__dict__.get("_binv_cache")
        if binv is not None:
            object.__setattr__(new, "_binv_cache", binv)
        return new

    def ensure_hot(self, tenants, *,
                   pinned: Iterable[Hashable] = ()) -> None:
        """Page in every cold tenant in ``tenants`` (deduplicated, first
        appearance first).  All of them are implicitly pinned — a batch
        can never evict one of its own members to admit another."""
        want = list(dict.fromkeys(tenants))
        if len(want) > self.capacity:
            raise ValueError(
                f"batch touches {len(want)} distinct tenants but only "
                f"{self.capacity} hot slots exist; split the batch"
            )
        pin = frozenset(pinned) | set(want)
        for t in want:
            if t not in self._bank.slots:
                self.page_in(t, pinned=pin)

    def adopt(self, bank: GPBank) -> None:
        """Hand back a bank that was swapped outside this tier (router
        ingest / reoptimize).  Membership metadata is re-synced
        defensively; per-tenant window buffers key on tenant ids, so they
        survive any swap that keeps ids stable."""
        self._bank = bank
        for t in list(self._lru):
            if t not in bank.slots:
                del self._lru[t]
        for t in bank.slots:
            if t not in self._lru:
                self._lru[t] = None

    def _touch(self, tenants) -> None:
        for t in dict.fromkeys(tenants):
            if t in self._lru:
                self._lru.move_to_end(t)

    # -- serving (page-through wrappers) -------------------------------------

    def mean_var(self, tenant_ids, Xq):
        """Mixed-tenant ``mean_var`` over BOTH tiers: cold tenants are
        warm-restored first (members of the batch are pinned against each
        other), then one batched hot call answers everything."""
        ids = list(tenant_ids)
        self.ensure_hot(ids)
        self._touch(ids)
        return self._bank.mean_var(ids, Xq)

    def update(self, tenant_ids, Xk, yk, mask=None) -> GPBank:
        """Batched rank-k ingest over both tiers: cold tenants page in,
        then one ``GPBank.update`` absorbs every group.  Absorbed rows
        enter the window bookkeeping (mask-aware).  Returns the new hot
        bank (also adopted internally)."""
        ids = list(tenant_ids)
        self.ensure_hot(ids)
        self._touch(ids)
        self._bank = self._bank.update(ids, Xk, yk, mask)
        if self.window:
            Xk, yk = _host(Xk), _host(yk)
            mk = None if mask is None else _host(mask)
            for g, t in enumerate(ids):
                self._append_rows(t, _rows_from(Xk[g], yk[g], None if mk is None else mk[g]))
        return self._bank

    def insert(self, tenant: Hashable, source) -> None:
        """Admit a NEW tenant (id unknown to both tiers), evicting the LRU
        hot tenant to the cold tier when the bank is full.  ``source`` is
        anything ``GPBank.insert`` takes; (X, y) tuples additionally seed
        the window bookkeeping."""
        if tenant in self:
            raise ValueError(f"tenant {tenant!r} already in the tier")
        _tenant_key(tenant)            # fail before mutating on bad ids
        if bool(np.all(self._bank.active)):
            self._evict_victim(frozenset({tenant}))
        self._bank = self._bank.insert(tenant, source)
        self._lru[tenant] = None
        self._lru.move_to_end(tenant)
        if self.window and isinstance(source, tuple):
            X, y = source
            self._rows[tenant] = _rows_from(X, y, None)

    # -- sliding-window forgetting -------------------------------------------

    def age(self, tenant_ids=None) -> dict:
        """Forget everything older than each tenant's newest ``window``
        rows: one bucketed batched rank-k downdate for every over-window
        tenant, then one bucketed masked refit from the retained window
        for any group whose downdate lost positive definiteness.  Cold
        tenants in ``tenant_ids`` are paged in first (aging is a
        factorization rewrite).  Returns
        ``{"aged": [...], "forgotten_rows": n, "refit": [...]}``."""
        out = {"aged": [], "forgotten_rows": 0, "refit": []}
        if not self.window:
            return out
        cands = list(dict.fromkeys(
            self.tenants if tenant_ids is None else tenant_ids
        ))
        over = [t for t in cands if len(self.window_rows(t)[1]) > self.window]
        if not over:
            return out
        with self.tracer.span("age", tenants=len(over)):
            return self._age_over(over, out)

    def _age_over(self, over: list, out: dict) -> dict:
        self.ensure_hot(over)
        self._touch(over)
        W = self.window
        p = self.spec.p
        excess = {t: (self._rows[t][0][:-W], self._rows[t][1][:-W]) for t in over}
        kmax = _pow2_bucket(max(len(r[1]) for r in excess.values()), 1 << 30)
        bucket = _pow2_bucket(len(over), self.capacity)
        slots = _pad_slots([self._bank.slot_of(t) for t in over], bucket, self.capacity)
        Xg, yg, mg = _gather_groups([excess[t] for t in over], kmax, p, bucket)
        with self.tracer.span("downdate", groups=bucket):
            self._bank, ok = self._bank._downdate_at_slots(slots, Xg, yg, mg)
        failed = [t for g, t in enumerate(over) if not ok[g]]
        if failed:
            # refit the survivors' factorizations from their retained
            # window (ragged-capable: masked), same bucketing discipline
            fbucket = _pow2_bucket(len(failed), self.capacity)
            fslots = _pad_slots([self._bank.slot_of(t) for t in failed], fbucket,
                                self.capacity)
            Xw, yw, mw = _gather_groups(
                [(self._rows[t][0][-W:], self._rows[t][1][-W:]) for t in failed], W, p,
                fbucket)
            with self.tracer.span("refit", groups=fbucket):
                self._bank = self._bank._refit_at_slots(fslots, Xw, yw, mw)
            self.stats["refit_fallbacks"] += len(failed)
        for t in over:
            X, y = self._rows[t]
            self._rows[t] = (X[-W:], y[-W:])
        n_forgot = sum(len(r[1]) for r in excess.values())
        self.stats["downdated_rows"] += n_forgot
        out.update(aged=over, forgotten_rows=n_forgot, refit=failed)
        return out
