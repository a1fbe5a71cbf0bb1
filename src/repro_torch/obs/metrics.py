"""Process-local metrics: counters, gauges, and fixed-bucket histograms.

Counterpart of ``repro/obs/metrics.py`` (a stdlib copy: the port imports
nothing of the JAX package), with the same series names and the same
exposition text for the same events.  The serving stack (FleetEngine /
BankRouter / TieredBank / GPBank.optimize) is instrumented against this
registry.  Design constraints, in order:

* **Cheap when off.** Telemetry defaults to :data:`NULL` (a
  :class:`NullRegistry`): every instrument it hands out is a shared
  singleton whose record methods are empty — an instrumented call site
  costs one attribute lookup and one no-op call, and allocates NOTHING
  (pinned by tests/test_torch_obs.py with ``tracemalloc``).
* **Cheap when on.** Instruments are resolved ONCE at construction time
  (``self._c_admitted = registry.counter(...)``), never looked up per
  event; recording is O(1) under one registry-wide lock — an integer add
  for counters/gauges, a ``bisect`` into a fixed bucket ladder for
  histograms.  No allocation on the record path.
* **One schema.** :meth:`MetricsRegistry.snapshot` returns a
  JSON-serializable dict and :meth:`MetricsRegistry.render_prometheus`
  the text exposition format — the same series names either way, so the
  ``/metrics`` endpoint and ``FleetEngine.metrics()["registry"]`` agree.

Zero third-party dependencies (stdlib only): the checkpoint store and the
kernel-free host layers import this module freely, in any environment.
"""
from __future__ import annotations

import threading
import weakref
from bisect import bisect_left
from functools import partial
from typing import Optional

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullRegistry",
    "NULL", "get_default", "set_default", "DEFAULT_LATENCY_BUCKETS",
]

# upper bounds (seconds, inclusive — Prometheus ``le`` semantics) for
# latency-shaped histograms: 10µs .. 10s log ladder, +Inf implicit
DEFAULT_LATENCY_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _series(name: str, labels: tuple) -> str:
    """The canonical series key: ``name`` or ``name{k="v",...}`` — shared
    by snapshot() and render_prometheus() so both views line up."""
    if not labels:
        return name
    inner = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in labels
    )
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing count.  ``inc`` is the only mutator."""

    __slots__ = ("name", "labels", "help", "value", "_lock")

    def __init__(self, name: str, labels: tuple, help: str,
                 lock: threading.Lock):
        self.name = name
        self.labels = labels
        self.help = help
        self.value = 0
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    @property
    def series(self) -> str:
        return _series(self.name, self.labels)


class Gauge:
    """A value that goes up and down (queue depth, in-flight rows)."""

    __slots__ = ("name", "labels", "help", "value", "_lock")

    def __init__(self, name: str, labels: tuple, help: str,
                 lock: threading.Lock):
        self.name = name
        self.labels = labels
        self.help = help
        self.value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self.value -= n

    @property
    def series(self) -> str:
        return _series(self.name, self.labels)


class Histogram:
    """Fixed-bucket histogram (Prometheus cumulative-``le`` semantics:
    bucket i counts observations ``<= bounds[i]``; the last, implicit
    bucket is +Inf).  The bucket ladder is FIXED at creation — recording
    is one ``bisect`` plus an integer add, no allocation."""

    __slots__ = ("name", "labels", "help", "bounds", "counts", "sum",
                 "count", "_lock")

    def __init__(self, name: str, labels: tuple, help: str,
                 lock: threading.Lock, bounds: tuple = DEFAULT_LATENCY_BUCKETS):
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError(f"histogram bounds must be sorted: {bounds!r}")
        self.name = name
        self.labels = labels
        self.help = help
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(bounds) + 1)      # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self._lock = lock

    def record(self, v: float) -> None:
        i = bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def record_many(self, vals) -> None:
        """Bulk record under ONE lock acquisition (harvest records a whole
        block's worth at once).  ``map`` over a pre-bound C ``bisect``
        keeps the per-value cost ~135ns."""
        counts = self.counts
        bl = partial(bisect_left, self.bounds)
        with self._lock:
            n = 0
            for i in map(bl, vals):
                counts[i] += 1
                n += 1
            self.sum += sum(vals)
            self.count += n

    @property
    def series(self) -> str:
        return _series(self.name, self.labels)


class MetricsRegistry:
    """Get-or-create instrument factory + exporter.  One lock guards both
    the instrument table and every record (records are single integer
    ops; a striped-lock design would buy nothing at serving rates)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict = {}          # (name, labels) -> instrument
        self._kinds: dict = {}            # name -> class (conflict guard)
        self._collectors: list = []

    def add_collector(self, fn) -> None:
        """Register a zero-arg callable invoked before every
        ``snapshot()``/``render_prometheus()``.  This is how the engine /
        router / tier flush their plain-int hot-path counters into the
        registry: the serving loop pays NOTHING per event, and scrapes
        are always fresh (the Prometheus client-library collector
        pattern).

        Bound methods are held via ``weakref.WeakMethod``: a registry
        outlives the engines that register against it, and a strong ref
        here would pin every dead engine (and its bank) forever.  A
        collector whose owner is collected is dropped silently — its
        counter totals up to the last scrape remain; deltas it never
        flushed are lost with it.  Plain functions/closures are held
        strongly (nothing else owns them)."""
        try:
            ref = weakref.WeakMethod(fn)
        except TypeError:
            ref = lambda: fn
        with self._lock:
            self._collectors.append(ref)

    def _collect(self) -> None:
        with self._lock:
            refs = list(self._collectors)
        dead = []
        for ref in refs:
            fn = ref()
            if fn is None:
                dead.append(ref)
            else:
                fn()
        if dead:
            with self._lock:
                self._collectors = [
                    r for r in self._collectors if r not in dead
                ]

    def _get(self, cls, name: str, help: str, labels: dict, **kw):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            have = self._kinds.get(name)
            if have is not None and have is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{have.__name__}, not {cls.__name__}"
                )
            inst = self._metrics.get(key)
            if inst is None:
                inst = cls(name, key[1], help, self._lock, **kw)
                self._metrics[key] = inst
                self._kinds[name] = cls
            elif kw.get("bounds") and inst.bounds != tuple(
                float(b) for b in kw["bounds"]
            ):
                raise ValueError(
                    f"histogram {name!r} re-registered with different "
                    f"buckets"
                )
            return inst

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = DEFAULT_LATENCY_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, help, labels, bounds=buckets)

    # -- exporters ----------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-serializable view: ``{"counters": {series: int},
        "gauges": {series: float}, "histograms": {series: {"buckets":
        {"le": count (cumulative)}, "sum": s, "count": n}}}``."""
        self._collect()
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            items = list(self._metrics.values())
        for m in items:
            if isinstance(m, Counter):
                out["counters"][m.series] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][m.series] = m.value
            else:
                cum, buckets = 0, {}
                for b, c in zip(m.bounds, m.counts):
                    cum += c
                    buckets[repr(b)] = cum
                buckets["+Inf"] = cum + m.counts[-1]
                out["histograms"][m.series] = {
                    "buckets": buckets, "sum": m.sum, "count": m.count,
                }
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4): ``# HELP``/
        ``# TYPE`` once per metric name, one line per series; histograms
        expand to cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``
        exactly as the exposition format specifies."""
        self._collect()
        with self._lock:
            items = list(self._metrics.values())
        by_name: dict = {}
        for m in items:
            by_name.setdefault(m.name, []).append(m)
        lines = []
        for name, series in by_name.items():
            kind = {Counter: "counter", Gauge: "gauge",
                    Histogram: "histogram"}[type(series[0])]
            if series[0].help:
                lines.append(f"# HELP {name} {series[0].help}")
            lines.append(f"# TYPE {name} {kind}")
            for m in series:
                if isinstance(m, Histogram):
                    cum = 0
                    for b, c in zip(m.bounds, m.counts):
                        cum += c
                        lines.append(
                            f"{_series(name + '_bucket', m.labels + (('le', repr(b)),))} {cum}"
                        )
                    lines.append(
                        f"{_series(name + '_bucket', m.labels + (('le', '+Inf'),))} {cum + m.counts[-1]}"
                    )
                    lines.append(f"{_series(name + '_sum', m.labels)} {m.sum}")
                    lines.append(
                        f"{_series(name + '_count', m.labels)} {m.count}"
                    )
                else:
                    lines.append(f"{m.series} {m.value}")
        return "\n".join(lines) + "\n"


class _NullInstrument:
    """The one no-op instrument: every record method is empty, every call
    returns immediately, nothing is ever allocated."""

    __slots__ = ()

    def inc(self, n=1):
        pass

    def dec(self, n=1):
        pass

    def set(self, v):
        pass

    def record(self, v):
        pass

    def record_many(self, vals):
        pass


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry(MetricsRegistry):
    """The default registry: hands out the shared no-op instrument, so
    instrumented code paths cost one attribute lookup + one empty call
    when telemetry is off.  ``snapshot()``/``render_prometheus()`` report
    nothing."""

    def __init__(self) -> None:
        super().__init__()

    def counter(self, name, help="", **labels):
        return _NULL_INSTRUMENT

    def gauge(self, name, help="", **labels):
        return _NULL_INSTRUMENT

    def histogram(self, name, help="", buckets=DEFAULT_LATENCY_BUCKETS,
                  **labels):
        return _NULL_INSTRUMENT


NULL = NullRegistry()

# process default: what module-level instrumentation (the checkpoint
# store's crash-recovery counters) records against when nobody wired an
# explicit registry through.  serve_gp sets this to its live registry.
_default: MetricsRegistry = NULL


def get_default() -> MetricsRegistry:
    return _default


def set_default(registry: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Install ``registry`` as the process default (None restores the
    no-op NULL).  Returns the previous default so callers can restore
    it."""
    global _default
    prev = _default
    _default = NULL if registry is None else registry
    return prev
