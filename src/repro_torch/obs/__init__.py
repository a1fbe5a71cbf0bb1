"""Zero-dependency fleet telemetry: metrics, span tracing, recompile
watchdog, exporters.

Counterpart of ``repro/obs`` with the same names (the port keeps its own
copy and imports nothing of the JAX package).  Everything here is
stdlib-only except :func:`serving_watchdog`, which lazily imports the
serving functions it guards.  The serving stack takes
``metrics=``/``tracer=``/``watchdog=`` keyword arguments and defaults to the
no-op implementations, so telemetry is strictly opt-in and costs one
attribute lookup per instrumented site when off.
"""
from .export import MetricsServer, start_metrics_server
from .metrics import (
    Counter,
    DEFAULT_LATENCY_BUCKETS,
    Gauge,
    Histogram,
    MetricsRegistry,
    NULL,
    NullRegistry,
    get_default,
    set_default,
)
from .trace import NULL_TRACER, NullTracer, SPAN_SCHEMA_KEYS, Tracer
from .watchdog import RecompileError, RecompileWatchdog, serving_watchdog

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullRegistry",
    "NULL",
    "get_default",
    "set_default",
    "DEFAULT_LATENCY_BUCKETS",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "SPAN_SCHEMA_KEYS",
    "RecompileError",
    "RecompileWatchdog",
    "serving_watchdog",
    "MetricsServer",
    "start_metrics_server",
]
