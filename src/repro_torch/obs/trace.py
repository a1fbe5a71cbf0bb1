"""Lightweight span tracing for the serving pipeline.

Counterpart of ``repro/obs/trace.py`` (a stdlib copy), emitting the same
events under the same span names.

Usage::

    tracer = Tracer()
    with tracer.span("dispatch", tenant=7, bucket=64):
        ...
    tracer.write_jsonl("trace.jsonl")         # one event per line
    json.dump(tracer.to_chrome(), fh)         # chrome://tracing / Perfetto

Each ``span`` emits ONE Chrome-trace *complete* event (``"ph": "X"``) at
exit, stamped from ``time.perf_counter_ns`` (monotonic — wall-clock
adjustments can never produce negative durations).  ``instant`` emits a
zero-duration marker (``"ph": "i"``) for point events like hyperopt
progress callbacks.  Events carry the emitting thread id, so the
dispatcher thread and the caller thread render as separate tracks and
nesting is well-defined per track.

The buffer is bounded (default 1M events ≈ a few hundred MB of JSON at
most); past the bound events are dropped and counted in
:attr:`Tracer.dropped` rather than growing without limit — the same
policy the bounded ``LatencyStats`` reservoir follows.

:data:`NULL_TRACER` is the no-op default: ``span(...)`` returns a shared
singleton whose ``__enter__``/``__exit__`` do nothing, so instrumented
code costs one method call when tracing is off.  Hot-path call sites pass
no kwargs (kwargs would build a dict even for the null tracer); per-block
sites may attach bucket/tenant attributes freely.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "SPAN_SCHEMA_KEYS"]

# required keys of every emitted event — tools/check_trace.py validates
# emitted JSONL against exactly this contract
SPAN_SCHEMA_KEYS = ("name", "ph", "ts", "pid", "tid")

_PID = os.getpid()


class _Span:
    """Context manager recording one complete event on exit.  The buffer
    holds compact tuples ``("X", name, t0_ns, t1_ns, tid, args)`` — the
    JSON dict is only built at export time, keeping the record path to
    two clock reads, one tuple, and one list append under the lock."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        tr = self._tracer
        with tr._lock:
            if len(tr._events) < tr._limit:
                tr._events.append(
                    ("X", self._name, self._t0, t1,
                     threading.get_ident(), self._args)
                )
            else:
                tr.dropped += 1
        return False


class Tracer:
    """Buffering Chrome-trace emitter.  Thread-safe: spans may close on
    the dispatcher thread while the caller thread opens new ones."""

    def __init__(self, *, limit: int = 1_000_000) -> None:
        self._events: list = []
        self._lock = threading.Lock()
        self._limit = int(limit)
        self.dropped = 0

    # -- recording ----------------------------------------------------------

    def span(self, name: str, **args) -> _Span:
        """Open a span; the event is emitted when the ``with`` block
        exits.  Keyword arguments become Chrome-trace ``args``."""
        return _Span(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        """Emit a zero-duration point event (``ph: "i"``)."""
        t = time.perf_counter_ns()
        with self._lock:
            if len(self._events) < self._limit:
                self._events.append(
                    ("i", name, t, t, threading.get_ident(), args or None)
                )
            else:
                self.dropped += 1

    # -- export -------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self) -> list:
        """The buffered events as Chrome-trace JSON dicts (built here, at
        export time — the record path only stores tuples)."""
        with self._lock:
            raw = list(self._events)
        out = []
        for ph, name, t0, t1, tid, args in raw:
            ev = {"name": name, "ph": ph, "ts": t0 // 1000, "pid": _PID,
                  "tid": tid}
            if ph == "X":
                # both ends truncated to the microsecond, so a span that
                # nests another in nanoseconds still nests it (truncating
                # the duration instead can end a child after its parent)
                ev["dur"] = t1 // 1000 - t0 // 1000
            else:
                ev["s"] = "t"              # instant scope: thread
            if args:
                ev["args"] = args
            out.append(ev)
        return out

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def to_chrome(self) -> dict:
        """The Chrome ``traceEvents`` envelope — ``json.dump`` the result
        and load it in chrome://tracing or https://ui.perfetto.dev."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def write_jsonl(self, path) -> int:
        """Write one event per line (the format
        ``tools/check_trace.py`` validates); returns the number of events
        written."""
        evs = self.events()
        with open(path, "w") as fh:
            for ev in evs:
                fh.write(json.dumps(ev, separators=(",", ":")))
                fh.write("\n")
        return len(evs)


class _NullSpan:
    """Shared do-nothing span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """No-op tracer: ``span`` hands back a shared singleton, ``instant``
    returns immediately.  The default everywhere."""

    __slots__ = ()
    dropped = 0

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, **args) -> None:
        pass

    def __len__(self) -> int:
        return 0

    def events(self) -> list:
        return []

    def clear(self) -> None:
        pass

    def to_chrome(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def write_jsonl(self, path) -> int:
        with open(path, "w"):
            pass
        return 0


NULL_TRACER = NullTracer()
