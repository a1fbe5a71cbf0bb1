"""The port's telemetry (``repro_torch.obs``) against the JAX package's
(``repro.obs``): the cases of tests/test_obs.py on the port, the exposition
text of both registries for the same events, and the span names and metric
series of the same instrumented fleet in both packages.

The registry, tracer and exporter are stdlib copies; the watchdog counts
the serving functions' shape signatures (``shape_tracked``) and the kernel
builds where the JAX package counts jit executables."""
import gc
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import threading
import urllib.request
from pathlib import Path
from random import Random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hypcompat import given, settings, st  # noqa: E402
from test_torch_common import gp_data, specs, tt  # noqa: E402

import repro.obs as jobs  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro.bank import BankRouter as JRouter  # noqa: E402
from repro.bank import FleetEngine as JEngine  # noqa: E402
from repro.bank import GPBank as JBank  # noqa: E402
from repro_torch.bank import BankRouter, FleetEngine, GPBank, LatencyStats  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    NULL,
    NULL_TRACER,
    MetricsRegistry,
    NullTracer,
    RecompileError,
    RecompileWatchdog,
    SPAN_SCHEMA_KEYS,
    Tracer,
    serving_watchdog,
    set_default,
    start_metrics_server,
)
from repro_torch.obs.metrics import _NULL_INSTRUMENT  # noqa: E402
from repro_torch.obs.watchdog import shape_tracked  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

_spec = importlib.util.spec_from_file_location("check_trace", ROOT / "tools" / "check_trace.py")
check_trace_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check_trace_mod)


def _fleet_data(B, N, p, seed=0):
    Xb = np.zeros((B, N, p), np.float32)
    yb = np.zeros((B, N), np.float32)
    for s in range(B):
        Xb[s], yb[s] = gp_data(N, p, seed + s)
    return Xb, yb


def _banks(B=4, N=8, p=2, n=4):
    """The same fleet in both packages: (jax bank, port bank)."""
    Xb, yb = _fleet_data(B, N, p)
    js, ts = specs("hermite", p, n=n)
    return JBank.fit(jnp.asarray(Xb), jnp.asarray(yb), js), GPBank.fit(tt(Xb), tt(yb), ts)


# --------------------------------------------------------------------------
# registry: instrument semantics (tests/test_obs.py's cases)
# --------------------------------------------------------------------------


def test_counter_monotone_and_labelled_series():
    reg = MetricsRegistry()
    c = reg.counter("reqs_total", "requests", tenant="a")
    c.inc()
    c.inc(4)
    assert c.value == 5
    assert c.series == 'reqs_total{tenant="a"}'
    assert reg.counter("reqs_total", tenant="a") is c
    other = reg.counter("reqs_total", tenant="b")
    assert other is not c and other.value == 0


def test_gauge_set_inc_dec():
    g = MetricsRegistry().gauge("depth")
    g.set(7.0)
    g.inc(2.0)
    g.dec()
    assert g.value == 8.0


def test_histogram_buckets_are_le_inclusive():
    reg = MetricsRegistry()
    h = reg.histogram("lat", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 2.0, 3.0, 100.0):
        h.record(v)
    snap = reg.snapshot()["histograms"]["lat"]
    assert snap["buckets"] == {"1.0": 1, "2.0": 2, "4.0": 3, "+Inf": 4}
    assert snap["count"] == 4
    assert snap["sum"] == pytest.approx(105.5)


def test_record_many_matches_loop_of_records():
    vals = list(np.random.default_rng(0).exponential(0.01, 200))
    r1, r2 = MetricsRegistry(), MetricsRegistry()
    h1, h2 = r1.histogram("h"), r2.histogram("h")
    for v in vals:
        h1.record(v)
    h2.record_many(vals)
    assert h1.counts == h2.counts and h1.count == h2.count
    assert h1.sum == pytest.approx(h2.sum)


def test_type_conflict_and_bucket_redefinition_rejected():
    reg = MetricsRegistry()
    reg.counter("x_total")
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("x_total")
    reg.histogram("h", buckets=(1.0, 2.0))
    with pytest.raises(ValueError, match="different"):
        reg.histogram("h", buckets=(1.0, 2.0, 3.0))
    with pytest.raises(ValueError, match="sorted"):
        reg.histogram("h2", buckets=(2.0, 1.0))


def test_concurrent_recording_is_exact():
    reg = MetricsRegistry()
    c = reg.counter("hits_total")
    h = reg.histogram("work", buckets=(0.5,))

    def pound():
        for _ in range(5000):
            c.inc()
            h.record(0.25)

    threads = [threading.Thread(target=pound) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert c.value == 20000
    assert h.count == 20000 and h.counts[0] == 20000


# --------------------------------------------------------------------------
# exporters: one schema, two views; the same text as the JAX registry's
# --------------------------------------------------------------------------


def _populate(reg):
    reg.counter("served_total", "queries served", tenant="a").inc(3)
    reg.counter("served_total", tenant="b").inc(5)
    reg.gauge("queue_depth").set(11)
    h = reg.histogram("latency_seconds", buckets=(0.01, 0.1))
    for v in (0.005, 0.05, 0.5):
        h.record(v)
    return reg


def test_exposition_equals_the_jax_registrys():
    """The same events give the same text and the same snapshot in both
    packages, byte for byte."""
    mine, ref = _populate(MetricsRegistry()), _populate(jobs.MetricsRegistry())
    assert mine.render_prometheus() == ref.render_prometheus()
    assert mine.snapshot() == ref.snapshot()
    assert tobs.__all__ == jobs.__all__
    assert tobs.SPAN_SCHEMA_KEYS == jobs.SPAN_SCHEMA_KEYS
    assert tobs.DEFAULT_LATENCY_BUCKETS == jobs.DEFAULT_LATENCY_BUCKETS


def test_snapshot_schema():
    snap = _populate(MetricsRegistry()).snapshot()
    assert set(snap) == {"counters", "gauges", "histograms"}
    assert snap["counters"]['served_total{tenant="a"}'] == 3
    assert snap["gauges"]["queue_depth"] == 11
    json.dumps(snap)


def test_prometheus_round_trip_matches_snapshot():
    reg = _populate(MetricsRegistry())
    snap = reg.snapshot()
    values = {}
    for line in reg.render_prometheus().splitlines():
        if line.startswith("#") or not line:
            continue
        series, val = line.rsplit(" ", 1)
        values[series] = float(val)
    for section in ("counters", "gauges"):
        for series, v in snap[section].items():
            assert values[series] == v
    assert values['latency_seconds_bucket{le="0.01"}'] == 1
    assert values['latency_seconds_bucket{le="0.1"}'] == 2
    assert values['latency_seconds_bucket{le="+Inf"}'] == 3
    assert values["latency_seconds_count"] == 3


def test_http_endpoint_serves_both_formats():
    reg = _populate(MetricsRegistry())
    server = start_metrics_server(reg, port=0)
    try:
        with urllib.request.urlopen(server.url, timeout=5) as r:
            body = r.read().decode()
        assert 'served_total{tenant="a"} 3' in body
        with urllib.request.urlopen(server.url + ".json", timeout=5) as r:
            assert json.loads(r.read()) == reg.snapshot()
    finally:
        server.shutdown()


def test_collectors_flush_at_scrape_and_die_with_owner():
    reg = MetricsRegistry()

    class Engine:
        def __init__(self):
            self.flushes = 0

        def flush(self):
            self.flushes += 1
            reg.counter("flushes_total").inc()

    eng = Engine()
    reg.add_collector(eng.flush)
    reg.snapshot()
    reg.render_prometheus()
    assert eng.flushes == 2
    del eng
    gc.collect()
    assert reg.snapshot()["counters"]["flushes_total"] == 2
    assert len(reg._collectors) == 0
    hits = []
    reg.add_collector(lambda: hits.append(1))
    gc.collect()
    reg.snapshot()
    assert hits == [1]


# --------------------------------------------------------------------------
# tracer: valid Chrome-trace JSONL under any interleaving
# --------------------------------------------------------------------------


def _emit_random_tree(tracer, rng, depth=0):
    for i in range(rng.randrange(0, 4 - depth)):
        with tracer.span(f"d{depth}_{i}", depth=depth):
            if depth < 3 and rng.random() < 0.7:
                _emit_random_tree(tracer, rng, depth + 1)
            if rng.random() < 0.4:
                tracer.instant("tick", i=i)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_random_interleavings_validate(seed):
    tracer = Tracer()
    worker = threading.Thread(target=_emit_random_tree, args=(tracer, Random(seed + 1)))
    worker.start()
    _emit_random_tree(tracer, Random(seed))
    worker.join(timeout=60)
    assert not worker.is_alive()
    with tracer.span("outer"):
        with tracer.span("inner"):
            pass
    for ev in tracer.events():
        assert all(k in ev for k in SPAN_SCHEMA_KEYS)
        assert ev["ph"] in ("X", "i")
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "t.jsonl"
        assert tracer.write_jsonl(path) == len(tracer)
        assert check_trace_mod.check_trace(path, expect=("outer", "inner")) == []


def test_export_keeps_nanosecond_nesting(tmp_path):
    """A child that ends in the parent's last microsecond still nests once
    exported: the parent [210.9, 219.0] us and the child [217.0, 219.0] us
    export as [210, 219] and [217, 219] (truncating the parent's duration
    instead gave [210, 218], which the validator rejects)."""
    tracer = Tracer()
    tid = threading.get_ident()
    tracer._events += [("X", "child", 217_000, 219_000, tid, None),
                       ("X", "parent", 210_900, 219_000, tid, None)]
    ends = {ev["name"]: (ev["ts"], ev["ts"] + ev["dur"]) for ev in tracer.events()}
    assert ends == {"parent": (210, 219), "child": (217, 219)}
    path = tmp_path / "t.jsonl"
    tracer.write_jsonl(path)
    assert check_trace_mod.check_trace(path, expect=("parent", "child")) == []


def test_buffer_bound_counts_drops_and_envelope(tmp_path):
    tracer = Tracer(limit=3)
    for i in range(5):
        tracer.instant(f"e{i}")
    assert len(tracer) == 3 and tracer.dropped == 2
    tracer.clear()
    assert len(tracer) == 0 and tracer.dropped == 0
    with tracer.span("s", bucket=8):
        pass
    doc = tracer.to_chrome()
    assert doc["traceEvents"][0]["args"] == {"bucket": 8}
    assert doc["displayTimeUnit"] == "ms"
    p = tmp_path / "empty.jsonl"
    assert NullTracer().write_jsonl(p) == 0
    assert p.read_text() == ""


# --------------------------------------------------------------------------
# recompile watchdog over shape registries and kernel builds
# --------------------------------------------------------------------------


def test_catches_shape_polymorphic_call():
    f = shape_tracked(lambda x: x * 2.0)
    f(torch.zeros(4))
    wd = RecompileWatchdog(mode="raise").register("f", f)
    wd.arm()
    f(torch.ones(4))                 # same signature: nothing grows
    assert wd.check("steady") == {}
    f(torch.zeros(8))                # a new shape: a new signature
    with pytest.raises(RecompileError, match=r"f \+1"):
        wd.check("leak")
    assert wd.recompiles == 1 and wd.events[0][0] == "leak"
    assert wd.check("after") == {}
    f(torch.zeros(8, dtype=torch.float64))   # a dtype drift is one too
    assert f._cache_size() == 3


def test_warn_and_count_modes():
    f = shape_tracked(lambda x: x + 1.0)
    f(torch.zeros(2))
    reg = MetricsRegistry()
    wd = RecompileWatchdog(mode="warn", counter=reg.counter("recompiles_total"))
    wd.register("f", f).arm()
    f(torch.zeros(3))
    with pytest.warns(RuntimeWarning, match="recompile detected"):
        wd.check("churn")
    assert reg.snapshot()["counters"]["recompiles_total"] == 1
    wd.mode = "count"
    f(torch.zeros(5))
    assert wd.check() == {"f": 1}
    assert wd.recompiles == 2


def test_register_rejects_untracked():
    with pytest.raises(TypeError, match="_cache_size"):
        RecompileWatchdog().register("f", lambda x: x)
    with pytest.raises(ValueError, match="mode"):
        RecompileWatchdog(mode="explode")


def test_serving_watchdog_covers_the_serving_path_under_the_jax_names():
    """The port registers every serving-path name of the JAX package's
    watchdog, the sharded bank's ``bank_shard_*`` too, plus its kernel
    builds."""
    reg = MetricsRegistry()
    wd = serving_watchdog(mode="count", metrics=reg)
    jwd = jobs.serving_watchdog(mode="count")
    assert set(wd.sizes()) == set(jwd.sizes()) | {"kernel_builds"}
    assert "serve_recompiles_total" in reg.snapshot()["counters"]


def test_watchdog_counts_kernel_builds_after_arm(monkeypatch):
    wd = serving_watchdog(mode="count")
    wd.arm()
    base = _build.build_count()
    monkeypatch.setattr(_build, "build_count", lambda: base + 2)   # two nvcc runs
    assert wd.check("build") == {"kernel_builds": 2}


def test_silent_across_engine_churn():
    _, bank = _banks()
    wd = serving_watchdog(mode="count")
    router = BankRouter(bank, microbatch=8, ingest_chunk=4)
    eng = FleetEngine(router, auto_pump=False, max_coalesce=2, watchdog=wd)
    rng = np.random.default_rng(7)
    for rung in eng.buckets:
        for _ in range(rung):
            eng.submit(int(rng.integers(0, 4)), rng.uniform(-1, 1, 2).astype(np.float32))
        eng.pump(max_blocks=1)
        eng.drain()
    for t in range(4):
        eng.observe(t, rng.uniform(-1, 1, 2).astype(np.float32), float(rng.normal()))
    eng.ingest()
    wd.arm()
    wd.recompiles, wd.events = 0, []
    wd.mode = "raise"
    for _ in range(6):
        for _ in range(int(rng.integers(1, 17))):
            eng.submit(int(rng.integers(0, 4)), rng.uniform(-1, 1, 2).astype(np.float32))
        for t in range(4):
            eng.observe(t, rng.uniform(-1, 1, 2).astype(np.float32), float(rng.normal()))
        eng.drain()
        eng.ingest()
    wd.check("churn-final")
    assert wd.recompiles == 0 and wd.events == []


# --------------------------------------------------------------------------
# the off switch, the bounded reservoir
# --------------------------------------------------------------------------


def test_null_registry_hands_out_the_shared_singleton():
    assert NULL.counter("a") is _NULL_INSTRUMENT
    assert NULL.gauge("b") is NULL.histogram("c")
    assert NULL.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


def test_record_path_is_allocation_free():
    import tracemalloc

    from repro_torch.obs import metrics as m
    from repro_torch.obs import trace as tr
    c = NULL.counter("x")
    h = NULL.histogram("y")
    span = NULL_TRACER.span("s")
    obs_files = {m.__file__, tr.__file__}

    def record():
        c.inc()
        c.inc(3)
        h.record(0.5)
        h.record_many((0.1, 0.2))
        with span:
            pass
        NULL_TRACER.instant("i")

    # one call before the window: the interpreter's one-time work on a code
    # object's first call (after a failed hypothesis example has switched
    # sys.monitoring on, its per-code monitoring data) is not the record path
    record()
    tracemalloc.start()
    try:
        s0 = tracemalloc.take_snapshot()
        for _ in range(2000):
            record()
        s1 = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    leaked = [stat for stat in s1.compare_to(s0, "lineno") if stat.size_diff > 0
              and any(fr.filename in obs_files for fr in stat.traceback)]
    assert leaked == [], [str(s) for s in leaked]


def test_reservoir_bounded_and_uniform():
    stats = LatencyStats(bound=8)
    for i in range(8):
        stats.record("t", float(i))
    assert stats.samples["t"] == [float(i) for i in range(8)]
    stats = LatencyStats(bound=64, seed=1)
    n = 6400
    for i in range(n):
        stats.record("t", float(i))
    assert len(stats.samples["t"]) == 64 and stats.count("t") == n
    assert abs(np.mean(stats.samples["t"]) - (n - 1) / 2) < 900
    with pytest.raises(ValueError):
        LatencyStats(bound=0)
    stats = LatencyStats(bound=4)
    stats.record("t", 0.01)
    stats.record_timeout("t")
    assert stats.count("t") == 1 and stats.timeouts["t"] == 1


# --------------------------------------------------------------------------
# instrumented engine end-to-end, against the JAX package's
# --------------------------------------------------------------------------


def _instrumented_run(pkg):
    """16 queries, one ingest round and a drain through an instrumented
    router and engine of one package: (span names, registry snapshot)."""
    jbank, tbank = _banks()
    if pkg == "jax":
        Router, Engine, bank, reg, tracer = JRouter, JEngine, jbank, jobs.MetricsRegistry(), \
            jobs.Tracer()
    else:
        Router, Engine, bank, reg, tracer = BankRouter, FleetEngine, tbank, MetricsRegistry(), \
            Tracer()
    router = Router(bank, microbatch=8, ingest_chunk=4, metrics=reg, tracer=tracer)
    eng = Engine(router, auto_pump=False, metrics=reg, tracer=tracer)
    for i in range(16):
        eng.submit(i % 4, np.full(2, 0.05 * i, np.float32))
    eng.pump(max_blocks=1)
    out = eng.drain()
    for t in range(3):
        eng.observe(t, np.full(2, 0.1 * t, np.float32), 0.5)
    eng.ingest()
    eng.submit(0, np.zeros(2, np.float32))
    out.update(eng.drain())
    return out, {e["name"] for e in tracer.events()}, eng.metrics()["registry"]


def test_engine_spans_and_series_equal_the_jax_engines():
    """The same traffic through both packages' instrumented engines emits
    the same span names and the same metric series, with equal counters."""
    jout, jnames, jsnap = _instrumented_run("jax")
    tout, tnames, tsnap = _instrumented_run("torch")
    assert len(tout) == 17 and all(r.ok for r in tout.values())
    assert {"bucket_select", "coalesce", "dispatch", "device_wait", "harvest",
            "ingest"} <= tnames
    assert tnames == jnames
    for section in ("counters", "gauges", "histograms"):
        assert set(tsnap[section]) == set(jsnap[section]), section
    assert tsnap["counters"] == jsnap["counters"]
    assert tsnap["counters"]["serve_admitted_total"] == 17


def test_unwired_engine_reports_empty_registry():
    _, bank = _banks()
    eng = FleetEngine(BankRouter(bank, microbatch=8))
    eng.submit(0, np.zeros(2, np.float32))
    eng.drain()
    assert eng.metrics()["registry"] == {"counters": {}, "gauges": {}, "histograms": {}}


# --------------------------------------------------------------------------
# the checkpoint store's counter (process-default registry)
# --------------------------------------------------------------------------


def test_dead_writer_staging_dirs_reaped_and_counted(tmp_path):
    from repro_torch.checkpoint import store
    reg = MetricsRegistry()
    prev = set_default(reg)
    try:
        d = tmp_path / "ck"
        d.mkdir()
        child = subprocess.Popen([sys.executable, "-c", "pass"])
        child.wait()
        (d / f"tmp.3.{child.pid}").mkdir()     # verifiably dead writer
        (d / f"tmp.4.{os.getpid()}").mkdir()   # OUR pid: never touched
        assert store.latest_step(d) is None
        assert not (d / f"tmp.3.{child.pid}").exists()
        assert (d / f"tmp.4.{os.getpid()}").exists()
        assert reg.snapshot()["counters"]["checkpoint_stale_tmp_reaped_total"] == 1
    finally:
        set_default(prev)
