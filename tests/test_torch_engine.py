"""The port's pipelined engine (``repro_torch.bank.FleetEngine``) against the
JAX package's, on the same numpy fleets: the cases of
tests/test_serve_engine.py on the port (any interleaving equals direct
calls; a failed dispatch restores the backlog; the expired ticket, the queue
budget, the bucket ladder, coalescing and churn; donation; the
percentiles), the port's results held against the JAX engine's ticket by
ticket (1e-5), and ``serve_fleet(engine="pipelined")`` against the JAX run
of the same seed.

On the CPU the bank's plain versions compute each block when it is
dispatched; the dispatch path's pinned staging and CUDA events run on the
card (``chip_smoke.py`` phase 9, and the ``cuda`` test below)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hypcompat import given, settings, st  # noqa: E402
from test_torch_common import gp_data, specs, tt  # noqa: E402

from repro.bank import BankRouter as JRouter  # noqa: E402
from repro.bank import FleetEngine as JEngine  # noqa: E402
from repro.bank import GPBank as JBank  # noqa: E402
from repro.launch import serve_gp as j_serve  # noqa: E402
from repro_torch.bank import (  # noqa: E402
    TIMEOUT_MU,
    TIMEOUT_VAR,
    BankRouter,
    FleetEngine,
    GPBank,
    LatencyStats,
    QueueFull,
)
from repro_torch.bank.engine import _pow2_buckets  # noqa: E402
from repro_torch.core import fagp as tfagp  # noqa: E402
from repro_torch.core.convert import bank_from_numpy  # noqa: E402
from repro_torch.launch import serve_gp as t_serve  # noqa: E402

# the serving gates of tests/test_serve_engine.py: results against direct
# calls and across packages 1e-5 abs; donated against plain ingest 1e-6
TOL = 1e-5
TOL_DONATE = 1e-6


def _data(B, N, p, seed=0):
    Xb = np.zeros((B, N, p), np.float32)
    yb = np.zeros((B, N), np.float32)
    for s in range(B):
        Xb[s], yb[s] = gp_data(N, p, seed + s)
    return Xb, yb


def _fleet(B=4, N=8, p=2, n=4, *, backend="jnp"):
    Xb, yb = _data(B, N, p)
    _, ts = specs("hermite", p, n=n, backend=backend)
    return GPBank.fit(tt(Xb), tt(yb), ts)


def _banks(B=4, N=16, p=2, n=5, *, backend="jnp"):
    """The same fleet in both packages, the port's bank holding the JAX
    bank's own factors (tests/test_torch_router.py's construction), so
    only serving and ingest arithmetic can differ: (jax bank, port bank)."""
    Xb, yb = _data(B, N, p)
    js, ts = specs("hermite", p, n=n, backend=backend)
    jb = JBank.fit(jnp.asarray(Xb), jnp.asarray(yb), js)
    st = jb.stack
    tb = bank_from_numpy(
        idx=np.asarray(st.idx), lam=np.asarray(st.lam), sqrtlam=np.asarray(st.sqrtlam),
        chol=np.asarray(st.chol), u=np.asarray(st.u), b=np.asarray(st.b),
        slots=dict(jb.slots), active=jb.active, spec=ts)
    return jb, tb


def _engine(bank, *, microbatch=8, ingest_chunk=4, **kw):
    router = BankRouter(bank, microbatch=microbatch, ingest_chunk=ingest_chunk)
    return FleetEngine(router, **kw), router


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _shadow_ingest(bank, queues, chunk):
    """BankRouter.ingest's decomposition with DIRECT ``GPBank.update`` calls:
    per-tenant chunks of ``chunk`` rows, padded and masked, distinct tenants
    per round."""
    p = bank.spec.p
    queues = {t: list(rows) for t, rows in queues.items() if rows}
    while queues:
        ids, Xg, yg, mg = [], [], [], []
        for t in list(queues):
            rows, rest = queues[t][:chunk], queues[t][chunk:]
            if rest:
                queues[t] = rest
            else:
                del queues[t]
            X = np.zeros((chunk, p), np.float32)
            y = np.zeros((chunk,), np.float32)
            m = np.zeros((chunk,), np.float32)
            for i, (x, yv) in enumerate(rows):
                X[i], y[i], m[i] = x, yv, 1.0
            ids.append(t)
            Xg.append(X)
            yg.append(y)
            mg.append(m)
        bank = bank.update(ids, tt(np.stack(Xg)), tt(np.stack(yg)), mask=tt(np.stack(mg)))
    return bank


def _interleave(make_engine, seed, B, p):
    """Drive one random op sequence (submit / observe / drain / ingest)
    through an engine; returns (sent, got, shadow log)."""
    eng = make_engine()
    rng = np.random.default_rng(seed)
    sent, got, log = {}, {}, []
    ops = rng.choice(["submit", "observe", "drain", "ingest"], size=28,
                     p=[0.55, 0.2, 0.15, 0.1])
    for op in ops:
        tenant = int(rng.integers(0, B))
        if op == "submit":
            x = rng.uniform(-1, 1, p).astype(np.float32)
            sent[eng.submit(tenant, x)] = (tenant, x)
        elif op == "observe":
            x = rng.uniform(-1, 1, p).astype(np.float32)
            y = float(rng.normal())
            eng.observe(tenant, x, y)
            log.append(("observe", tenant, x, y))
        elif op == "drain":
            fresh = eng.drain()
            got.update(fresh)
            log.append(("drain", list(fresh)))
        else:
            fresh = eng.drain()
            got.update(fresh)
            log.append(("drain", list(fresh)))
            eng.ingest()
            log.append(("ingest",))
    fresh = eng.drain()
    got.update(fresh)
    log.append(("drain", list(fresh)))
    eng.ingest()
    return sent, got, log


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 63), microbatch=st.sampled_from([3, 4, 8]),
       ingest_chunk=st.sampled_from([2, 5]))
def test_any_interleaving_matches_direct_calls(backend, seed, microbatch, ingest_chunk):
    """Every ticket answered exactly once, against its own submission, as
    direct ``GPBank.mean_var`` / ``GPBank.update`` calls answer it (1e-5)."""
    B, p = 4, 2
    bank = _fleet(backend=backend)
    sent, got, log = _interleave(
        lambda: _engine(bank, microbatch=microbatch, ingest_chunk=ingest_chunk)[0], seed, B, p)
    shadow, queued, expected = bank, {}, {}
    for entry in log:
        if entry[0] == "observe":
            queued.setdefault(entry[1], []).append((entry[2], entry[3]))
        elif entry[0] == "ingest":
            shadow = _shadow_ingest(shadow, queued, ingest_chunk)
            queued = {}
        elif entry[1]:
            ids = [sent[t][0] for t in entry[1]]
            mu, var = shadow.mean_var(ids, tt(np.stack([sent[t][1] for t in entry[1]])))
            for i, t in enumerate(entry[1]):
                expected[t] = (float(mu[i]), float(var[i]))
    assert set(got) == set(sent)
    for t, r in got.items():
        assert r.ok
        assert abs(r.mu - expected[t][0]) <= TOL, (t, r.mu, expected[t])
        assert abs(r.var - expected[t][1]) <= TOL, (t, r.var, expected[t])


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("seed", [3, 17])
def test_results_equal_the_jax_engines(backend, seed):
    """The same op sequence through the port's engine and the JAX package's:
    the same tickets, each result within 1e-5."""
    B, p = 4, 2
    jbank, tbank = _banks(backend=backend)
    tsent, tgot, _ = _interleave(lambda: _engine(tbank, microbatch=4)[0], seed, B, p)
    jsent, jgot, _ = _interleave(
        lambda: JEngine(JRouter(jbank, microbatch=4, ingest_chunk=4)), seed, B, p)
    assert set(tgot) == set(jgot) == set(tsent)
    for t in tgot:
        assert abs(tgot[t].mu - jgot[t].mu) <= TOL
        assert abs(tgot[t].var - jgot[t].var) <= TOL


# --------------------------------------------------------------------------
# fault injection
# --------------------------------------------------------------------------


def test_dispatch_failure_restores_backlog_and_bank():
    eng, router = _engine(_fleet(), auto_pump=False)
    tks = [eng.submit(i % 4, np.full(2, 0.1 * i, np.float32)) for i in range(6)]
    before = [(t, x.copy()) for _, t, x in router._pending]
    stack0 = {f: getattr(router.bank.stack, f).clone()
              for f in ("chol", "u", "b", "lam", "sqrtlam")}
    real = eng._dispatch

    def boom(entries, bucket):
        raise RuntimeError("injected mid-flight fault")

    eng._dispatch = boom
    with pytest.raises(RuntimeError, match="injected"):
        eng.pump()
    assert [(t, tuple(x)) for _, t, x in router._pending] == [(t, tuple(x)) for t, x in before]
    for f, v in stack0.items():
        assert torch.equal(getattr(router.bank.stack, f), v), f
    assert eng.in_flight_blocks == 0 and eng.in_flight_rows == 0
    eng._dispatch = real
    out = eng.drain()
    assert set(out) == set(tks) and all(out[t].ok for t in tks)


def test_failed_serving_call_requeues_at_the_front():
    """A failure inside the bank's serving call (not only in packing)
    requeues the block at the front of the backlog and raises."""
    eng, router = _engine(_fleet(), auto_pump=False)
    tks = [eng.submit(i % 4, np.full(2, 0.1 * i, np.float32)) for i in range(5)]
    later = eng.submit(1, np.zeros(2, np.float32))
    sm, call = eng._dispatcher()

    def failing(slots, Xq):
        raise RuntimeError("serving failed")

    eng._dcache = (router.bank, sm, failing)
    with pytest.raises(RuntimeError, match="serving failed"):
        eng.pump(max_blocks=1)
    assert [e[0] for e in router._pending] == tks + [later]
    eng._dcache = None
    out = eng.drain()
    assert set(out) == set(tks + [later])


def test_failed_ingest_restores_queue_and_serving_continues():
    bank = _fleet()
    eng, router = _engine(bank)
    eng.observe(1, np.zeros(2, np.float32), 0.5)
    router.bank = GPBank.create(bank.spec, capacity=bank.capacity)
    with pytest.raises(KeyError):
        eng.ingest()
    assert router._observations[1], "queued observation was dropped"
    router.bank = bank
    assert eng.ingest() == 1
    t = eng.submit(1, np.zeros(2, np.float32))
    assert eng.drain()[t].ok


def test_expired_ticket_never_blocks_later_tickets():
    clock = _FakeClock()
    eng, _ = _engine(_fleet(), auto_pump=False, clock=clock)
    doomed = eng.submit(0, np.zeros(2, np.float32), deadline_s=1.0)
    clock.t = 0.5
    live1 = eng.submit(1, np.ones(2, np.float32))
    clock.t = 2.0
    live2 = eng.submit(2, np.full(2, -0.5, np.float32), deadline_s=10.0)
    out = eng.drain()
    assert out[doomed].timed_out
    assert math.isnan(out[doomed].mu) and out[doomed].var == TIMEOUT_VAR
    assert math.isnan(TIMEOUT_MU) and TIMEOUT_VAR == float("inf")
    assert out[live1].ok and out[live2].ok
    assert np.isfinite(out[live1].mu) and np.isfinite(out[live2].mu)
    m = eng.metrics()
    assert m["overall"]["expired"] == 1 and m["overall"]["completed"] == 2
    assert m["tenants"][0]["timeouts"] == 1


def test_queue_budget_backpressure():
    eng, _ = _engine(_fleet(), queue_budget=3, auto_pump=False)
    for _ in range(3):
        eng.submit(0, np.zeros(2, np.float32))
    with pytest.raises(QueueFull):
        eng.submit(0, np.zeros(2, np.float32))
    eng.drain()
    assert eng.depth == 0
    eng.submit(0, np.zeros(2, np.float32))


# --------------------------------------------------------------------------
# bucket autotuning: shapes are pinned, churn adds no serving shape
# --------------------------------------------------------------------------


def test_ladder_is_fixed_powers_of_two():
    from repro.bank.engine import _pow2_buckets as jbuckets
    for args in ((8,), (8, 4), (1, 1), (64, 4), (256, 4), (3, 2)):
        assert _pow2_buckets(*args) == jbuckets(*args)
    assert _pow2_buckets(8, 4) == (1, 2, 4, 8, 16, 32)
    assert _pow2_buckets(64, 4) == (1, 2, 4, 8, 16, 32, 64, 128, 256)


def test_backlog_coalesces_up_the_ladder():
    eng, _ = _engine(_fleet(), microbatch=4, auto_pump=False, max_coalesce=4)
    for i in range(11):
        eng.submit(i % 4, np.full(2, 0.05 * i, np.float32))
    eng.pump(max_blocks=1)
    assert eng.bucket_uses == {16: 1}
    assert len(eng.drain()) == 11


def test_traffic_churn_adds_no_serving_shape():
    eng, _ = _engine(_fleet(), microbatch=8, auto_pump=False, max_coalesce=2)
    rng = np.random.default_rng(0)
    for rung in eng.buckets:
        for _ in range(rung):
            eng.submit(int(rng.integers(0, 4)), rng.uniform(-1, 1, 2).astype(np.float32))
        eng.pump(max_blocks=1)
        eng.drain()
    serve0 = tfagp._bank_gathered_posterior._cache_size()
    for _ in range(12):
        for _ in range(int(rng.integers(1, 17))):
            eng.submit(int(rng.integers(0, 4)), rng.uniform(-1, 1, 2).astype(np.float32))
        eng.drain()
    assert tfagp._bank_gathered_posterior._cache_size() == serve0


# --------------------------------------------------------------------------
# donated ingest
# --------------------------------------------------------------------------


def _observe_all(router, rows):
    for t, x, y in rows:
        router.observe(t, x, y)
    return router.ingest()


def test_ingest_donation_matches_non_donated_and_kills_the_donor():
    """``donate_updates=True`` writes each round into the stack in place:
    its bank serves as the non-donated one (1e-6, the JAX gate), and the
    donor bank raises on any use, as a donated JAX buffer does."""
    rng = np.random.default_rng(3)
    rows = [(int(rng.integers(0, 4)), rng.uniform(-1, 1, 2).astype(np.float32),
             float(rng.normal())) for _ in range(6)]
    plain_bank, donor = _fleet(), _fleet()
    plain = BankRouter(plain_bank, microbatch=8, ingest_chunk=4)
    donated = BankRouter(donor, microbatch=8, ingest_chunk=4, donate_updates=True)
    donor._binv                              # the cache is donated too
    chol0 = donor.stack.chol
    assert _observe_all(plain, rows) == 6 and _observe_all(donated, rows) == 6
    assert donated.bank.stack.chol.data_ptr() == chol0.data_ptr()   # written in place
    xq = tt(np.full((1, 2), 0.2, np.float32))
    for t in range(4):
        mu_a, var_a = plain.bank.mean_var([t], xq)
        mu_b, var_b = donated.bank.mean_var([t], xq)
        assert abs(float(mu_a[0]) - float(mu_b[0])) <= TOL_DONATE
        assert abs(float(var_a[0]) - float(var_b[0])) <= TOL_DONATE
    for use in (lambda: donor.mean_var([0], xq), lambda: donor.state(0),
                lambda: donor.update([0], tt(np.zeros((1, 2, 2), np.float32)),
                                     tt(np.zeros((1, 2), np.float32))),
                lambda: donor.evict(0)):
        with pytest.raises(RuntimeError, match="donated"):
            use()


def test_donated_ingest_matches_the_jax_donated_ingest():
    rng = np.random.default_rng(4)
    rows = [(int(rng.integers(0, 4)), rng.uniform(-1, 1, 2).astype(np.float32),
             float(rng.normal())) for _ in range(9)]
    jbank, tbank = _banks()
    mine = BankRouter(tbank, microbatch=8, ingest_chunk=4, donate_updates=True)
    ref = JRouter(jbank, microbatch=8, ingest_chunk=4, donate_updates=True)
    assert _observe_all(mine, rows) == _observe_all(ref, rows) == 9
    Xq = np.random.default_rng(5).uniform(-1, 1, (8, 2)).astype(np.float32)
    ids = [0, 1, 2, 3, 3, 2, 1, 0]
    mu, var = mine.bank.mean_var(ids, tt(Xq))
    jmu, jvar = ref.bank.mean_var(ids, jnp.asarray(Xq))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=TOL, rtol=0)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=TOL, rtol=0)


# --------------------------------------------------------------------------
# latency metrics: numpy.percentile reference semantics
# --------------------------------------------------------------------------


def test_percentiles_match_numpy_reference():
    rng = np.random.default_rng(11)
    stats = LatencyStats()
    ref = {}
    for tenant in range(3):
        samples = rng.exponential(0.01, size=rng.integers(5, 40))
        for s in samples:
            stats.record(tenant, float(s))
        ref[tenant] = samples
    for tenant, samples in ref.items():
        p50, p99 = stats.percentiles(tenant)
        assert p50 == float(np.percentile(samples, 50))
        assert p99 == float(np.percentile(samples, 99))
    pooled = np.concatenate(list(ref.values()))
    assert stats.percentiles(None) == (float(np.percentile(pooled, 50)),
                                       float(np.percentile(pooled, 99)))
    assert all(math.isnan(v) for v in stats.percentiles("nobody"))


def test_engine_metrics_are_percentiles_of_recorded_samples():
    eng, _ = _engine(_fleet())
    rng = np.random.default_rng(5)
    tks = [eng.submit(int(rng.integers(0, 4)), rng.uniform(-1, 1, 2).astype(np.float32))
           for _ in range(40)]
    out = eng.drain()
    assert all(out[t].ok for t in tks)
    m = eng.metrics()
    pooled = [s for lst in eng.stats.samples.values() for s in lst]
    assert m["overall"]["p50_s"] == float(np.percentile(pooled, 50))
    assert m["overall"]["p99_s"] == float(np.percentile(pooled, 99))
    assert m["overall"]["completed"] == 40
    assert sum(v["count"] for v in m["tenants"].values()) == 40
    assert all(out[t].latency_s >= 0.0 for t in tks)
    assert m["overall"]["sustained_qps"] > 0


# --------------------------------------------------------------------------
# serve_fleet(engine="pipelined") against the JAX run
# --------------------------------------------------------------------------

FLEET = dict(tenants=6, n_train=24, p=2, n=4, rounds=2, queries_per_round=96,
             observations_per_round=40, microbatch=8, seed=5)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_serve_fleet_pipelined_matches_jax(backend):
    """The JAX default engine on the same seed: the same rows absorbed and
    timeouts per round, rmse within 1e-5, the same ticket count."""
    mine = t_serve.serve_fleet(backend=backend, device="cpu", **FLEET)
    ref = j_serve.serve_fleet(backend=backend, **FLEET)
    assert mine["engine"] == ref["engine"] == "pipelined"
    for a, b in zip(mine["rounds"], ref["rounds"]):
        for k in ("rows_absorbed", "timeouts", "aged_rows", "reopt_tenants"):
            assert a[k] == b[k], k
        assert abs(a["rmse"] - b["rmse"]) <= TOL
    assert mine["latency"]["overall"]["completed"] == ref["latency"]["overall"]["completed"]
    assert mine["latency"]["overall"]["expired"] == 0


def test_serve_fleet_defaults_to_the_pipelined_engine():
    out = t_serve.serve_fleet(device="cpu", tenants=2, n_train=8, rounds=1,
                              queries_per_round=8, observations_per_round=4)
    assert out["engine"] == "pipelined" and "latency" in out
    assert out["rounds"][0]["timeouts"] == 0


def test_serve_fleet_expired_tickets_are_counted():
    """An SLO no block can meet: every ticket not dispatched at once gets
    the sentinel and counts as a timeout, never as a served query."""
    out = t_serve.serve_fleet(device="cpu", tenants=3, n_train=8, rounds=1,
                              queries_per_round=64, observations_per_round=4,
                              microbatch=8, slo_s=1e-9)
    h = out["rounds"][0]
    assert h["timeouts"] > 0
    assert h["timeouts"] + out["latency"]["overall"]["completed"] == 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (repro_torch's CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pipelined_dispatch_has_no_host_device_barrier(cuda_device):
    """On the card a stream of 4 blocks through submit / pump raises
    nothing under ``torch.cuda.set_sync_debug_mode("error")`` and leaves
    all 4 in flight; the harvested results equal direct ``GPBank.mean_var``
    (1e-5)."""
    Xb, yb = _data(16, 256, 2)
    spec = tfagp.GPSpec.create(6, eps=np.full(2, 0.8, np.float32), rho=2.0, noise=0.05,
                               backend="pallas", device="cuda")
    bank = GPBank.fit(tt(Xb), tt(yb), spec)
    mb = 64
    eng, _ = _engine(bank, microbatch=mb, auto_pump=False, max_in_flight=4, max_coalesce=1)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 16, 4 * mb)
    Xq = rng.uniform(-1, 1, (4 * mb, 2)).astype(np.float32)

    def stream():
        tks = []
        for blk in range(4):
            tks += [eng.submit(int(ids[i]), Xq[i]) for i in range(blk * mb, (blk + 1) * mb)]
            eng.pump(max_blocks=1)
        return tks

    stream()
    eng.drain()                  # warm: B^-1 and four staging sets
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tks = stream()
        in_flight = eng.in_flight_blocks
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert in_flight == 4
    out = eng.drain()
    mu, var = bank.mean_var([int(t) for t in ids], tt(Xq))
    got = np.array([[out[t].mu, out[t].var] for t in tks])
    np.testing.assert_allclose(got[:, 0], mu.cpu().numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(got[:, 1], var.cpu().numpy(), atol=TOL, rtol=0)
