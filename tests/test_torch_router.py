"""Port parity for the fleet's serving path: ``repro_torch.bank.BankRouter``
and ``serve_fleet(engine="sync")`` against the JAX package's router and
loop on the same inputs (tolerances of ``tests/test_gp_bank.py``), the
router's contracts (ticket order, bucket padding, restore on failure), the
CLI, and the refusals of every fleet path not ported yet."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_common import gp_data, nn, specs, tt, uniform  # noqa: E402

from repro.bank import BankRouter as JRouter  # noqa: E402
from repro.bank import GPBank as JBank  # noqa: E402
from repro.launch.serve_gp import serve_fleet as j_serve_fleet  # noqa: E402
from repro_torch.bank import BankRouter, GPBank  # noqa: E402
from repro_torch.core import fagp as tfagp  # noqa: E402
from repro_torch.core.convert import bank_from_numpy  # noqa: E402
from repro_torch.launch import serve_gp as t_serve  # noqa: E402
from repro_torch.obs import MetricsRegistry, Tracer, serving_watchdog  # noqa: E402


def _banks(B, N=16, p=2, n=5, capacity=None):
    """The same fleet in both packages: (jax bank, port bank)."""
    Xb = np.zeros((B, N, p), np.float32)
    yb = np.zeros((B, N), np.float32)
    for s in range(B):
        Xb[s], yb[s] = gp_data(N, p, s)
    js, ts = specs("hermite", p, n=n)
    jb = JBank.fit(jnp.asarray(Xb), jnp.asarray(yb), js, capacity=capacity)
    st = jb.stack
    tb = bank_from_numpy(
        idx=np.asarray(st.idx), lam=np.asarray(st.lam), sqrtlam=np.asarray(st.sqrtlam),
        chol=np.asarray(st.chol), u=np.asarray(st.u), b=np.asarray(st.b),
        slots=dict(jb.slots), active=jb.active, spec=ts,
    )
    return jb, tb


def test_mixed_tenant_order_preservation():
    """Tickets map back to the right (tenant, query) however the batcher
    packs them (interleaved arrival, microbatch smaller than the backlog,
    padded tail), and answer as the JAX router does."""
    jb, tb = _banks(4)
    router, jrouter = BankRouter(tb, microbatch=5), JRouter(jb, microbatch=5)
    order = [0, 3, 1, 0, 2, 3, 3, 1, 0, 2, 1, 2, 0]  # 13 rows -> 3 blocks
    Xq = uniform(np.random.default_rng(7), (len(order), 2))
    tickets = [(router.submit(t, Xq[i]), jrouter.submit(t, Xq[i]), t, i)
               for i, t in enumerate(order)]
    assert router.pending == len(order)
    results, jresults = router.flush(), jrouter.flush()
    assert router.pending == 0
    assert set(results) == {tk for tk, _, _, _ in tickets}
    for tk, jtk, t, i in tickets:
        m1, v1 = tb.mean_var([t], tt(Xq[i:i + 1]))
        assert results[tk][0] == pytest.approx(float(m1[0]), abs=1e-6)
        assert results[tk][1] == pytest.approx(float(v1[0]), abs=1e-6)
        assert results[tk][0] == pytest.approx(jresults[jtk][0], abs=1e-5)
        assert results[tk][1] == pytest.approx(jresults[jtk][1], abs=1e-5)


def test_flush_empty_is_noop_and_take_requeue_keep_order():
    _, tb = _banks(2)
    router = BankRouter(tb, microbatch=4)
    assert router.flush() == {}
    x = np.zeros(2, np.float32)
    tickets = [router.submit(t, x) for t in (0, 1, 0)]
    taken = router.take(2)
    assert [e[0] for e in taken] == tickets[:2] and router.pending == 1
    router.requeue(taken)
    tenants, Xq = router._pack_block(router.take(3), 4)
    assert tenants == [0, 1, 0, 0] and Xq.shape == (4, 2)


def test_ingest_equals_direct_updates_and_jax():
    """Router ingest (grouped, padded, masked, multi-round) == direct
    single-session updates with the same rows (tests/test_gp_bank.py:358
    gate) and == the JAX router's ingest (1e-5)."""
    jb, tb = _banks(3)
    rng = np.random.default_rng(21)
    rows = {0: 5, 2: 2}  # tenant 0 spans 2 chunks of 4 -> 2 rounds
    router, jrouter = BankRouter(tb, ingest_chunk=4), JRouter(jb, ingest_chunk=4)
    direct = {t: tb.state(t) for t in rows}
    for t, cnt in rows.items():
        X = uniform(rng, (cnt, 2))
        y = rng.standard_normal(cnt).astype(np.float32)
        for i in range(cnt):
            router.observe(t, X[i], y[i])
            jrouter.observe(t, X[i], y[i])
        direct[t] = tfagp.fit_update(direct[t], tt(X), tt(y))
    assert router.ingest() == 7 == jrouter.ingest()
    assert router.ingest_rounds == 2 and router.ingest() == 0
    Xq = uniform(rng, (5, 2))
    for t in rows:
        m1, v1 = tfagp.predict_mean_var(direct[t], tt(Xq))
        m2, v2 = router.bank.mean_var([t] * 5, tt(Xq))
        mj, vj = jrouter.bank.mean_var([t] * 5, jnp.asarray(Xq))
        np.testing.assert_allclose(nn(m2), nn(m1), rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose(nn(v2), nn(v1), rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose(nn(m2), nn(mj), atol=1e-5)
        np.testing.assert_allclose(nn(v2), nn(vj), atol=1e-5)


def test_ingest_pads_the_group_axis_to_a_power_of_two(monkeypatch):
    """Each round's group axis is padded to a power-of-two bucket with
    fully-masked groups aimed at distinct unused slots, which stay
    bit-identical."""
    _, tb = _banks(6, capacity=8)
    rng = np.random.default_rng(33)
    router = BankRouter(tb, ingest_chunk=4)
    calls = []
    inner = GPBank._update_at_slots

    def spy(self, slots, Xk, yk, mask=None, donate=False):
        calls.append((slots.tolist(), mask.sum(dim=1).tolist()))
        return inner(self, slots, Xk, yk, mask, donate)

    monkeypatch.setattr(GPBank, "_update_at_slots", spy)

    def observe(tenants):
        for t in tenants:
            router.observe(t, uniform(rng, (2,)), float(rng.standard_normal()))

    spare = {f: getattr(tb.stack, f)[3].clone() for f in ("chol", "u", "b")}
    observe([0, 1, 2])      # G = 3 -> bucket 4 (one pad group on slot 3)
    router.ingest()
    observe([0, 2, 4, 5])   # G = 4 -> the same bucket, no pad
    router.ingest()
    observe([1])            # G = 1 -> bucket 1
    router.ingest()
    assert calls == [([0, 1, 2, 3], [1, 1, 1, 0]), ([0, 2, 4, 5], [1, 1, 1, 1]),
                     ([1], [1])]
    for f, v in spare.items():
        assert torch.equal(getattr(router.bank.stack, f)[3], v)


def test_failed_flush_restores_whole_backlog():
    """A mid-flush failure (a tenant evicted from a bank swapped in behind
    the router) keeps EVERY ticket redeemable, served blocks included."""
    _, tb = _banks(3)
    router = BankRouter(tb, microbatch=2)
    x = np.zeros(2, np.float32)
    tickets = [router.submit(t, x) for t in (0, 1, 2, 0)]
    router.bank = tb.evict(2)  # breaks the second block only
    with pytest.raises(KeyError, match="not in this bank"):
        router.flush()
    assert router.pending == 4
    router.bank = tb  # repair
    assert set(router.flush()) == set(tickets)


def test_failed_ingest_restores_observations():
    _, tb = _banks(3)
    router = BankRouter(tb, ingest_chunk=4)
    x = np.zeros(2, np.float32)
    for t in (0, 1):
        router.observe(t, x, 0.5)
    router.bank = tb.evict(1)
    with pytest.raises(KeyError, match="not in this bank"):
        router.ingest()
    router.bank = tb  # repair: both observations still queued
    assert router.ingest() == 2


def test_router_rejects_unknown_tenants_and_bad_rows():
    _, tb = _banks(2)
    router = BankRouter(tb)
    with pytest.raises(KeyError, match="not in this bank"):
        router.submit("ghost", np.zeros(2, np.float32))
    with pytest.raises(KeyError, match="not in this bank"):
        router.observe("ghost", np.zeros(2, np.float32), 0.0)
    with pytest.raises(ValueError, match="p=3"):
        router.submit(0, np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="must be >= 1"):
        BankRouter(tb, microbatch=0)


def test_unported_router_paths_raise():
    """No router path is refused any more: telemetry and donated updates
    (A4) construct routers (tests/test_torch_obs.py and
    tests/test_torch_engine.py hold them against the JAX package), and
    ``rebalance`` (A5) on a resident bank moves nothing, as in JAX
    (tests/test_torch_sharded.py holds the sharded one)."""
    _, tb = _banks(2)
    router = BankRouter(tb)
    for kw in ({"metrics": MetricsRegistry()}, {"tracer": Tracer()}, {"donate_updates": True}):
        assert BankRouter(tb, **kw).bank is tb
    assert router.rebalance() == 0 and router.rebalance(threshold=1) == 0
    assert router.bank is tb and router.shard_backlogs().shape == (0,)


# ---------------------------------------------------------------------------
# serve_fleet(engine="sync")
# ---------------------------------------------------------------------------

FLEET = dict(tenants=5, n_train=48, p=2, n=5, rounds=2, queries_per_round=70,
             observations_per_round=20, microbatch=16, ingest_chunk=4,
             noise=0.05, seed=0)


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_serve_fleet_matches_jax(backend):
    """The port's sync fleet loop == the JAX package's on the same seed:
    the same rows absorbed each round, and rmse equal to well within the
    1e-5 serving gate."""
    got = t_serve.serve_fleet(backend=backend, engine="sync", device="cpu", **FLEET)
    want = j_serve_fleet(backend=backend, engine="sync", **FLEET)
    assert got["M"] == want["M"] == 25 and got["device"] == "cpu"
    assert got["tenants"] == 5 and got["engine"] == "sync"
    assert len(got["rounds"]) == FLEET["rounds"]
    for g, w in zip(got["rounds"], want["rounds"]):
        for key in ("round", "rows_absorbed"):
            assert g[key] == w[key]
        assert abs(g["rmse"] - w["rmse"]) < 1e-5
        assert g["rmse"] < 0.1 and g["var_finite"] and g["ingest_rounds"] >= 1
    bank = got["bank"]
    assert isinstance(bank, GPBank) and len(bank) == 5


def test_fleet_dataset_is_the_jax_loops_data():
    """``fleet_dataset`` draws what the JAX ``serve_fleet`` draws: the same
    per-tenant pools and offsets from the same rng."""
    from repro.data import make_gp_dataset

    rng = np.random.default_rng(4)
    offsets, Xb, yb, pools = t_serve.fleet_dataset(
        rng, tenants=3, n_train=10, p=2, rounds=2, observations_per_round=6,
        noise=0.05, seed=4)
    want_off = np.random.default_rng(4).uniform(-1.0, 1.0, size=3).astype(np.float32)
    np.testing.assert_array_equal(offsets, want_off)
    for t in range(3):
        X, y, _, _ = make_gp_dataset(10 + 2 * 2 + 6, 2, noise=0.05, seed=4 + t)
        np.testing.assert_array_equal(pools[t][0], np.asarray(X))
        np.testing.assert_array_equal(pools[t][1], np.asarray(y) + want_off[t])
        np.testing.assert_array_equal(Xb[t], np.asarray(X)[:10])
        np.testing.assert_array_equal(yb[t], (np.asarray(y) + want_off[t])[:10])


# every fleet option is ported (ROADMAP A2-A5): on the sync loop the cold
# tier raises the JAX package's ValueError (it pages only through the
# pipelined engine), the rest run (shards on the CPU share it)
@pytest.mark.parametrize("option", [
    {"engine": "pipelined"}, {"cold_dir": "unused"}, {"cold_dir": "unused", "window": 4},
    {"shards": 2}, {"cold_dir": "unused", "capacity": 8}, {"metrics": object()},
    {"tracer": object()}, {"watchdog": object()},
])
def test_serve_fleet_refuses_what_is_not_ported(option):
    kw = {"engine": "sync", "device": "cpu", **FLEET, **option}
    if "shards" in option:
        out = t_serve.serve_fleet(**kw)
        assert out["shards"] == 2 and sum(out["shard_occupancy"]) == FLEET["tenants"]
        assert all(h["rmse"] < 0.1 for h in out["rounds"])
        return
    if "cold_dir" in option:
        with pytest.raises(ValueError, match="needs the pipelined engine"):
            t_serve.serve_fleet(**kw)
        with pytest.raises(ValueError, match="needs the pipelined engine"):
            j_serve_fleet(**{k: v for k, v in kw.items() if k != "device"})
        return
    # the obs objects themselves, not placeholders
    real = {"metrics": MetricsRegistry(), "tracer": Tracer(),
            "watchdog": serving_watchdog(mode="count")}
    kw.update({k: real[k] for k in option if k in real})
    out = t_serve.serve_fleet(**kw)
    assert out["engine"] == kw["engine"] and all(h["rmse"] < 0.1 for h in out["rounds"])


def test_serve_fleet_refuses_bad_settings():
    with pytest.raises(ValueError, match="engine must be"):
        t_serve.serve_fleet(engine="async", device="cpu")
    with pytest.raises(ValueError, match="cold tier"):
        t_serve.serve_fleet(engine="sync", device="cpu", capacity=8)
    with pytest.raises(ValueError, match="capacity/window need a cold tier; pass cold_dir"):
        t_serve.serve_fleet(engine="sync", device="cpu", window=4)


def test_fleet_cli_runs_on_cpu(capsys):
    t_serve.main(["--fleet", "3", "--engine", "sync", "--backend", "pallas",
                  "--device", "cpu", "--n-train", "32", "--n", "4", "--rounds", "1",
                  "--update-size", "6", "--queries", "20", "--microbatch", "8"])
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["M"] == 16 and out["tenants"] == 3 and out["engine"] == "sync"
    assert out["device"] == "cpu" and len(out["rounds"]) == 1
    assert lines[0].startswith("fleet of 3 fitted")
