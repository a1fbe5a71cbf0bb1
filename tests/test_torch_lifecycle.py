"""The port's tiered bank (``repro_torch.bank.TieredBank``) against the JAX
package's, on the same numpy fleets: the cases of tests/test_lifecycle.py
on the port (checkpoints with their window, hot/cold paging and its parity,
LRU and pinning, a durable tier, sliding-window forgetting with the refit
fallback, the engine paging cold tenants in), and against the JAX package:
the same paging sequence and ``stats``, the same rows aged out and the same
served values after ``age`` (1e-5), cold checkpoints with ``extra`` that
cross-load both ways bitwise, and ``serve_fleet(engine="pipelined",
cold_dir=..., window=...)`` against the JAX run of the same seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_common import gp_data, specs, tt  # noqa: E402

from repro.bank import TieredBank as JTiered  # noqa: E402
from repro.checkpoint import gpstate as jgpstate  # noqa: E402
from repro.core.gp import GP as JGP  # noqa: E402
from repro.launch import serve_gp as j_serve  # noqa: E402
from repro_torch.bank import BankRouter, FleetEngine, GPBank, TieredBank  # noqa: E402
from repro_torch.bank import bank as bank_mod  # noqa: E402
from repro_torch.checkpoint import gpstate  # noqa: E402
from repro_torch.core import fagp as tfagp  # noqa: E402
from repro_torch.core.convert import bank_from_numpy  # noqa: E402
from repro_torch.core.gp import GP  # noqa: E402
from repro_torch.launch import serve_gp as t_serve  # noqa: E402

# tests/test_lifecycle.py's gate: paged, aged and refit serving 1e-5 abs
TOL = 1e-5
LEAVES = ("lam", "sqrtlam", "chol", "u", "b")


def _data(B, N, p, seed=0, noise=0.1):
    Xb = np.zeros((B, N, p), np.float32)
    yb = np.zeros((B, N), np.float32)
    for s in range(B):
        Xb[s], yb[s] = gp_data(N, p, seed + s, noise=noise)
    return Xb, yb


def _fleet(B, N, p=2, n=5, *, backend="jnp"):
    """(Xb, yb, port spec, jax spec) of tests/test_lifecycle.py's fleets
    (noise 0.1)."""
    Xb, yb = _data(B, N, p)
    js, ts = specs("hermite", p, n=n, backend=backend, noise=0.1)
    return Xb, yb, ts, js


def _from_jax(jbank, ts):
    """The port bank holding the JAX bank's own factors."""
    st = jbank.stack
    return bank_from_numpy(
        idx=np.asarray(st.idx), lam=np.asarray(st.lam), sqrtlam=np.asarray(st.sqrtlam),
        chol=np.asarray(st.chol), u=np.asarray(st.u), b=np.asarray(st.b),
        slots=dict(jbank.slots), active=jbank.active, spec=ts)


def _q(seed, n, p=2):
    return np.random.default_rng(seed).uniform(-1, 1, (n, p)).astype(np.float32)


# ---------------------------------------------------------------------------
# checkpoints with their window: round trips and cross-loading
# ---------------------------------------------------------------------------


def test_extra_arrays_round_trip_and_cross_load_bitwise(tmp_path):
    """A cold checkpoint with ``extra`` (the window) written by either
    package loads in the other with bitwise-equal leaves and extras."""
    X, y = gp_data(40, 2, 0, noise=0.1)
    js, ts = specs("hermite", 2, n=5, noise=0.1)
    extra = {"win_x": X[:7], "win_y": y[:7]}
    gp = GP.fit(tt(X), tt(y), ts)
    gpstate.save_state(tmp_path / "port", gp.state, extra=extra)
    jgpstate.save_state(tmp_path / "jax", JGP.fit(jnp.asarray(X), jnp.asarray(y), js).state,
                        extra=extra)
    for src in ("port", "jax"):
        _, st, ex = gpstate.load_state(tmp_path / src, device="cpu")
        _, jst, jex = jgpstate.load_state(tmp_path / src)
        assert set(ex) == set(jex) == {"win_x", "win_y"}
        for k in ex:
            assert ex[k].dtype == jex[k].dtype and np.array_equal(ex[k], jex[k]) \
                and np.array_equal(ex[k], extra[k]), (src, k)
        for f in LEAVES:
            assert np.array_equal(getattr(st, f).numpy(), np.asarray(getattr(jst, f))), (src, f)
    _, _, none = gpstate.load_state(tmp_path / "port", step=0, device="cpu")
    assert set(none) == {"win_x", "win_y"}
    gp.save(tmp_path / "bare")
    assert gpstate.load_state(tmp_path / "bare", device="cpu")[2] == {}


def test_load_state_checks_hypers_only_when_asked(tmp_path):
    """``require_hypers_match`` (GP.load sets it) refuses other
    hyperparameters; a tier's page-in leaves it off and admits them."""
    X, y = gp_data(40, 2, 0, noise=0.1)
    _, ts = specs("hermite", 2, n=5, noise=0.1)
    GP.fit(tt(X), tt(y), ts).save(tmp_path)
    other = ts.replace(eps=torch.full((2,), 0.5))
    gpstate.load_state(tmp_path, like_spec=other, device="cpu")
    with pytest.raises(ValueError, match="hyperparameter"):
        gpstate.load_state(tmp_path, like_spec=other, require_hypers_match=True, device="cpu")
    with pytest.raises(ValueError, match="hyperparameter"):
        GP.load(tmp_path, spec=other)


def test_hetero_bank_slots_round_trip_through_the_tier(tmp_path):
    """A heterogeneous bank's slot pages out and back bit-exactly: its
    factors and its own (eps, rho, noise)."""
    Xb, yb, ts, _ = _fleet(3, 32, n=4)
    bank = GPBank.fit(tt(Xb), tt(yb), ts).optimize(tt(Xb), tt(yb), steps=6, restarts=1)
    tb = TieredBank(bank, tmp_path / "cold")
    before = bank.state(1)
    tb.evict_to_cold(1)
    tb.page_in(1)
    after = tb.bank.state(1)
    for f in LEAVES:
        assert torch.equal(getattr(before, f), getattr(after, f)), f
    for f in ("eps", "rho", "noise"):
        assert torch.equal(getattr(before.spec, f), getattr(after.spec, f)), f


def test_cold_checkpoint_from_other_structure_raises(tmp_path):
    X, y = gp_data(32, 2, 0, noise=0.1)
    cold = tmp_path / "cold"
    rff = tfagp.GPSpec.create_rff(np.full(2, 0.8, np.float32), kernel="se", num_features=32,
                                  noise=0.1, seed=3, device="cpu")
    gpstate.save_state(cold / "i0", GP.fit(tt(X), tt(y), rff).state)
    Xb, yb, ts, _ = _fleet(2, 32, n=4)
    tb = TieredBank(GPBank.fit(tt(Xb), tt(yb), ts, tenant_ids=[1, 2], capacity=3), cold)
    assert 0 in tb.cold_tenants
    with pytest.raises(ValueError, match="structural"):
        tb.page_in(0)


# ---------------------------------------------------------------------------
# hot/cold paging
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_evict_cold_restore_parity(tmp_path, backend):
    """evict -> cold -> warm restore serves as the never-evicted bank
    (1e-5), and as the JAX tier does on the same calls."""
    B, N, p = 6, 32, 2
    Xb, yb, ts, js = _fleet(B, N, backend=backend)
    ref = GPBank.fit(tt(Xb), tt(yb), ts)
    tb = TieredBank.fit(tt(Xb), tt(yb), ts, cold_dir=tmp_path / "cold", capacity=3)
    jtb = JTiered.fit(jnp.asarray(Xb), jnp.asarray(yb), js, cold_dir=tmp_path / "jcold",
                      capacity=3)
    assert tb.cold_tenants == jtb.cold_tenants == [3, 4, 5]
    Xq = _q(7, 9)
    ids = [4, 0, 4, 3, 3, 0, 4, 3, 0]
    mu, var = tb.mean_var(ids, tt(Xq))
    mur, varr = ref.mean_var(ids, tt(Xq))
    jmu, jvar = jtb.mean_var(ids, jnp.asarray(Xq))
    np.testing.assert_allclose(mu.numpy(), mur.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(var.numpy(), varr.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=TOL, rtol=0)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=TOL, rtol=0)
    assert tb.stats == jtb.stats
    assert tb.hot_tenants == jtb.hot_tenants


def test_hetero_evict_restore_parity(tmp_path):
    Xb, yb, ts, _ = _fleet(3, 32, n=4)
    bank = GPBank.fit(tt(Xb), tt(yb), ts).optimize(tt(Xb), tt(yb), steps=6, restarts=1)
    tb = TieredBank(bank, tmp_path / "cold")
    Xq = tt(_q(8, 6))
    mu0, var0 = bank.mean_var([2] * 6, Xq)
    tb.evict_to_cold(2)
    mu1, var1 = tb.mean_var([2] * 6, Xq)
    np.testing.assert_allclose(mu1.numpy(), mu0.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(var1.numpy(), var0.numpy(), atol=TOL, rtol=0)


def test_optimized_tenant_promotes_a_homogeneous_bank(tmp_path):
    """A cold tenant with learned hyperparameters paged into a homogeneous
    bank turns it heterogeneous, and serves as its own session."""
    Xb, yb, ts, _ = _fleet(3, 32, n=4)
    learned = GPBank.fit(tt(Xb), tt(yb), ts).optimize(tt(Xb), tt(yb), steps=6, restarts=1)
    cold = tmp_path / "cold"
    gpstate.save_state(cold / "i7", learned.state(0))
    tb = TieredBank(GPBank.fit(tt(Xb[1:]), tt(yb[1:]), ts, tenant_ids=[1, 2], capacity=3),
                    cold)
    assert tb.bank.hypers is None
    Xq = tt(_q(2, 5))
    mu, var = tb.mean_var([7] * 5, Xq)
    assert tb.bank.hypers is not None
    m1, v1 = GP.from_state(learned.state(0)).mean_var(Xq)
    np.testing.assert_allclose(mu.numpy(), m1.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(var.numpy(), v1.numpy(), atol=TOL, rtol=0)


def test_paging_churn_adds_no_shapes(tmp_path):
    """Arbitrary evict/restore churn calls the same slot write and serving
    shapes: the shape registries do not grow across 30 paging cycles."""
    B, N = 8, 32
    Xb, yb, ts, _ = _fleet(B, N)
    tb = TieredBank.fit(tt(Xb), tt(yb), ts, cold_dir=tmp_path / "cold", capacity=4)
    Xq = tt(_q(9, 4))
    for t in range(B):
        tb.mean_var([t] * 4, Xq)
    writes0 = bank_mod._write_slot._cache_size()
    serve0 = tfagp._bank_gathered_posterior._cache_size()
    for r in range(30):
        tb.mean_var([(3 * r + 1) % B] * 4, Xq)
    assert bank_mod._write_slot._cache_size() == writes0
    assert tfagp._bank_gathered_posterior._cache_size() == serve0
    assert tb.stats["warm_restores"] >= 20


def test_lru_eviction_and_pinning(tmp_path):
    Xb, yb, ts, _ = _fleet(4, 32, n=4)
    tb = TieredBank.fit(tt(Xb), tt(yb), ts, cold_dir=tmp_path / "cold", capacity=2)
    assert tb.hot_tenants == [0, 1]
    tb.mean_var([0], torch.zeros(1, 2))
    tb.page_in(2)
    assert not tb.is_hot(1) and tb.is_hot(0) and tb.is_hot(2)
    tb.page_in(3, pinned=[2])
    assert tb.is_hot(2) and tb.is_hot(3) and not tb.is_hot(0)
    with pytest.raises(RuntimeError, match="pinned"):
        tb.page_in(0, pinned=[2, 3])
    with pytest.raises(ValueError, match="split the batch"):
        tb.ensure_hot([0, 1, 2])
    with pytest.raises(KeyError):
        tb.page_in("never-seen")


def test_paging_sequence_and_stats_equal_jax(tmp_path):
    """The same calls on both packages' tiers evict the same tenants in the
    same order and keep the same ``stats``, step by step."""
    B, N = 8, 24
    Xb, yb, ts, js = _fleet(B, N, n=4)
    tb = TieredBank.fit(tt(Xb), tt(yb), ts, cold_dir=tmp_path / "c", capacity=3, window=20)
    jtb = JTiered.fit(jnp.asarray(Xb), jnp.asarray(yb), js, cold_dir=tmp_path / "j",
                      capacity=3, window=20)
    rng = np.random.default_rng(12)
    for step in range(25):
        kind = rng.choice(["mean_var", "page_in", "evict", "update"])
        t = int(rng.integers(0, B))
        if kind == "mean_var":
            ids = [int(i) for i in rng.integers(0, B, 3)]
            Xq = _q(step, 3)
            tb.mean_var(ids, tt(Xq))
            jtb.mean_var(ids, jnp.asarray(Xq))
        elif kind == "page_in":
            pin = [int(rng.integers(0, B))]
            if t in tb.cold_tenants:
                tb.page_in(t, pinned=pin)
                jtb.page_in(t, pinned=pin)
        elif kind == "evict":
            if tb.is_hot(t):
                tb.evict_to_cold(t)
                jtb.evict_to_cold(t)
        else:
            Xk = _q(100 + step, 2)[None]
            yk = np.full((1, 2), 0.1 * step, np.float32)
            tb.update([t], tt(Xk), tt(yk))
            jtb.update([t], jnp.asarray(Xk), jnp.asarray(yk))
        assert tb.hot_tenants == jtb.hot_tenants, step
        assert tb.cold_tenants == jtb.cold_tenants, step
        assert list(tb._lru) == list(jtb._lru), step
        assert tb.stats == jtb.stats, step


def test_durable_across_instances(tmp_path):
    Xb, yb, ts, _ = _fleet(4, 32, n=4)
    cold = tmp_path / "cold"
    tb = TieredBank.fit(tt(Xb), tt(yb), ts, cold_dir=cold, capacity=2)
    Xq = tt(_q(3, 4))
    mu0, _ = tb.mean_var([3] * 4, Xq)
    tb2 = TieredBank(GPBank.create(ts, capacity=2), cold)
    assert set(tb2.cold_tenants) >= {2, 3}
    mu1, _ = tb2.mean_var([3] * 4, Xq)
    assert torch.equal(mu0, mu1)


def test_tier_written_by_jax_pages_into_the_port(tmp_path):
    """A cold tier the JAX package wrote (its tenants and window extras)
    serves in the port as in the JAX tier (1e-5), windows bitwise."""
    Xb, yb, ts, js = _fleet(4, 32, n=4)
    cold = tmp_path / "cold"
    jtb = JTiered.fit(jnp.asarray(Xb), jnp.asarray(yb), js, cold_dir=cold, capacity=2,
                      window=30)
    tb = TieredBank(GPBank.create(ts, capacity=2), cold, window=30)
    assert tb.cold_tenants == [2, 3]
    Xq = _q(4, 4)
    mu, var = tb.mean_var([3] * 4, tt(Xq))
    jmu, jvar = jtb.mean_var([3] * 4, jnp.asarray(Xq))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=TOL, rtol=0)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=TOL, rtol=0)
    X, y = tb.window_rows(3)
    assert np.array_equal(X, np.stack([x for x, _ in jtb._rows[3]]))
    assert np.array_equal(y, np.asarray([v for _, v in jtb._rows[3]], np.float32))


def test_string_and_bad_tenant_ids(tmp_path):
    Xb, yb, ts, _ = _fleet(2, 32, n=4)
    tb = TieredBank.fit(tt(Xb), tt(yb), ts, cold_dir=tmp_path / "cold", capacity=2,
                        tenant_ids=["alpha", "b/../c"])
    tb.evict_to_cold("b/../c")
    assert (tb.cold_dir / "sb%2F..%2Fc").exists()
    tb.page_in("b/../c")
    assert tb.is_hot("b/../c")
    with pytest.raises(TypeError, match="int or str"):
        tb.insert((1, 2), (tt(Xb[0]), tt(yb[0])))


# ---------------------------------------------------------------------------
# sliding-window forgetting
# ---------------------------------------------------------------------------


def test_age_window_and_refit_fallback(tmp_path):
    """age() forgets rows beyond the window by the downdate, and a tenant
    whose downdate loses a pivot falls back to the refit of its retained
    window; both then serve as a fresh fit of those rows (1e-5)."""
    B, N, W = 2, 40, 32
    Xb, yb, ts, _ = _fleet(B, N, n=6)
    tb = TieredBank.fit(tt(Xb), tt(yb), ts, cold_dir=tmp_path / "cold", window=W)
    X1, y1 = tb.window_rows(1)
    tb._rows[1] = (np.concatenate([np.full((8, 2), 0.3, np.float32), X1[-W:]]),
                   np.concatenate([np.full(8, 50.0, np.float32), y1[-W:]]))
    out = tb.age()
    assert set(out["aged"]) == {0, 1} and out["refit"] == [1]
    assert out["forgotten_rows"] == 16 and tb.stats["refit_fallbacks"] == 1
    assert all(len(tb.window_rows(t)[1]) == W for t in (0, 1))
    ref = GPBank.fit(tt(Xb[:, N - W:]), tt(yb[:, N - W:]), ts)
    Xq = tt(_q(13, 8))
    for t in (0, 1):
        mu, var = tb.mean_var([t] * 8, Xq)
        mur, varr = ref.mean_var([t] * 8, Xq)
        np.testing.assert_allclose(mu.numpy(), mur.numpy(), atol=TOL, rtol=0)
        np.testing.assert_allclose(var.numpy(), varr.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_age_forgets_the_same_rows_and_serves_as_jax(backend, tmp_path):
    """The same window bookkeeping in both packages (fit rows, then an
    update): ``age`` forgets the same rows, keeps the same windows bitwise,
    and the aged tiers serve within 1e-5 (the port's tier holding the JAX
    tier's factors before aging)."""
    B, N, W = 5, 36, 30
    Xb, yb, ts, js = _fleet(B, N, n=5, backend=backend)
    jtb = JTiered.fit(jnp.asarray(Xb), jnp.asarray(yb), js, cold_dir=tmp_path / "j", window=W)
    tb = TieredBank.fit(tt(Xb), tt(yb), ts, cold_dir=tmp_path / "c", window=W)
    Xk, yk = _q(5, 4 * 3).reshape(4, 3, 2), np.arange(12, dtype=np.float32).reshape(4, 3) / 10
    mk = np.ones((4, 3), np.float32)
    mk[2, 1:] = 0.0
    jtb.update([0, 2, 3, 4], jnp.asarray(Xk), jnp.asarray(yk), jnp.asarray(mk))
    tb.update([0, 2, 3, 4], tt(Xk), tt(yk), tt(mk))
    tb.adopt(_from_jax(jtb.bank, ts))
    out, jout = tb.age([4, 0, 2, 3]), jtb.age([4, 0, 2, 3])
    assert out == jout
    assert out["forgotten_rows"] == 3 * (N + 3 - W) + (N + 1 - W)
    for t in range(B):
        X, y = tb.window_rows(t)
        assert np.array_equal(X, np.stack([x for x, _ in jtb._rows[t]]))
        assert np.array_equal(y, np.asarray([v for _, v in jtb._rows[t]], np.float32))
    Xq = _q(6, 10)
    ids = [0, 1, 2, 3, 4, 4, 3, 2, 1, 0]
    mu, var = tb.mean_var(ids, tt(Xq))
    jmu, jvar = jtb.mean_var(ids, jnp.asarray(Xq))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=TOL, rtol=0)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=TOL, rtol=0)
    assert tb.stats == jtb.stats


def test_window_rides_cold_checkpoints(tmp_path):
    Xb, yb, ts, _ = _fleet(2, 40, n=5)
    tb = TieredBank.fit(tt(Xb), tt(yb), ts, cold_dir=tmp_path / "cold", window=36)
    X0, y0 = tb.window_rows(0)
    tb.evict_to_cold(0)
    tb._rows.pop(0, None)
    tb.page_in(0)
    assert np.array_equal(tb.window_rows(0)[0], X0) and np.array_equal(tb.window_rows(0)[1], y0)


# ---------------------------------------------------------------------------
# the engine pages cold tenants in
# ---------------------------------------------------------------------------


def _tiered_engine(tmp_path, *, capacity=3, window=0, B=6):
    Xb, yb, ts, _ = _fleet(B, 32)
    tb = TieredBank.fit(tt(Xb), tt(yb), ts, cold_dir=tmp_path / "cold", capacity=capacity,
                        window=window)
    eng = FleetEngine(BankRouter(tb.bank, microbatch=8), max_in_flight=2, tiered=tb,
                      auto_pump=False)
    return tb, eng, GPBank.fit(tt(Xb), tt(yb), ts)


def test_submit_pages_in_without_stalling_in_flight(tmp_path):
    tb, eng, ref = _tiered_engine(tmp_path)
    xs = _q(17, 16)
    hot = tb.hot_tenants[0]
    t_hot = [eng.submit(hot, xs[i]) for i in range(8)]
    eng.pump(max_blocks=1)
    assert eng.in_flight_blocks == 1
    cold = tb.cold_tenants[0]
    t_cold = [eng.submit(cold, xs[8 + i]) for i in range(8)]
    assert eng.in_flight_blocks == 1
    assert tb.is_hot(cold) and tb.is_hot(hot)
    res = eng.drain()
    for i, tk in enumerate(t_hot + t_cold):
        mur, _ = ref.mean_var([hot if i < 8 else cold], tt(xs[i][None]))
        assert abs(res[tk].mu - float(mur[0])) <= TOL


def test_full_pin_coverage_drains_and_succeeds(tmp_path):
    tb, eng, ref = _tiered_engine(tmp_path, capacity=2, B=4)
    rng = np.random.default_rng(19)
    xs = _q(19, 12)
    tickets, expect = [], []
    for i in range(12):
        t = int(rng.integers(0, 4))
        tickets.append(eng.submit(t, xs[i]))
        expect.append(t)
    res = eng.drain()
    for i, tk in enumerate(tickets):
        mur, _ = ref.mean_var([expect[i]], tt(xs[i][None]))
        assert abs(res[tk].mu - float(mur[0])) <= TOL


def test_observe_and_ingest_record_window_rows(tmp_path):
    tb, eng, ref = _tiered_engine(tmp_path, window=40)
    cold = tb.cold_tenants[0]
    xs = _q(23, 3)
    for i in range(3):
        eng.observe(cold, xs[i], float(i) * 0.1)
    assert tb.is_hot(cold)
    before = len(tb.window_rows(cold)[1])
    assert eng.ingest() == 3
    assert len(tb.window_rows(cold)[1]) == before + 3
    assert eng.router.bank is tb.bank
    ref2 = ref.update([cold], tt(xs[None]), tt(np.array([[0.0, 0.1, 0.2]], np.float32)))
    mu, _ = tb.mean_var([cold] * 3, tt(xs))
    mur, _ = ref2.mean_var([cold] * 3, tt(xs))
    np.testing.assert_allclose(mu.numpy(), mur.numpy(), atol=TOL, rtol=0)


def test_router_staleness_retained_for_cold_tenants(tmp_path):
    Xb, yb, ts, _ = _fleet(3, 32, n=4)
    tb = TieredBank.fit(tt(Xb), tt(yb), ts, cold_dir=tmp_path / "cold")
    router = BankRouter(tb.bank)
    router._since_reopt[0] = 20
    tb.evict_to_cold(0)
    router.bank = tb.bank
    assert router.stale_tenants(10, retain=tb.tenants) == []
    tb.page_in(0)
    router.bank = tb.bank
    assert router.stale_tenants(10, retain=tb.tenants) == [0]
    router._since_reopt[1] = 20
    tb.evict_to_cold(1)
    router.bank = tb.bank
    router.stale_tenants(10)
    tb.page_in(1)
    router.bank = tb.bank
    assert router.stale_tenants(10) == [0]


# ---------------------------------------------------------------------------
# serve_fleet with the cold tier and a window, against the JAX run
# ---------------------------------------------------------------------------

TIERED = dict(tenants=8, n_train=24, p=2, n=4, rounds=2, queries_per_round=64,
              observations_per_round=48, microbatch=8, ingest_chunk=4, seed=2,
              capacity=6, window=24, reopt_every=2, reopt_min_rows=4, reopt_steps=3,
              reopt_restarts=1)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_serve_fleet_tiered_matches_jax(backend, tmp_path):
    """``serve_fleet(engine="pipelined", cold_dir=..., window=...)`` on the
    same seed in both packages: the same rows absorbed, timeouts, aged rows
    and re-optimized tenants per round, rmse within 1e-5, the same lifecycle
    stats."""
    mine = t_serve.serve_fleet(backend=backend, device="cpu", cold_dir=str(tmp_path / "c"),
                               **TIERED)
    ref = j_serve.serve_fleet(backend=backend, cold_dir=str(tmp_path / "j"), **TIERED)
    assert sum(h["aged_rows"] for h in mine["rounds"]) > 0
    assert mine["lifecycle"]["warm_restores"] > 0
    for a, b in zip(mine["rounds"], ref["rounds"]):
        for k in ("rows_absorbed", "timeouts", "aged_rows", "reopt_tenants"):
            assert a[k] == b[k], k
        assert abs(a["rmse"] - b["rmse"]) <= TOL
        assert a["rmse"] < 0.1
    assert mine["lifecycle"] == ref["lifecycle"]
