"""Port parity for the heterogeneous bank and re-optimizing fleets (ROADMAP
A3): ``GPBank.optimize``, the per-slot hyperparameter overlay
(``GPBank(hypers=...)``, ``state(t)``, serving, update, downdate, refit,
insert and evict under per-slot (eps, rho, noise)), ``BankRouter``'s
staleness counting and ``reoptimize``, ``serve_fleet(reopt_every=...)``
and heterogeneous checkpoints, against the JAX package on the same numpy
inputs (its ``pallas`` backend in interpret mode; the port's kernels'
plain versions on the CPU).

Gates are the JAX package's: bank optimize against a loop of
``GP.optimize`` (rtol 5e-3, atol 2e-4; tests/test_gp_hyperopt.py:293-318),
an optimized subset leaves the others untouched (1e-6, :320-336), a
heterogeneous update against ``fit_update`` (1e-5, :338-354), the
heterogeneous RFF bank at tests/test_expansions.py's gates, and across the
two packages the gates tests/test_torch_hyperopt.py already holds
``GP.optimize`` to (final NLML per row rtol 1e-3, posterior rtol 5e-3,
atol 2e-4; restarts=1, where both packages start their lanes at the spec).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_common import nn, specs, tt, uniform  # noqa: E402

from repro.bank import BankRouter as JRouter  # noqa: E402
from repro.bank import GPBank as JBank  # noqa: E402
from repro.core import fagp as jfagp  # noqa: E402
from repro.core.gp import GP as JGP  # noqa: E402
from repro.data import make_gp_dataset as j_make  # noqa: E402
from repro.launch.serve_gp import serve_fleet as j_serve_fleet  # noqa: E402
from repro_torch.bank import BankRouter, GPBank  # noqa: E402
from repro_torch.core import SEKernelParams, fagp  # noqa: E402
from repro_torch.core.convert import bank_from_numpy  # noqa: E402
from repro_torch.core.gp import GP  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve_gp as t_serve  # noqa: E402

BACKENDS = ["jnp", "pallas"]
LEAVES = ("lam", "sqrtlam", "chol", "u", "b")
POST = dict(rtol=5e-3, atol=2e-4)          # tests/test_gp_hyperopt.py:313-316


def _fleet_data(B, N, p=2, seed=0):
    """tests/test_gp_hyperopt.py::_fleet_data: tenant s gets
    make_gp_dataset(N, p, seed=seed + s)."""
    Xb = np.zeros((B, N, p), np.float32)
    yb = np.zeros((B, N), np.float32)
    for s in range(B):
        X, y, *_ = j_make(N, p, seed=seed + s)
        Xb[s], yb[s] = np.asarray(X), np.asarray(y)
    return Xb, yb


def _bank(B=3, N=16, backend="jnp", expansion="hermite", seed=0):
    """The port's bank of tests/test_gp_hyperopt.py::_spec's spec."""
    Xb, yb = _fleet_data(B, N, seed=seed)
    js, ts = specs(expansion, 2, n=5, backend=backend, num_features=16, seed=0)
    return GPBank.fit(tt(Xb), tt(yb), ts), Xb, yb, js, ts


def _Xq(rows, seed):
    return tt(uniform(np.random.default_rng(seed), (rows, 2)))


# ---------------------------------------------------------------------------
# tests/test_gp_hyperopt.py::TestGPBankOptimize, in the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_bank_optimize_matches_gp_loop(backend):
    """GPBank.optimize selects exactly the hyperparameters of a loop of
    GP.optimize runs (the lanes are per-tenant programs), and the refit
    bank serves as GP.fit at the learned values."""
    bank, Xb, yb, _, ts = _bank(backend=backend)
    opt = bank.optimize(tt(Xb), tt(yb), restarts=2, steps=6, seed=5)
    assert isinstance(opt.hypers, SEKernelParams) and bank.hypers is None
    Xq = _Xq(6, 1)
    for t in range(3):
        gp = GP.optimize(tt(Xb[t]), tt(yb[t]), ts, restarts=2, steps=6, seed=5)
        st = opt.state(t)
        for f in ("eps", "rho", "noise"):
            assert torch.equal(getattr(st.spec, f), getattr(gp.spec, f)), f
        m1, v1 = gp.mean_var(Xq)
        m2, v2 = opt.mean_var([t] * 6, Xq)
        np.testing.assert_allclose(nn(m2), nn(m1), **POST)
        np.testing.assert_allclose(nn(v2), nn(v1), **POST)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bank_optimize_matches_jax(backend):
    """GPBank.optimize(restarts=1) in both packages, at the problem
    tests/test_torch_hyperopt.py::test_gp_optimize_matches_jax holds
    GP.optimize to (N = 64, p = 2, n = 5, 8 steps), three tenants: each
    tenant's final NLML per row at rtol 1e-3 and its serving at the
    posterior gate; the learned hyperparameters' largest gap printed (the
    JAX package has no gate across implementations)."""
    bank, Xb, yb, js, _ = _bank(N=64, backend=backend)
    jb = JBank.fit(jnp.asarray(Xb), jnp.asarray(yb), js)
    opt = bank.optimize(tt(Xb), tt(yb), restarts=1, steps=8)
    jopt = jb.optimize(jnp.asarray(Xb), jnp.asarray(yb), restarts=1, steps=8)
    gap = max(float(np.abs(nn(getattr(opt.hypers, f)) - np.asarray(getattr(jopt.hypers, f))).max())
              for f in ("eps", "rho", "noise"))
    print(f"largest gap in the learned hyperparameters: {gap:.3e}")
    Xq = _Xq(32, 5)
    ids = [int(t) for t in np.random.default_rng(3).integers(0, 3, 32)]
    m1, v1 = jopt.mean_var(ids, jnp.asarray(nn(Xq)))
    m2, v2 = opt.mean_var(ids, Xq)
    np.testing.assert_allclose(nn(m2), np.asarray(m1), **POST)
    np.testing.assert_allclose(nn(v2), np.asarray(v1), **POST)
    for t in range(3):
        want = float(jfagp.nlml(jnp.asarray(Xb[t]), jnp.asarray(yb[t]), jopt.state(t).spec)) / 64
        got = float(fagp.nlml(tt(Xb[t]), tt(yb[t]), opt.state(t).spec)) / 64
        assert abs(got - want) <= 1e-3 * abs(want)


def test_optimize_subset_leaves_others_untouched():
    bank, Xb, yb, _, ts = _bank()
    opt = bank.optimize(tt(Xb[1:2]), tt(yb[1:2]), tenant_ids=[1], restarts=2, steps=5, seed=0)
    Xq = _Xq(4, 2)
    m0a, v0a = bank.mean_var([0] * 4, Xq)
    m0b, v0b = opt.mean_var([0] * 4, Xq)
    np.testing.assert_allclose(nn(m0b), nn(m0a), atol=1e-6)
    np.testing.assert_allclose(nn(v0b), nn(v0a), atol=1e-6)
    # untouched tenants keep the bank spec's hyperparameters and leaves
    assert torch.equal(opt.state(0).spec.eps, ts.eps)
    for f in LEAVES:
        assert torch.equal(getattr(opt.stack, f)[0], getattr(bank.stack, f)[0]), f
    assert float(opt.state(1).spec.noise) != float(ts.noise)


@pytest.mark.parametrize("backend", BACKENDS)
def test_hetero_update_matches_fit_update(backend):
    bank, Xb, yb, _, _ = _bank(backend=backend)
    opt = bank.optimize(tt(Xb), tt(yb), restarts=2, steps=5, seed=3)
    rng = np.random.default_rng(4)
    Xk = tt(rng.uniform(-1, 1, (2, 4, 2)))
    yk = tt(rng.standard_normal((2, 4)))
    Xq = _Xq(5, 6)
    up = opt.update([0, 2], Xk, yk)
    for g, t in enumerate((0, 2)):
        st = fagp.fit_update(opt.state(t), Xk[g], yk[g])
        m1, v1 = fagp.predict_mean_var(st, Xq)
        m2, v2 = up.mean_var([t] * 5, Xq)
        np.testing.assert_allclose(nn(m2), nn(m1), atol=1e-5)
        np.testing.assert_allclose(nn(v2), nn(v1), atol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_hetero_downdate_and_refit_follow_each_slots_hypers(backend):
    """On a heterogeneous bank the downdate of rows a tenant absorbed equals
    refit_window on its retained rows (1e-5), both under the slot's own
    hyperparameters, and the refit keeps the learned eigenvalue rows."""
    bank, Xb, yb, _, _ = _bank(B=3, N=40, backend=backend)
    opt = bank.optimize(tt(Xb), tt(yb), restarts=1, steps=4)
    k = 6
    down, ok = opt.downdate([0, 2], tt(Xb[[0, 2], :k]), tt(yb[[0, 2], :k]))
    refit = opt.refit_window([0, 2], tt(Xb[[0, 2], k:]), tt(yb[[0, 2], k:]))
    assert ok.all()
    for f in ("lam", "sqrtlam"):
        assert torch.equal(getattr(refit.stack, f), getattr(opt.stack, f)), f
    Xq = _Xq(10, 7)
    ids = [0, 2] * 5
    for a, b in zip(down.mean_var(ids, Xq), refit.mean_var(ids, Xq)):
        np.testing.assert_allclose(nn(a), nn(b), atol=1e-5, rtol=0)


def test_hetero_insert_evict_roundtrip():
    """A heterogeneous bank admits a tenant fitted under ITS OWN
    hyperparameters (structure shared), serves it as its own session, and
    evict resets the slot to the bank spec's prior."""
    bank, Xb, yb, _, ts = _bank()
    opt = bank.optimize(tt(Xb), tt(yb), restarts=2, steps=5, seed=6)
    ev = opt.evict(1)
    assert torch.equal(ev.hypers.eps[1], ts.eps) and torch.equal(ev.hypers.noise[1], ts.noise)
    X, y, *_ = j_make(16, 2, seed=50)
    foreign = fagp.fit(tt(np.asarray(X)), tt(np.asarray(y)),
                       ts.replace(eps=tt(np.array([1.5, 0.4], np.float32)), noise=tt(0.3)))
    ins = ev.insert("f", foreign)
    Xq = _Xq(5, 3)
    m1, v1 = fagp.predict_mean_var(foreign, Xq)
    m2, v2 = ins.mean_var(["f"] * 5, Xq)
    np.testing.assert_allclose(nn(m2), nn(m1), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(nn(v2), nn(v1), rtol=1e-4, atol=1e-5)
    assert torch.equal(ins.state("f").spec.eps, foreign.spec.eps)
    other = fagp.fit(tt(np.asarray(X)), tt(np.asarray(y)), ts.replace(n=4))
    with pytest.raises(ValueError, match="expansion structure"):
        ins.evict("f").insert("g", other)


def test_hetero_churn_serves_through_the_same_kernels():
    """Churn through a heterogeneous bank (evict, insert, serve) takes the
    same kernel calls every time: one per-row features call on the bank's
    stacked (capacity, p, 3) constants per mean_var (on the card one
    launch of the features kernel), whatever the tenant mix."""
    bank, Xb, yb, _, _ = _bank(B=3, backend="pallas")
    opt = bank.optimize(tt(Xb), tt(yb), restarts=2, steps=4, seed=7)
    Xq = _Xq(4, 5)
    calls = []
    real = ops.expansion_phi

    def spy(X, tile, slots=None):
        calls.append((tile.slots, tuple(X.shape), slots is not None))
        return real(X, tile, slots)

    b = opt.evict(2).insert("warm", tuple(tt(np.asarray(a)) for a in j_make(16, 2, seed=60)[:2]))
    ops.expansion_phi = spy
    try:
        for r in range(3):
            Xn, yn, *_ = j_make(16, 2, seed=70 + r)
            b = b.evict("warm" if r == 0 else f"t{r - 1}")
            b = b.insert(f"t{r}", (tt(np.asarray(Xn)), tt(np.asarray(yn))))
            calls.clear()
            mu, _ = b.mean_var([f"t{r}", 0, 1, f"t{r}"], Xq)
            assert np.all(np.isfinite(nn(mu)))
            assert calls == [(3, (4, 2), True)]
    finally:
        ops.expansion_phi = real


def test_optimize_validates_inputs():
    bank, Xb, yb, _, _ = _bank()
    with pytest.raises(ValueError, match="one tenant id per data row"):
        bank.optimize(tt(Xb), tt(yb), tenant_ids=[0, 1])
    with pytest.raises(ValueError, match="duplicate tenant"):
        bank.optimize(tt(Xb), tt(yb), tenant_ids=[0, 0, 1])
    with pytest.raises(ValueError, match="mask must be"):
        bank.optimize(tt(Xb), tt(yb), mask=torch.ones(2, 2))
    with pytest.raises(TypeError, match="SEKernelParams"):
        GPBank(stack=bank.stack, active=bank.active, slots=bank.slots, hypers=object())
    with pytest.raises(ValueError, match="hypers.eps"):
        GPBank(stack=bank.stack, active=bank.active, slots=bank.slots,
               hypers=SEKernelParams.create(np.ones(2), 2.0, 0.1, device="cpu"))


def test_bank_accepts_a_per_slot_overlay_and_serves_each_slot_as_its_state():
    """GPBank(hypers=...): state(t) carries the slot's own spec, and a
    session built from it serves as the bank does (1e-5)."""
    bank, Xb, yb, _, ts = _bank()
    opt = bank.optimize(tt(Xb), tt(yb), restarts=1, steps=4)
    again = GPBank(stack=opt.stack, active=opt.active, slots=opt.slots, hypers=opt.hypers)
    Xq = _Xq(8, 9)
    for t in range(3):
        st = again.state(t)
        assert torch.equal(st.spec.noise, opt.hypers.noise[t])
        for a, b in zip(GP.from_state(st).mean_var(Xq), again.mean_var([t] * 8, Xq)):
            np.testing.assert_allclose(nn(b), nn(a), atol=1e-5, rtol=0)


def test_jax_hetero_bank_carried_across_serves_as_jax():
    """A JAX heterogeneous bank's leaves and overlay through
    bank_from_numpy serve as the JAX bank does (1e-5, tests/test_gp_bank.py:90)."""
    _, Xb, yb, js, ts = _bank()
    jopt = JBank.fit(jnp.asarray(Xb), jnp.asarray(yb), js).optimize(
        jnp.asarray(Xb), jnp.asarray(yb), restarts=1, steps=4)
    st = jopt.stack
    tb = bank_from_numpy(**{f: np.asarray(getattr(st, f)) for f in ("idx",) + LEAVES},
                         slots=dict(jopt.slots), active=jopt.active, spec=ts,
                         hypers=jopt.hypers)
    Xq = _Xq(12, 4)
    ids = [0, 1, 2] * 4
    for a, b in zip(tb.mean_var(ids, Xq), jopt.mean_var(ids, jnp.asarray(nn(Xq)))):
        np.testing.assert_allclose(nn(a), np.asarray(b), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the heterogeneous RFF bank (tests/test_expansions.py:228-283's gates)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("expansion", ["rff_se", "rff_matern52"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_rff_hetero_bank_matches_its_sessions(expansion, backend):
    """A heterogeneous RFF bank serves a mixed batch as each tenant's own
    session.  On the jnp backend every row runs under its slot's own table
    (1e-5); on the pallas backend the rows are scaled by their slot's eps
    over the bank's under the shared table, which rounds differently: the
    JAX package's RFF gates (tests/test_expansions.py:181-183)."""
    bank, Xb, yb, _, _ = _bank(B=4, backend=backend, expansion=expansion)
    opt = bank.optimize(tt(Xb), tt(yb), restarts=1, steps=5)
    assert not torch.equal(opt.hypers.eps[0], bank.spec.eps)
    Xq = _Xq(12, 8)
    ids = [int(t) for t in np.random.default_rng(9).integers(0, 4, 12)]
    mu, var = opt.mean_var(ids, Xq)
    gates = (dict(atol=1e-5, rtol=0), dict(atol=1e-5, rtol=0)) if backend == "jnp" else \
        (dict(rtol=1e-3, atol=1e-4), dict(rtol=5e-3, atol=1e-6))
    for t in sorted(set(ids)):
        rows = [i for i, x in enumerate(ids) if x == t]
        m1, v1 = GP.from_state(opt.state(t)).mean_var(Xq[rows])
        np.testing.assert_allclose(nn(mu[rows]), nn(m1), **gates[0])
        np.testing.assert_allclose(nn(var[rows]), nn(v1), **gates[1])


# ---------------------------------------------------------------------------
# the router (tests/test_gp_hyperopt.py::TestRouterReopt) and serve_fleet
# ---------------------------------------------------------------------------


def test_stale_counting_and_reoptimize():
    bank, Xb, yb, _, _ = _bank()
    router = BankRouter(bank, ingest_chunk=4)
    rng = np.random.default_rng(8)
    for t, cnt in ((0, 5), (2, 2)):
        for _ in range(cnt):
            router.observe(t, rng.uniform(-1, 1, 2).astype(np.float32),
                           float(rng.standard_normal()))
    assert router.ingest() == 7
    assert router.stale_tenants(3) == [0]
    assert set(router.stale_tenants(1)) == {0, 2}
    router.reoptimize([0], tt(Xb[:1]), tt(yb[:1]), restarts=2, steps=4, seed=0)
    assert router.bank.hypers is not None
    assert router.stale_tenants(1) == [2]
    tk = router.submit(0, np.zeros(2, np.float32))
    assert np.isfinite(router.flush()[tk][0])
    # the JAX router counts the same
    jr = JRouter(JBank.fit(jnp.asarray(Xb), jnp.asarray(yb), _bank()[3]), ingest_chunk=4)
    rng = np.random.default_rng(8)
    for t, cnt in ((0, 5), (2, 2)):
        for _ in range(cnt):
            jr.observe(t, rng.uniform(-1, 1, 2).astype(np.float32), float(rng.standard_normal()))
    jr.ingest()
    assert jr.stale_tenants(3) == [0] and set(jr.stale_tenants(1)) == {0, 2}


def test_reoptimize_empty_is_noop_and_evicted_counters_drop():
    bank, Xb, yb, _, _ = _bank(B=2)
    router = BankRouter(bank)
    router.reoptimize([], tt(Xb[:0]), tt(yb[:0]))
    assert router.bank is bank
    router.observe(1, np.zeros(2, np.float32), 0.5)
    router.ingest()
    assert router.stale_tenants(1) == [1]
    router.bank = router.bank.evict(1)
    assert router.stale_tenants(1, retain=[1]) == [] and 1 in router._since_reopt
    assert router.stale_tenants(1) == [] and 1 not in router._since_reopt


FLEET = dict(tenants=5, n_train=48, p=2, n=5, rounds=2, queries_per_round=70,
             observations_per_round=40, microbatch=16, ingest_chunk=4, noise=0.05, seed=0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_fleet_reopt_matches_jax(backend):
    """serve_fleet(engine="sync", reopt_every=1, reopt_restarts=1) in both
    packages: the same stale tenants re-optimized each round, the same rows
    absorbed, and rmse equal within the 1e-5 serving gate; the bank comes
    back heterogeneous."""
    kw = dict(FLEET, backend=backend, engine="sync", reopt_every=1, reopt_min_rows=6,
              reopt_steps=3, reopt_restarts=1)
    got = t_serve.serve_fleet(device="cpu", **kw)
    want = j_serve_fleet(**kw)
    assert [h["reopt_tenants"] for h in got["rounds"]] == \
        [h["reopt_tenants"] for h in want["rounds"]]
    assert sum(h["reopt_tenants"] for h in got["rounds"]) > 0
    for g, w in zip(got["rounds"], want["rounds"]):
        assert g["rows_absorbed"] == w["rows_absorbed"]
        assert abs(g["rmse"] - w["rmse"]) < 1e-5
        assert g["rmse"] < 0.1 and g["var_finite"]
        assert (g["reopt_s"] > 0) == (g["reopt_tenants"] > 0)
    assert got["bank"].hypers is not None


def test_fleet_cli_reopt_every_runs_on_cpu(capsys):
    t_serve.main(["--fleet", "3", "--engine", "sync", "--backend", "pallas",
                  "--device", "cpu", "--n-train", "32", "--n", "4", "--rounds", "2",
                  "--update-size", "60", "--queries", "20", "--microbatch", "8",
                  "--reopt-every", "1"])
    out = capsys.readouterr().out
    assert "reopt 3 tenants" in out


# ---------------------------------------------------------------------------
# heterogeneous slots' checkpoints (tests/test_lifecycle.py:233-255 through
# GP.save / GP.load)
# ---------------------------------------------------------------------------


def _same(a, b):
    a, b = nn(a), nn(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_hetero_slot_round_trips_bit_exactly(tmp_path):
    bank, Xb, yb, _, _ = _bank(B=3, N=32)
    opt = bank.optimize(tt(Xb), tt(yb), steps=6, restarts=1)
    before = opt.state(1)
    GP.from_state(before).save(tmp_path)
    after = GP.load(tmp_path, device="cpu").state
    for f in LEAVES:
        assert _same(getattr(after, f), getattr(before, f)), f
    for f in ("eps", "rho", "noise"):
        assert _same(getattr(after.spec, f), getattr(before.spec, f)), f
    assert not _same(after.spec.eps, bank.spec.eps)
    # and it rejoins a heterogeneous bank, serving as before
    back = opt.evict(1).insert(1, after)
    Xq = _Xq(6, 2)
    for a, b in zip(back.mean_var([1] * 6, Xq), opt.mean_var([1] * 6, Xq)):
        np.testing.assert_allclose(nn(a), nn(b), atol=1e-6, rtol=0)


def test_hetero_slots_cross_load_both_ways(tmp_path):
    """A JAX heterogeneous slot saved by the JAX package loads in the port
    with the same bytes, and the port's loads in the JAX package."""
    bank, Xb, yb, js, _ = _bank(B=3, N=32)
    jopt = JBank.fit(jnp.asarray(Xb), jnp.asarray(yb), js).optimize(
        jnp.asarray(Xb), jnp.asarray(yb), steps=6, restarts=1)
    jst = jopt.state(2)
    JGP.from_state(jst).save(tmp_path / "jax")
    got = GP.load(tmp_path / "jax", device="cpu").state
    topt = bank.optimize(tt(Xb), tt(yb), steps=6, restarts=1)
    tst = topt.state(2)
    GP.from_state(tst).save(tmp_path / "port")
    back = JGP.load(tmp_path / "port").state
    for f in LEAVES:
        assert _same(getattr(got, f), getattr(jst, f)), f
        assert _same(getattr(back, f), getattr(tst, f)), f
    for f in ("eps", "rho", "noise"):
        assert _same(getattr(got.spec, f), getattr(jst.spec, f)), f
        assert _same(getattr(back.spec, f), getattr(tst.spec, f)), f
