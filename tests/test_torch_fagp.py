"""Port parity for the FAGP slice: fit (single and multi-output),
predict_mean_var, predict, fit_update on both sides of the K*8 <= M switch,
masked nlml, the GP facade, and carrying a JAX-fitted state across."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_common import gp_data, nn, specs, tt, uniform  # noqa: E402

from repro.core import exact_gp as jexact  # noqa: E402
from repro.core import fagp as jfagp  # noqa: E402
from repro.core import mercer as jm  # noqa: E402
from repro.core.gp import GP as JGP  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import exact_gp as texact  # noqa: E402
from repro_torch.core import fagp as tfagp  # noqa: E402
from repro_torch.core.approximation import UnsupportedError  # noqa: E402
from repro_torch.core.gp import GP, GPSpec  # noqa: E402

EXPANSIONS = ["hermite", "rff_se", "rff_matern52"]
BACKENDS = ["jnp", "pallas"]


def _fitted(expansion, backend, *, N=180, p=2, n=6, R=24, seed=1, T=None):
    X, y = gp_data(N, p, seed)
    if T is not None:
        y = np.stack([y * (t + 1) - t for t in range(T)], axis=1).astype(np.float32)
    js, ts = specs(expansion, p, n=n, num_features=R, backend=backend, block_rows=64)
    return X, y, js, ts, jfagp.fit(jnp.asarray(X), jnp.asarray(y), js), tfagp.fit(tt(X), tt(y), ts)


def _assert_state_close(st_t, st_j):
    # tests/test_streaming_fit.py:214 gate: rtol 5e-3 on u, chol and b, which
    # the JAX package applies to Hermite fits.  For the RFF families it
    # holds fits to each other by their mean and variance only
    # (tests/test_expansions.py:181): the small RFF systems here have
    # cond(B) ~ 3e4, where f32 JAX and f32 torch both sit ~7e-4 from the
    # float64 solution for u.  b, a plain moment, is gated for all.
    if st_t.spec.expansion == "hermite":
        np.testing.assert_allclose(nn(st_t.u), nn(st_j.u), rtol=5e-3, atol=1e-4)
        np.testing.assert_allclose(nn(st_t.chol), nn(st_j.chol), rtol=5e-3, atol=1e-3)
    np.testing.assert_allclose(nn(st_t.b), nn(st_j.b), rtol=5e-3, atol=1e-3)


def _assert_mean_var_close(mv_t, mv_j):
    # tests/test_kernels.py:168 gates: 1e-3 on the mean, 2e-3 on the variance
    np.testing.assert_allclose(nn(mv_t[0]), nn(mv_j[0]), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(nn(mv_t[1]), nn(mv_j[1]), rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("expansion", EXPANSIONS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_fit_and_mean_var_match(expansion, backend):
    X, y, js, ts, st_j, st_t = _fitted(expansion, backend)
    _assert_state_close(st_t, st_j)
    Xs = uniform(np.random.default_rng(9), (50, 2))
    _assert_mean_var_close(tfagp.predict_mean_var(st_t, tt(Xs)),
                           jfagp.predict_mean_var(st_j, jnp.asarray(Xs)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_multi_output_fit_matches(backend):
    X, y, js, ts, st_j, st_t = _fitted("hermite", backend, T=3)
    assert st_t.n_tasks == 3 and tuple(st_t.u.shape) == (st_t.n_features, 3)
    _assert_state_close(st_t, st_j)
    Xs = uniform(np.random.default_rng(4), (30, 2))
    _assert_mean_var_close(tfagp.predict_mean_var(st_t, tt(Xs)),
                           jfagp.predict_mean_var(st_j, jnp.asarray(Xs)))


def test_predict_fused_matches():
    X, y, js, ts, st_j, st_t = _fitted("hermite", "pallas")
    Xs = uniform(np.random.default_rng(2), (25, 2))
    mu_t, cov_t = tfagp.predict(st_t, tt(Xs))
    mu_j, cov_j = jfagp.predict(st_j, jnp.asarray(Xs))
    np.testing.assert_allclose(nn(mu_t), nn(mu_j), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(nn(cov_t), nn(cov_j), rtol=2e-3, atol=1e-5)
    # the serving variance is the covariance's diagonal (tests/test_fagp.py:168)
    _, var_t = tfagp.predict_mean_var(st_t, tt(Xs))
    np.testing.assert_allclose(nn(var_t), np.diag(nn(cov_t)), rtol=1e-4, atol=1e-7)


# (n, k): M = 36 takes the sweep for k = 4 (32 <= 36) and the refactor for
# k = 16; M = 125 (p = 3, n = 5) takes the sweep for k = 8
@pytest.mark.parametrize("p,n,k", [(2, 6, 4), (2, 6, 16), (3, 5, 8)])
@pytest.mark.parametrize("backend", BACKENDS)
def test_fit_update_matches_jax_and_refit(p, n, k, backend):
    X, y, js, ts, st_j, st_t = _fitted("hermite", backend, p=p, n=n, N=150)
    Xn, yn = gp_data(k, p, 11)
    up_j = jfagp.fit_update(st_j, jnp.asarray(Xn), jnp.asarray(yn))
    up_t = tfagp.fit_update(st_t, tt(Xn), tt(yn))
    _assert_state_close(up_t, up_j)
    re_t = tfagp.fit(tt(np.concatenate([X, Xn])), tt(np.concatenate([y, yn])), ts)
    np.testing.assert_allclose(nn(up_t.u), nn(re_t.u), rtol=5e-3, atol=1e-4)
    Xs = uniform(np.random.default_rng(3), (40, p))
    _assert_mean_var_close(tfagp.predict_mean_var(up_t, tt(Xs)),
                           jfagp.predict_mean_var(up_j, jnp.asarray(Xs)))


def test_fit_update_takes_the_backend_sweep(monkeypatch):
    """K*8 <= M routes through the backend's rank_update hook, else the
    refactorization."""
    calls = []
    backend = tfagp.get_backend("pallas")
    hooked = tfagp.FitBackend(**{**vars(backend), "rank_update":
                                 lambda L, W: calls.append(W.shape) or backend.rank_update(L, W)})
    monkeypatch.setitem(tfagp._BACKENDS, "pallas", hooked)
    X, y, js, ts, st_j, st_t = _fitted("hermite", "pallas", p=2, n=6, N=80)
    tfagp.fit_update(st_t, *map(tt, gp_data(4, 2, 5)))
    tfagp.fit_update(st_t, *map(tt, gp_data(16, 2, 5)))
    assert calls == [(4, 36)]


@pytest.mark.parametrize("expansion", EXPANSIONS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_nlml_masked_matches(expansion, backend):
    X, y = gp_data(140, 2, 6)
    mask = (np.arange(140) % 7 != 3).astype(np.float32)
    js, ts = specs(expansion, 2, n=6, num_features=24, backend=backend)
    want = float(jfagp.nlml(jnp.asarray(X), jnp.asarray(y), js, mask=jnp.asarray(mask)))
    got = float(tfagp.nlml(tt(X), tt(y), ts, mask=tt(mask)))
    # tests/test_expansions.py:187 gate: |d| < 1e-2 * max(1, |nlml|)
    assert abs(got - want) < 1e-2 * max(1.0, abs(want))
    keep = mask > 0
    sub = float(tfagp.nlml(tt(X[keep]), tt(y[keep]), ts))
    assert abs(got - sub) < 1e-2 * max(1.0, abs(sub))


def test_nlml_multi_output_sums_tasks():
    X, y = gp_data(120, 2, 2)
    Y = np.stack([y, 1.0 - y], axis=1).astype(np.float32)
    _, ts = specs("hermite", 2, n=5, backend="pallas")
    total = float(tfagp.nlml(tt(X), tt(Y), ts))
    per = sum(float(tfagp.nlml(tt(X), tt(Y[:, t]), ts)) for t in range(2))
    assert abs(total - per) < 1e-2 * max(1.0, abs(per))


def test_state_from_numpy_round_trip():
    """A JAX-fitted state carried across serves as it did in JAX."""
    X, y = gp_data(200, 2, 8)
    js, _ = specs("rff_se", 2, num_features=32, backend="pallas")
    st_j = jfagp.fit(jnp.asarray(X), jnp.asarray(y), js)
    st_t = convert.state_from_numpy(
        idx=np.asarray(st_j.idx), lam=np.asarray(st_j.lam),
        sqrtlam=np.asarray(st_j.sqrtlam), chol=np.asarray(st_j.chol),
        u=np.asarray(st_j.u), b=np.asarray(st_j.b),
        eps=np.asarray(js.eps), rho=np.asarray(js.rho), noise=np.asarray(js.noise),
        omega=np.asarray(js.omega), n=js.n, index_set=js.index_set,
        degree=js.degree, expansion=js.expansion, backend=js.backend, device="cpu",
    )
    np.testing.assert_array_equal(nn(st_t.chol), np.asarray(st_j.chol))
    Xs = uniform(np.random.default_rng(1), (40, 2))
    _assert_mean_var_close(GP.from_state(st_t).mean_var(tt(Xs)),
                           JGP.from_state(st_j).mean_var(jnp.asarray(Xs)))
    with pytest.raises(ValueError, match="index table"):
        convert.state_from_numpy(
            idx=np.asarray(st_j.idx)[:-2], lam=np.asarray(st_j.lam),
            sqrtlam=np.asarray(st_j.sqrtlam), chol=np.asarray(st_j.chol),
            u=np.asarray(st_j.u), b=np.asarray(st_j.b), spec=st_t.spec)


def test_exact_gp_oracle_matches():
    X, y = gp_data(60, 2, 3)
    Xs = uniform(np.random.default_rng(0), (20, 2))
    eps = np.full((2,), 0.8, np.float32)
    params = jm.SEKernelParams.create(jnp.asarray(eps), 2.0, noise=0.05)
    for kernel in ("se", "matern52"):
        sj = jexact.fit(jnp.asarray(X), jnp.asarray(y), params, kernel=kernel)
        st = texact.fit(tt(X), tt(y), tt(eps), torch.tensor(0.05), kernel=kernel)
        mu_j, var_j = jexact.mean_var(sj, jnp.asarray(Xs))
        mu_t, var_t = texact.mean_var(st, tt(Xs))
        np.testing.assert_allclose(nn(mu_t), nn(mu_j), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(nn(var_t), nn(var_j), rtol=2e-3, atol=1e-5)
        nl_j = float(jexact.nlml(jnp.asarray(X), jnp.asarray(y), params, kernel=kernel))
        nl_t = float(texact.nlml(tt(X), tt(y), tt(eps), torch.tensor(0.05), kernel=kernel))
        assert abs(nl_t - nl_j) < 1e-2 * max(1.0, abs(nl_j))


def test_fagp_approaches_exact():
    X, y = gp_data(150, 1, 4)
    Xs = uniform(np.random.default_rng(5), (30, 1))
    _, ts = specs("hermite", 1, n=30, backend="pallas")
    mu_f, var_f = GP.fit(tt(X), tt(y), ts).mean_var(tt(Xs))
    st = texact.fit(tt(X), tt(y), ts.eps, ts.noise)
    mu_e, var_e = texact.mean_var(st, tt(Xs))
    np.testing.assert_allclose(nn(mu_f), nn(mu_e), atol=2e-3)
    np.testing.assert_allclose(nn(var_f), nn(var_e), atol=2e-3)


def test_gp_facade_session():
    X, y = gp_data(120, 2, 1)
    _, ts = specs("hermite", 2, n=5, backend="pallas")
    gp = GP.fit(tt(X), tt(y), ts)
    assert gp.n_features == 25 and gp.n_tasks == 1
    gp2 = gp.update(*map(tt, gp_data(3, 2, 2)))
    mu, var = gp2.mean_var(tt(X[:10]))
    assert mu.shape == (10,) and bool(torch.all(torch.isfinite(var)))
    assert np.isfinite(float(gp2.nlml(tt(X), tt(y))))
    jnp_gp = gp.with_spec(backend="jnp")
    np.testing.assert_allclose(nn(jnp_gp.mean_var(tt(X[:10]))[0]),
                               nn(gp.mean_var(tt(X[:10]))[0]), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="structural"):
        gp.with_spec(n=6)
    with pytest.raises(ValueError, match="hyperparameters"):
        gp.with_spec(noise=torch.tensor(0.1))


def test_unported_operations_name_their_slice():
    """GPBank.optimize is ported (ROADMAP A3) and so is its telemetry (obs,
    A4): a registry passed to it records the optimizer's progress series,
    as the JAX package's does."""
    from repro_torch.bank import GPBank
    from repro_torch.obs import MetricsRegistry

    X, y = gp_data(40, 2, 1)
    _, ts = specs("hermite", 2, n=4)
    bank = GPBank.fit(tt(X)[None], tt(y)[None], ts)
    reg = MetricsRegistry()
    bank.optimize(tt(X)[None], tt(y)[None], restarts=1, steps=3, metrics=reg)
    snap = reg.snapshot()
    assert snap["counters"]["hyperopt_rounds_total"] == 3
    assert set(snap["gauges"]) == {"hyperopt_step", "hyperopt_best_nlml"}


def test_pallas_refuses_deep_hermite():
    with pytest.raises(UnsupportedError) as e:
        tfagp.fit(torch.zeros(4, 1), torch.zeros(4),
                  GPSpec.create(65, [0.8], backend="pallas", device="cpu"))
    assert e.value.layer == "backend"


def test_default_device_raises_without_card():
    """Entry points default to the card and never carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.data import make_gp_dataset
    from repro_torch.launch.serve_gp import serve_gp

    with pytest.raises(RuntimeError, match="cuda"):
        GPSpec.create(4, [0.8])
    with pytest.raises(RuntimeError, match="cuda"):
        make_gp_dataset(10, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_gp(n_train=16, rounds=1, queries=4)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.spec_from_numpy(eps=[0.8], rho=[2.0], noise=0.1, n=3)
