"""Port parity for the stored-features pipeline: ``store_train`` fits on
both backends (Phi and y as the JAX package stores them), ``fit_update``
appending to them, ``with_spec``'s refusal to turn them on, the literal
Eqs. 11-12 chain (``predict(mode="paper")``) against the JAX package's and
against the fused mode, its refusal without stored features, the bank's
normalization of ``store_train``, and carrying a stored state across."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_common import gp_data, nn, specs, tt, uniform  # noqa: E402

from repro.core import fagp as jfagp  # noqa: E402
from repro.core.gp import GP as JGP  # noqa: E402
from repro_torch.bank import GPBank  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import fagp as tfagp  # noqa: E402
from repro_torch.core.gp import GP  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# the JAX tests hold paper mode at N = 50 (tests/test_fagp.py:49-60,
# tests/test_gp_api.py:402-410): the N x N float32 inverse of the chain
# cancels as N grows (ROADMAP.md section C)
PAPER_N = 50


def _stored(expansion, backend, *, N=120, p=2, n=6, R=16, seed=1, T=None):
    X, y = gp_data(N, p, seed)
    if T is not None:
        y = np.stack([y * (t + 1) - t for t in range(T)], axis=1).astype(np.float32)
    js, ts = specs(expansion, p, n=n, num_features=R, backend=backend, block_rows=64)
    js, ts = js.replace(store_train=True), ts.replace(store_train=True)
    st_j = jfagp.fit(jnp.asarray(X), jnp.asarray(y), js)
    st_t = tfagp.fit(tt(X), tt(y), ts)
    return X, y, st_j, st_t


@pytest.mark.parametrize("expansion", ["hermite", "rff_se"])
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_store_train_fit_stores_what_jax_stores(expansion, backend):
    """jnp stores the plain feature map, pallas one features-kernel pass
    (its plain version here, the JAX kernel in interpret mode there)."""
    ops.reset_launch_counts()
    X, y, st_j, st_t = _stored(expansion, backend)
    assert ops.launch_counts()["scaled_gram"] == {}  # the fit never materializes B from Phi
    assert st_t.Phi.shape == (X.shape[0], st_t.n_features) == tuple(st_j.Phi.shape)
    np.testing.assert_allclose(nn(st_t.Phi), nn(st_j.Phi), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(nn(st_t.y), y)
    np.testing.assert_array_equal(nn(st_t.y), nn(st_j.y))
    # the stored features are the ones the factorization was built from
    np.testing.assert_allclose(nn(st_t.Phi.T @ st_t.y), nn(st_t.b), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_store_train_leaves_the_fit_unchanged(backend):
    X, y = gp_data(90, 2, 4)
    _, ts = specs("hermite", 2, n=5, backend=backend)
    plain = tfagp.fit(tt(X), tt(y), ts)
    stored = tfagp.fit(tt(X), tt(y), ts.replace(store_train=True))
    assert plain.Phi is None and plain.y is None
    for f in ("chol", "u", "b"):
        assert torch.equal(getattr(plain, f), getattr(stored, f))


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_fit_update_appends_stored_data(backend):
    X, y, st_j, st_t = _stored("hermite", backend, N=80)
    Xn, yn = gp_data(5, 2, 7)
    up_j = jfagp.fit_update(st_j, jnp.asarray(Xn), jnp.asarray(yn))
    up_t = tfagp.fit_update(st_t, tt(Xn), tt(yn))
    assert up_t.Phi.shape == (85, up_t.n_features)
    np.testing.assert_allclose(nn(up_t.Phi), nn(up_j.Phi), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(nn(up_t.y), np.concatenate([y, yn]))
    assert torch.equal(up_t.Phi[:80], st_t.Phi) and st_t.Phi.shape[0] == 80


def test_with_spec_cannot_enable_store_train():
    X, y = gp_data(40, 2, 1)
    _, ts = specs("hermite", 2, n=4)
    st = tfagp.fit(tt(X), tt(y), ts)
    with pytest.raises(ValueError, match="cannot enable store_train"):
        st.with_spec(store_train=True)
    stored = tfagp.fit(tt(X), tt(y), ts.replace(store_train=True))
    off = stored.with_spec(store_train=False)   # turning it off is a knob
    assert not off.spec.store_train and off.Phi is stored.Phi
    assert "store_train=True" in stored.spec.describe()


def _paper_chains64(st_j, Xs):
    """The JAX package's paper chain (``fagp._predict_paper``) and the
    port's (``fagp._paper_chain``) in float64 on the same inputs: the JAX
    state's stored Phi and y, its eigenvalues, the query features of its
    spec in float64, and B rebuilt and factored in float64."""
    with jax.enable_x64(True):
        f64 = lambda a: jnp.asarray(np.asarray(a, np.float64))  # noqa: E731
        js = st_j.spec
        js64 = dataclasses.replace(js, eps=f64(js.eps), rho=f64(js.rho), noise=f64(js.noise))
        Phi, D = np.asarray(st_j.Phi, np.float64), np.asarray(st_j.sqrtlam, np.float64)
        sig2 = float(np.asarray(js.noise, np.float64)) ** 2
        chol = np.linalg.cholesky(np.eye(Phi.shape[1]) + D[:, None] * (Phi.T @ Phi) * D[None, :] / sig2)
        st64 = dataclasses.replace(
            st_j, Phi=f64(Phi), y=f64(st_j.y), lam=f64(st_j.lam), sqrtlam=f64(D),
            chol=f64(chol), params=js64.params, spec=js64)
        Phis = jfagp._features(f64(Xs), st64.idx, js64)
        mu_j, cov_j = jfagp._predict_paper(st64, f64(Xs))
        assert mu_j.dtype == cov_j.dtype == jnp.float64
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
        mu_t, cov_t = tfagp._paper_chain(t(Phi), t(st_j.y), t(Phis), t(st_j.lam), t(D), t(chol),
                                         sig2)
        return (np.asarray(mu_j), np.asarray(cov_j)), (nn(mu_t), nn(cov_t))


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("T", [None, 2])
def test_paper_mode_matches_jax_and_fused_mode(backend, T):
    """What tests/test_fagp.py:57-59 gates, held in the port: its paper
    mode against its fused mode (atol 5e-3).  Across the packages, the
    fused modes at the serving gate (rtol 1e-5, atol 1e-5), and the two paper chains
    in float64 on the same inputs.  The two float32 chains are not held
    against each other: each cancels in its own way (on some CPUs 7e-3
    apart at N = 50), which no JAX gate covers."""
    X, y, st_j, st_t = _stored("hermite", backend, N=PAPER_N, n=8, T=T)
    Xs = uniform(np.random.default_rng(3), (17, 2))
    mu_jp, cov_jp = jfagp.predict(st_j, jnp.asarray(Xs), mode="paper")
    mu_jf, cov_jf = jfagp.predict(st_j, jnp.asarray(Xs), mode="fused")
    mu_p, cov_p = tfagp.predict(st_t, tt(Xs), mode="paper")
    mu_f, cov_f = tfagp.predict(st_t, tt(Xs), mode="fused")
    assert mu_p.shape == ((17,) if T is None else (17, T)) and cov_p.shape == (17, 17)
    # tests/test_fagp.py:57-59 gate
    for got, want in ((mu_p, mu_f), (cov_p, cov_f)):
        np.testing.assert_allclose(nn(got), nn(want), atol=5e-3)
    for got, want in ((mu_f, mu_jf), (cov_f, cov_jf)):
        np.testing.assert_allclose(nn(got), nn(want), rtol=1e-5, atol=1e-5)
    (mu_j64, cov_j64), (mu_t64, cov_t64) = _paper_chains64(st_j, Xs)
    np.testing.assert_allclose(mu_t64, mu_j64, atol=1e-9)
    np.testing.assert_allclose(cov_t64, cov_j64, atol=1e-9)
    gap = lambda a, b: float(np.abs(nn(a) - nn(b)).max())  # noqa: E731
    print(f"paper chains: float32 port from JAX {gap(mu_p, mu_jp):.1e} (mean), "
          f"{gap(cov_p, cov_jp):.1e} (cov); float64 {gap(mu_t64, mu_j64):.1e}, "
          f"{gap(cov_t64, cov_j64):.1e}; float32 from float64: port {gap(mu_p, mu_t64):.1e}, "
          f"JAX {gap(mu_jp, mu_j64):.1e} (mean); fused port from JAX {gap(mu_f, mu_jf):.1e}, "
          f"{gap(cov_f, cov_jf):.1e}")


def test_paper_chain_in_float64_matches_the_fused_mode_beyond_the_jax_size():
    """At N = 2,000 the float32 chain is 0.10 from the fused mode in the
    JAX package too (ROADMAP.md section C).  The port's chain run in
    float64 (stored Phi and y cast up, B rebuilt and factored in float64)
    lands on the fused mode, so the gap is the float32 cancellation and
    not the chain's order of operations."""
    X, y = gp_data(2000, 2, 0)
    _, ts = specs("hermite", 2, n=8)
    st = tfagp.fit(tt(X), tt(y), ts.replace(store_train=True))
    Xs = uniform(np.random.default_rng(3), (64, 2))
    f64 = torch.float64
    Phi, yy, D = st.Phi.to(f64), st.y.to(f64), st.sqrtlam.to(f64)
    Phis = tfagp.build_features(tt(Xs), st.spec, st.idx).to(f64)
    sig2 = float(st.spec.noise) ** 2
    M = Phi.shape[1]
    chol = torch.linalg.cholesky(torch.eye(M, dtype=f64)
                                 + D[:, None] * (Phi.T @ Phi) * D[None, :] / sig2)
    mu_p, cov_p = tfagp._paper_chain(Phi, yy, Phis, D * D, D, chol, sig2)
    u = tfagp._solve_mean_weights(chol, D, Phi.T @ yy, sig2)
    V = torch.linalg.solve_triangular(chol, (Phis * D[None, :]).T, upper=False)
    # tests/test_fagp.py:57-59 gate
    np.testing.assert_allclose(nn(mu_p), nn(Phis @ u), atol=5e-3)
    np.testing.assert_allclose(nn(cov_p), nn(V.T @ V), atol=5e-3)


def test_paper_mode_through_the_facade():
    X, y = gp_data(PAPER_N, 2, 2)
    js, ts = specs("rff_se", 2, num_features=16, backend="pallas")
    Xs = uniform(np.random.default_rng(5), (9, 2))
    jg = JGP.fit(jnp.asarray(X), jnp.asarray(y), js.replace(store_train=True))
    gp = GP.fit(tt(X), tt(y), ts.replace(store_train=True))
    for got, want in zip(gp.predict(tt(Xs), mode="paper"),
                         jg.predict(jnp.asarray(Xs), mode="paper")):
        np.testing.assert_allclose(nn(got), nn(want), atol=5e-3)
    with pytest.raises(ValueError, match="unknown mode"):
        gp.predict(tt(Xs), mode="literal")


def test_paper_mode_refusal_names_the_fitted_spec():
    """Worded like the JAX package's (tests/test_gp_api.py:390-400): it
    names the state's GPSpec and store_train=True, never FAGPConfig."""
    X, y = gp_data(40, 2, 1)
    _, ts = specs("hermite", 2, n=4)
    for call in (lambda: tfagp.predict(tfagp.fit(tt(X), tt(y), ts), tt(X[:3]), mode="paper"),
                 lambda: GP.fit(tt(X), tt(y), ts).predict(tt(X[:3]), mode="paper")):
        with pytest.raises(ValueError) as e:
            call()
        msg = str(e.value)
        assert "store_train=True" in msg and "GPSpec" in msg
        assert "FAGPConfig" not in msg


def test_bank_never_stores_features():
    """A bank built from a store_train spec drops it (JAX bank._bank_spec):
    its tenants' states claim no stored features."""
    rng = np.random.default_rng(0)
    Xb = uniform(rng, (3, 30, 2))
    yb = np.cos(Xb).sum(-1).astype(np.float32)
    _, ts = specs("hermite", 2, n=4, backend="pallas")
    stored = ts.replace(store_train=True)
    bank = GPBank.fit(tt(Xb), tt(yb), stored)
    assert not bank.spec.store_train and bank.state(1).Phi is None
    assert not GPBank.create(stored, 2).spec.store_train
    st = tfagp.fit(tt(Xb[0]), tt(yb[0]), stored)
    fb = GPBank.from_states({"a": st})
    assert not fb.spec.store_train and fb.state("a").Phi is None
    np.testing.assert_allclose(nn(fb.mean_var(["a"] * 4, tt(Xb[0, :4]))[0]),
                               nn(tfagp.predict_mean_var(st, tt(Xb[0, :4]))[0]),
                               rtol=0, atol=1e-5)


def test_stored_state_carried_across_from_jax():
    X, y, st_j, _ = _stored("hermite", "jnp", N=PAPER_N, n=8)
    js = st_j.spec
    st_t = convert.state_from_numpy(
        idx=np.asarray(st_j.idx), lam=np.asarray(st_j.lam),
        sqrtlam=np.asarray(st_j.sqrtlam), chol=np.asarray(st_j.chol),
        u=np.asarray(st_j.u), b=np.asarray(st_j.b), Phi=np.asarray(st_j.Phi),
        y=np.asarray(st_j.y), eps=np.asarray(js.eps), rho=np.asarray(js.rho),
        noise=np.asarray(js.noise), n=js.n, store_train=True, device="cpu")
    assert st_t.spec.store_train
    Xs = uniform(np.random.default_rng(4), (11, 2))
    for got, want in zip(tfagp.predict(st_t, tt(Xs), mode="paper"),
                         jfagp.predict(st_j, jnp.asarray(Xs), mode="paper")):
        np.testing.assert_allclose(nn(got), nn(want), atol=5e-3)
    with pytest.raises(ValueError, match="both Phi and y"):
        convert.state_from_numpy(
            idx=np.asarray(st_j.idx), lam=np.asarray(st_j.lam),
            sqrtlam=np.asarray(st_j.sqrtlam), chol=np.asarray(st_j.chol),
            u=np.asarray(st_j.u), b=np.asarray(st_j.b), Phi=np.asarray(st_j.Phi),
            spec=st_t.spec)
