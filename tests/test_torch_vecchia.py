"""The port's Vecchia family (``repro_torch/core/vecchia.py``) against the
JAX package's (``repro/core/vecchia.py``) and against the port's exact GP,
on the CPU, at the sizes of tests/test_vecchia.py.

The same numpy inputs go to both packages.  Gates are the JAX package's:
predictions 1e-4 (tests/test_vecchia.py:144-156, the agreement with the
exact GP and across implementations of the same conditioning), the ordered
NLML 1e-3 of max(1, |nlml|) (:160-167).  Predictions are held against the
JAX package's on the queries whose k nearest training rows are the same
set in both packages: q^2 + t^2 - 2 q.t rounds differently in each, so a
near-tie at the k-th neighbour may resolve either way
(tests/test_torch_knn.py), and then the two condition on different data.
Session claims mirror that file:
convergence to the exact GP as k -> N for both kernels, the clustered
regime, update as an exact concatenation, multi-output, checkpoints
bitwise (and across the packages both ways), the structured refusals and
spec validation.  The memory claim is pinned with the dispatch-mode sweep
of tests/test_torch_knn.py: no operator of ``mean_var`` or ``nlml``
outputs a tensor with two data-sized axes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_common import gp_data, nn, tt  # noqa: E402
from test_torch_knn import LIMIT, big_intermediate  # noqa: E402

from repro.core import vecchia as jvecchia  # noqa: E402
from repro.core.gp import GP as JGP  # noqa: E402
from repro.core.gp import GPSpec as JSpec  # noqa: E402
from repro_torch.bank import GPBank  # noqa: E402
from repro_torch.core import exact_gp, fagp, vecchia  # noqa: E402
from repro_torch.core.approximation import (  # noqa: E402
    UnsupportedError,
    available_approximations,
    get_approximation,
)
from repro_torch.core.gp import GP, GPSpec  # noqa: E402
from repro_torch.data import make_clustered_dataset  # noqa: E402

PRED = 1e-4                                  # tests/test_vecchia.py:148-156


def _nlml_tol(want):
    # tests/test_vecchia.py:167
    return 1e-3 * max(1.0, abs(want))


def _points(N, p=2, seed=0, lo=-2.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, (N, p)).astype(np.float32)


def _problem(N=160, p=2, k=16, kernel="se", seed=0, noise=0.05):
    """tests/test_vecchia.py:_vecchia_problem as numpy (make_gp_dataset's
    draws), with the spec in both packages: (X, y, Xs, ys, jspec, spec)."""
    rng = np.random.default_rng(seed)
    n_test = max(1, int(N * 0.1))
    X_all = rng.uniform(-1.0, 1.0, size=(N + n_test, p)).astype(np.float32)
    y_all = (np.sum(np.cos(X_all), axis=1)
             + 0.05 * rng.standard_normal(N + n_test)).astype(np.float32)
    js = JSpec.create_vecchia([0.8] * p, noise, kernel=kernel, neighbors=k)
    ts = GPSpec.create_vecchia([0.8] * p, noise, kernel=kernel, neighbors=k, device="cpu")
    return X_all[:N], y_all[:N], X_all[N:], y_all[N:], js, ts


def _same_sets(Xs, X, k):
    """(Q,) bool: the queries whose k nearest rows of X are one set in
    both packages' k-NN search (at least 95% of them, or the test fails)."""
    from repro.kernels import knn as jknn
    from repro_torch.kernels import knn

    _, i = knn.knn_search(tt(Xs), tt(X), k)
    _, ji = jknn.knn_search(jnp.asarray(Xs), jnp.asarray(X), k)
    same = np.array([set(a) == set(b) for a, b in zip(nn(i), np.asarray(ji))])
    assert same.mean() >= 0.95, f"{(~same).sum()} of {same.size} sets differ"
    return same


def _close_on(rows, got, want):
    """``got`` (the port's) against ``want`` (JAX's) at the prediction gate
    on ``rows``."""
    np.testing.assert_allclose(nn(got)[rows], nn(want)[rows], atol=PRED)


def _exact(X, y, Xs, spec):
    st = exact_gp.fit(tt(X), tt(y), spec.eps, spec.noise, spec.kernel)
    return exact_gp.mean_var(st, tt(Xs))


# ---------------------------------------------------------------------------
# Convergence to the exact GP, and agreement with the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["se", "matern52"])
def test_full_conditioning_matches_exact_and_jax(kernel):
    """At k = N every query conditions on the whole training set: the
    prediction is the port's exact GP's, and the JAX package's Vecchia
    prediction, at 1e-4 (noise 0.1 keeps the float32 Cholesky well
    conditioned, as tests/test_vecchia.py:144-156 does)."""
    X, y, Xs, _, js, ts = _problem(N=160, k=160, kernel=kernel, noise=0.1)
    mu, var = GP.fit(tt(X), tt(y), ts).mean_var(tt(Xs))
    mu_e, var_e = _exact(X, y, Xs, ts)
    jmu, jvar = JGP.fit(jnp.asarray(X), jnp.asarray(y), js).mean_var(jnp.asarray(Xs))
    for got, want in ((mu, mu_e), (var, var_e), (mu, jmu), (var, jvar)):
        np.testing.assert_allclose(nn(got), nn(want), atol=PRED)


@pytest.mark.parametrize("kernel", ["se", "matern52"])
def test_nlml_telescopes_to_exact_and_matches_jax(kernel):
    """At k >= N - 1 the ordered conditionals multiply back to the exact
    joint (tests/test_vecchia.py:158-167), and the port's ordered NLML is
    the JAX package's, at 1e-3 of max(1, |nlml|)."""
    X, y, _, _, js, ts = _problem(N=120, k=119, kernel=kernel)
    v = float(GP.fit(tt(X), tt(y), ts).nlml(tt(X), tt(y)))
    e = float(exact_gp.nlml(tt(X), tt(y), ts.eps, ts.noise, kernel))
    jv = float(JGP.fit(jnp.asarray(X), jnp.asarray(y), js).nlml(jnp.asarray(X), jnp.asarray(y)))
    assert abs(v - e) <= _nlml_tol(e), (v, e)
    assert abs(v - jv) <= _nlml_tol(jv), (v, jv)


def test_prediction_error_decreases_in_k():
    """tests/test_vecchia.py:169-180: |mu_k - mu_exact| is (weakly)
    decreasing along a k ladder, and each rung is the JAX package's."""
    X, y, Xs, _, js, ts = _problem(N=200, k=4, noise=0.1)
    mu_e, _ = _exact(X, y, Xs, ts)
    errs = []
    for k in (4, 16, 64, 200):
        mu, _ = GP.fit(tt(X), tt(y), ts.replace(neighbors=k)).mean_var(tt(Xs))
        jmu, _ = JGP.fit(jnp.asarray(X), jnp.asarray(y), js.replace(neighbors=k)).mean_var(
            jnp.asarray(Xs))
        _close_on(_same_sets(Xs, X, k), mu, jmu)
        errs.append(float(torch.max(torch.abs(mu - mu_e))))
    assert errs[-1] <= 1e-4
    assert all(b <= a + 1e-6 for a, b in zip(errs, errs[1:])), errs


def test_nlml_partial_conditioning_is_finite_and_ordered():
    """tests/test_vecchia.py:182-193: the small-k NLML is finite, moving k
    toward N moves it toward the exact value, and each is the JAX
    package's."""
    X, y, _, _, js, ts = _problem(N=150, k=4)
    e = float(exact_gp.nlml(tt(X), tt(y), ts.eps, ts.noise, "se"))
    gaps = []
    for k in (4, 32, 149):
        v = float(GP.fit(tt(X), tt(y), ts.replace(neighbors=k)).nlml(tt(X), tt(y)))
        jv = float(JGP.fit(jnp.asarray(X), jnp.asarray(y), js.replace(neighbors=k)).nlml(
            jnp.asarray(X), jnp.asarray(y)))
        assert np.isfinite(v) and abs(v - jv) <= _nlml_tol(jv), (k, v, jv)
        gaps.append(abs(v - e))
    assert gaps[2] <= gaps[0]


# ---------------------------------------------------------------------------
# The clustered-spatial regime
# ---------------------------------------------------------------------------


def test_clustered_beats_every_global_expansion():
    """tests/test_vecchia.py:206-233 on the port: on clustered data with a
    short length scale (N = 1,500) Vecchia (k = 32) beats the Hermite
    (n = 12) and both RFF (R = 256) expansions at matched hyperparameters,
    and its predictions are the JAX package's at 1e-4."""
    kw = dict(extent=6.0, length_scale=0.15, noise=0.02, n_bumps=120, seed=0)
    X, y, Xs, ys = make_clustered_dataset(1500, device="cpu", **kw)
    eps = [4.714, 4.714]

    def rmse(mu):
        return float(torch.sqrt(torch.mean((mu - ys) ** 2)))

    mu = GP.fit(X, y, GPSpec.create_vecchia(eps, 0.02, neighbors=32, device="cpu")
                ).mean_var(Xs)[0]
    r_v = rmse(mu)
    jmu, _ = JGP.fit(jnp.asarray(nn(X)), jnp.asarray(nn(y)),
                     JSpec.create_vecchia(eps, 0.02, neighbors=32)).mean_var(jnp.asarray(nn(Xs)))
    _close_on(_same_sets(nn(Xs), nn(X), 32), mu, jmu)
    globals_ = {
        "hermite": GPSpec.create(12, eps, noise=0.02, device="cpu"),
        "rff_se": GPSpec.create_rff(eps, noise=0.02, num_features=256, seed=0, device="cpu"),
        "rff_matern52": GPSpec.create_rff(eps, noise=0.02, kernel="matern52",
                                          num_features=256, seed=0, device="cpu"),
    }
    for name, spec in globals_.items():
        r_g = rmse(GP.fit(X, y, spec).mean_var(Xs)[0])
        assert r_v < r_g, f"vecchia {r_v:.4f} !< {name} {r_g:.4f}"


# ---------------------------------------------------------------------------
# The approximation protocol
# ---------------------------------------------------------------------------


def test_both_families_registered():
    assert available_approximations() == ["fagp", "vecchia"]
    assert get_approximation("vecchia") is vecchia.VECCHIA
    assert get_approximation("vecchia").capabilities == jvecchia.VECCHIA.capabilities
    assert get_approximation("fagp").capabilities >= {
        "fit", "predict", "mean_var", "update", "nlml", "optimize", "bank"}


def test_refusals_are_structured():
    """tests/test_vecchia.py:260-275 and :297-316: predict, optimize,
    n_features, nlml(mask=), the fagp entry points and bank admission are
    refused with the structured error."""
    X, y, Xs, _, _, ts = _problem(N=60, k=8)
    g = GP.fit(tt(X), tt(y), ts)
    with pytest.raises(UnsupportedError, match="does not support") as ei:
        g.predict(tt(Xs))
    assert (ei.value.layer, ei.value.capability) == ("approximation", "predict")
    assert ei.value.spec is ts
    with pytest.raises(UnsupportedError, match="does not support") as ei:
        GP.optimize(tt(X), tt(y), ts)
    assert ei.value.capability == "optimize"
    with pytest.raises(UnsupportedError, match="n_features"):
        g.n_features
    with pytest.raises(UnsupportedError, match="does not support") as ei:
        vecchia.VECCHIA.nlml(tt(X), tt(y), ts, mask=torch.ones(60))
    assert ei.value.capability == "nlml_mask"
    with pytest.raises(UnsupportedError, match="does not support") as ei:
        fagp.fit(tt(X), tt(y), ts)
    assert (ei.value.layer, ei.value.capability) == ("approximation", "fagp")
    with pytest.raises(UnsupportedError, match="does not support"):
        GPBank.create(ts, capacity=4)
    with pytest.raises(UnsupportedError, match="does not support"):
        GPBank.fit(tt(X[None]), tt(y[None]), ts)
    with pytest.raises(UnsupportedError, match="does not support 'bank'"):
        GPBank.from_states({0: g})
    fbank = GPBank.fit(tt(X[None]), tt(y[None]), GPSpec.create(4, [0.8, 0.8], device="cpu"),
                       capacity=2)
    with pytest.raises(UnsupportedError, match="does not support 'bank'"):
        fbank.insert(1, g)


def test_spec_validation():
    with pytest.raises(ValueError, match="kernel must be one of"):
        GPSpec.create_vecchia([0.8], 0.05, kernel="rbf", device="cpu")
    with pytest.raises(ValueError, match="neighbors >= 1"):
        GPSpec.create_vecchia([0.8], 0.05, neighbors=0, device="cpu")
    with pytest.raises(ValueError, match="unknown approximation"):
        GPSpec.create(6, eps=[0.8], approximation="svgp", device="cpu")
    with pytest.raises(ValueError, match="vecchia-only"):
        GPSpec.create(6, eps=[0.8], neighbors=8, device="cpu")
    with pytest.raises(ValueError, match="no spectral draws"):
        GPSpec.create(1, eps=[0.8], approximation="vecchia", kernel="se", neighbors=4,
                      expansion="rff_se", num_features=8, device="cpu")


def test_fit_input_validation():
    X, y, _, _, _, ts = _problem(N=40, k=8)
    with pytest.raises(ValueError, match="p="):
        GP.fit(tt(np.concatenate([X, X[:, :1]], axis=1)), tt(y), ts)
    with pytest.raises(ValueError, match="exceeds"):
        GP.fit(tt(X[:4]), tt(y[:4]), ts)


def test_describe_names_the_family():
    ts = _problem(k=24, kernel="matern52")[-1]
    d = ts.describe()
    assert "vecchia" in d and "matern52" in d and "24" in d


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------


def test_update_equals_refit_exactly():
    """tests/test_vecchia.py:342-353: the updated session is bit-identical
    to a refit on the union, and serves the JAX package's update at 1e-4."""
    X, y, _, _, js, ts = _problem(N=80, k=12)
    Xn, yn = gp_data(20, 2, 7)
    Xs = _points(25, seed=8)
    up = GP.fit(tt(X), tt(y), ts).update(tt(Xn), tt(yn))
    re = GP.fit(tt(np.concatenate([X, Xn])), tt(np.concatenate([y, yn])), ts)
    assert up.state.n_train == 100
    for a, b in zip(up.mean_var(tt(Xs)), re.mean_var(tt(Xs))):
        assert torch.equal(a, b)
    jup = JGP.fit(jnp.asarray(X), jnp.asarray(y), js).update(jnp.asarray(Xn), jnp.asarray(yn))
    same = _same_sets(Xs, np.concatenate([X, Xn]), 12)
    for a, b in zip(up.mean_var(tt(Xs)), jup.mean_var(jnp.asarray(Xs))):
        _close_on(same, a, b)


def test_update_task_mismatch_raises():
    X, y, _, _, _, ts = _problem(N=40, k=8)
    g = GP.fit(tt(X), tt(np.stack([y, -y], axis=1)), ts)
    with pytest.raises(ValueError, match="task"):
        g.update(tt(X[:4]), tt(y[:4]))


def test_multioutput_matches_per_task_and_jax():
    """tests/test_vecchia.py:362-375, and the JAX package's multi-output
    session at 1e-4."""
    X, y, Xs, _, js, ts = _problem(N=90, k=10)
    Y = np.stack([y, 2.0 * y, y - 0.5], axis=1)
    g = GP.fit(tt(X), tt(Y), ts)
    assert g.n_tasks == 3
    mu, var = g.mean_var(tt(Xs))
    assert mu.shape == (Xs.shape[0], 3) and var.shape == (Xs.shape[0],)
    for t in range(3):
        mu_t, var_t = GP.fit(tt(X), tt(Y[:, t]), ts).mean_var(tt(Xs))
        np.testing.assert_allclose(nn(mu[:, t]), nn(mu_t), atol=1e-4)
        np.testing.assert_allclose(nn(var), nn(var_t), atol=1e-6)
    jmu, jvar = JGP.fit(jnp.asarray(X), jnp.asarray(Y), js).mean_var(jnp.asarray(Xs))
    same = _same_sets(Xs, X, 10)
    _close_on(same, mu, jmu)
    _close_on(same, var, jvar)


def _same(a, b) -> bool:
    a, b = nn(a), nn(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_checkpoint_roundtrip_bit_exact(tmp_path):
    X, y, Xs, _, _, ts = _problem(N=70, k=9, kernel="matern52")
    g = GP.fit(tt(X), tt(y), ts)
    g.save(tmp_path)
    re = GP.load(tmp_path, device="cpu")
    assert isinstance(re.state, vecchia.VecchiaState)
    assert re.spec.approximation == "vecchia"
    assert re.spec.kernel == "matern52" and re.spec.neighbors == 9
    assert _same(re.state.X, g.state.X) and _same(re.state.y, g.state.y)
    assert torch.equal(re.mean_var(tt(Xs))[0], g.mean_var(tt(Xs))[0])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_cross_load_bitwise(tmp_path, direction):
    """A session saved by either package loads in the other with its
    leaves (X, y), hyperparameters and structure bitwise, and serves the
    same predictions at 1e-4."""
    X, y, Xs, _, js, ts = _problem(N=70, k=9, kernel="matern52")
    Y = np.stack([y, y - 1.0], axis=1)
    if direction == "jax_to_port":
        src = JGP.fit(jnp.asarray(X), jnp.asarray(Y), js)
        src.save(tmp_path)
        dst = GP.load(tmp_path, device="cpu")
        got, want = dst.mean_var(tt(Xs)), src.mean_var(jnp.asarray(Xs))
    else:
        src = GP.fit(tt(X), tt(Y), ts)
        src.save(tmp_path)
        dst = JGP.load(tmp_path)
        got, want = dst.mean_var(jnp.asarray(Xs)), src.mean_var(tt(Xs))
    for f in ("X", "y"):
        assert _same(getattr(dst.state, f), getattr(src.state, f)), f
    for f in ("eps", "rho", "noise"):
        assert _same(getattr(dst.spec, f), getattr(src.spec, f)), f
    for f in ("approximation", "kernel", "neighbors", "block_rows", "backend", "omega"):
        assert getattr(dst.spec, f) == getattr(src.spec, f), f
    same = _same_sets(Xs, X, 9)
    for a, b in zip(got, want):
        _close_on(same, a, b)


def test_load_with_mismatched_spec_raises(tmp_path):
    X, y, _, _, _, ts = _problem(N=50, k=6)
    GP.fit(tt(X), tt(y), ts).save(tmp_path)
    with pytest.raises(ValueError, match="mismatch"):
        GP.load(tmp_path, spec=ts.replace(neighbors=12))
    assert GP.load(tmp_path, spec=ts).spec.neighbors == 6


def test_with_spec_swaps_knobs_rejects_structure():
    X, y, _, _, _, ts = _problem(N=50, k=6)
    g = GP.fit(tt(X), tt(y), ts)
    assert g.with_spec(block_rows=64).spec.block_rows == 64
    with pytest.raises(ValueError, match="mismatch"):
        g.with_spec(neighbors=12)
    with pytest.raises(ValueError, match="mismatch"):
        g.with_spec(kernel="matern52")
    with pytest.raises(ValueError, match="mismatch"):
        g.with_spec(noise=torch.tensor(0.5))


def test_session_matches_jax():
    """The slice as a whole: fit, mean_var, update, nlml and a save/load
    through the port against the same JAX session, on clustered data with
    the JAX benchmark's width (k = 32, se, eps = 4.714, noise 0.02) cut to
    N = 1,000: predictions at 1e-4, the NLML at 1e-3 of max(1, |nlml|)."""
    kw = dict(extent=6.0, length_scale=0.15, noise=0.02, n_bumps=120, seed=1)
    X, y, Xs, _ = (nn(a) for a in make_clustered_dataset(1000, device="cpu", **kw))
    Xn, yn = X[:64] + 0.01, y[:64]
    ts = GPSpec.create_vecchia([4.714, 4.714], 0.02, neighbors=32, block_rows=256,
                               device="cpu")
    js = JSpec.create_vecchia([4.714, 4.714], 0.02, neighbors=32, block_rows=256)
    g = GP.fit(tt(X), tt(y), ts)
    jg = JGP.fit(jnp.asarray(X), jnp.asarray(y), js)
    Xa, ya = np.concatenate([X, Xn]), np.concatenate([y, yn])
    for same, session in ((_same_sets(Xs, X, 32), (g, jg)),
                          (_same_sets(Xs, Xa, 32), (g.update(tt(Xn), tt(yn)),
                                                    jg.update(jnp.asarray(Xn), jnp.asarray(yn))))):
        g, jg = session
        for a, b in zip(g.mean_var(tt(Xs)), jg.mean_var(jnp.asarray(Xs))):
            _close_on(same, a, b)
    v, jv = float(g.nlml(tt(Xa), tt(ya))), float(jg.nlml(jnp.asarray(Xa), jnp.asarray(ya)))
    assert np.isfinite(v) and abs(v - jv) <= _nlml_tol(jv), (v, jv)


# ---------------------------------------------------------------------------
# Memory: no dense intermediate
# ---------------------------------------------------------------------------

N_SWEEP, Q_SWEEP, K_SWEEP = 600, 400, 8          # tests/test_vecchia.py:114


def _sweep_spec():
    return GPSpec.create_vecchia([0.8, 0.8], 0.05, neighbors=K_SWEEP, block_rows=128,
                                 device="cpu")


def test_mean_var_streams():
    g = GP.fit(tt(_points(N_SWEEP, seed=2)), torch.ones(N_SWEEP), _sweep_spec())
    hit = big_intermediate(g.mean_var, tt(_points(Q_SWEEP, seed=3)))
    assert hit is None, hit


def test_nlml_streams():
    X, y = tt(_points(N_SWEEP, seed=4)), torch.ones(N_SWEEP)
    hit = big_intermediate(lambda a, b: GP.fit(a, b, _sweep_spec()).nlml(a, b), X, y)
    assert hit is None, hit


def test_sweep_catches_a_dense_conditioning():
    """The recorder itself: conditioning every query on the whole training
    set through the exact GP forms a Q x N (and N x N) tensor and trips it."""
    X, Xs = tt(_points(N_SWEEP, seed=2)), tt(_points(Q_SWEEP, seed=3))
    ts = _sweep_spec()
    hit = big_intermediate(
        lambda a, b: exact_gp.mean_var(exact_gp.fit(a, torch.ones(N_SWEEP), ts.eps,
                                                    ts.noise), b), X, Xs)
    assert hit is not None and min(hit[0][:2]) >= LIMIT
