"""Port parity: Mercer eigensystem, index sets, exact kernels and the
expansions' features, weights and spectral draws (repro_torch vs repro)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_common import nn, specs, tt, uniform  # noqa: E402

from repro.core import fagp as jfagp  # noqa: E402
from repro.core import mercer as jm  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import expansions as texp  # noqa: E402
from repro_torch.core import fagp as tfagp  # noqa: E402
from repro_torch.core import mercer as tm  # noqa: E402
from repro_torch.kernels import hermite_phi as thp  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

EXPANSIONS = ["hermite", "rff_se", "rff_matern52"]


def _hyp(p, seed):
    rng = np.random.default_rng(seed)
    eps = rng.uniform(0.3, 1.2, size=(p,)).astype(np.float32)
    rho = rng.uniform(1.5, 3.0, size=(p,)).astype(np.float32)
    return eps, rho


@pytest.mark.parametrize("kind", ["full", "total_degree", "hyperbolic_cross"])
@pytest.mark.parametrize("n,p", [(1, 1), (6, 1), (5, 2), (4, 3)])
def test_index_sets_identical(kind, n, p):
    np.testing.assert_array_equal(tm.make_index_set(kind, n, p),
                                  jm.make_index_set(kind, n, p))


@pytest.mark.parametrize("n,p", [(1, 1), (6, 1), (5, 2), (4, 3)])
def test_log_eigenvalues_match(n, p):
    eps, rho = _hyp(p, n + p)
    idx = jm.full_grid(n, p)
    params = jm.SEKernelParams.create(jnp.asarray(eps), jnp.asarray(rho))
    want = jm.log_eigenvalues_nd(jnp.asarray(idx), params)
    got = tm.log_eigenvalues_nd(tt(idx), tt(eps), tt(rho))
    # both are f32 log-space sums of the same closed form
    np.testing.assert_allclose(nn(got), nn(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        nn(tm.log_eigenvalues_1d(n, tt(eps[0]), tt(rho[0]))),
        nn(jm.log_eigenvalues_1d(n, jnp.asarray(eps[0]), jnp.asarray(rho[0]))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 6])
def test_eigenfunctions_match(n):
    rng = np.random.default_rng(n)
    x = uniform(rng, (64,), -2.0, 2.0)
    eps, rho = _hyp(1, n)
    want = jm.eigenfunctions_1d(jnp.asarray(x), n, jnp.asarray(eps[0]), jnp.asarray(rho[0]))
    got = tm.eigenfunctions_1d(tt(x), n, tt(eps[0]), tt(rho[0]))
    # tests/test_kernels.py:48 gate for two f32 recurrences: 4e-5 * max(4, n)
    np.testing.assert_allclose(nn(got), nn(want), rtol=4e-5 * max(4, n), atol=1e-5)


@pytest.mark.parametrize("N,p,n", [(50, 1, 6), (77, 2, 5), (40, 3, 4)])
def test_phi_nd_matches(N, p, n):
    rng = np.random.default_rng(N)
    X = uniform(rng, (N, p), -2.0, 2.0)
    eps, rho = _hyp(p, N)
    idx = jm.full_grid(n, p)
    params = jm.SEKernelParams.create(jnp.asarray(eps), jnp.asarray(rho))
    want = jm.phi_nd(jnp.asarray(X), jnp.asarray(idx), params, n)
    got = tm.phi_nd(tt(X), tt(idx), tt(eps), tt(rho), n)
    np.testing.assert_allclose(nn(got), nn(want), rtol=4e-5 * max(4, n), atol=1e-5)


@pytest.mark.parametrize("p", [1, 3])
def test_exact_kernels_match(p):
    rng = np.random.default_rng(p)
    Xa, Xb = uniform(rng, (20, p)), uniform(rng, (15, p))
    eps, _ = _hyp(p, p)
    for jk, tk in [(jm.k_se_ard, tm.k_se_ard), (jm.k_matern52_ard, tm.k_matern52_ard)]:
        want = jk(jnp.asarray(Xa), jnp.asarray(Xb), jnp.asarray(eps))
        got = tk(tt(Xa), tt(Xb), tt(eps))
        np.testing.assert_allclose(nn(got), nn(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kernel", ["se", "matern52"])
@pytest.mark.parametrize("seed", [0, 7])
def test_rff_omega_bit_identical(kernel, seed):
    js = jfagp.GPSpec.create_rff(jnp.full((3,), 0.8), kernel=kernel,
                                 num_features=64, seed=seed)
    ts = tfagp.GPSpec.create_rff(np.full((3,), 0.8, np.float32), kernel=kernel,
                                 num_features=64, seed=seed, device="cpu")
    np.testing.assert_array_equal(nn(ts.omega), np.asarray(js.omega))


@pytest.mark.parametrize("expansion", EXPANSIONS)
@pytest.mark.parametrize("p", [1, 2])
def test_expansion_features_and_weights_match(expansion, p):
    js, ts = specs(expansion, p, n=6, num_features=24)
    np.testing.assert_array_equal(ts.indices(), js.indices())
    X = uniform(np.random.default_rng(p), (90, p), -1.5, 1.5)
    want = jfagp.build_features(jnp.asarray(X), js)
    got = tfagp.build_features(tt(X), ts)
    np.testing.assert_allclose(nn(got), nn(want), rtol=4e-5 * 6, atol=1e-5)
    jw = jfagp.get_expansion(expansion).log_eigenvalues(jnp.asarray(js.indices()), js)
    tw = texp.get_expansion(expansion).log_eigenvalues(tt(ts.indices()), ts)
    np.testing.assert_allclose(nn(tw), nn(jw), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,p,n", [(37, 1, 6), (100, 2, 5), (64, 3, 4)])
def test_plain_tile_matches_both_oracles(N, p, n):
    """The port's gather-based tile == its one-hot oracle == JAX ref_phi."""
    rng = np.random.default_rng(N)
    X = uniform(rng, (N, p), -2.0, 2.0)
    eps, rho = _hyp(p, N)
    idx = jm.full_grid(n, p)
    consts = tref.phi_consts(tt(eps), tt(rho))
    got = thp.phi_tile(tt(X), consts, tt(idx), n)
    S = tref.one_hot_selection(idx, n)
    np.testing.assert_array_equal(S, jref.one_hot_selection(idx, n))
    oracle = tref.ref_phi(tt(X).T.contiguous(), consts, tt(S), n)
    jwant = jref.ref_phi(jnp.asarray(X).T, jref.phi_consts(jnp.asarray(eps), jnp.asarray(rho)),
                         jnp.asarray(S), n)
    np.testing.assert_allclose(nn(consts), np.asarray(jref.phi_consts(jnp.asarray(eps),
                                                                        jnp.asarray(rho))),
                               rtol=1e-6)
    tol = dict(rtol=4e-5 * max(4, n), atol=1e-5)
    np.testing.assert_allclose(nn(got), nn(oracle), **tol)
    np.testing.assert_allclose(nn(got), nn(jwant), **tol)


def test_hermite_coefficients_are_the_recurrence_constants():
    c = tm.hermite_coefficients(8)
    for i in range(2, 8):
        assert c[0, i] == np.float32(np.sqrt(2.0 / i))
        assert c[1, i] == np.float32(np.sqrt((i - 1.0) / i))
    assert c[0, 1] == np.float32(np.sqrt(2.0))
