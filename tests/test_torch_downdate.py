"""Port parity for the bank's sliding-window forgetting (ROADMAP A2):
``GPBank.downdate`` (the hyperbolic rank-k downdate sweep, with its
lost-pivot contract) and ``GPBank.refit_window`` (the masked refit under
each slot's hyperparameters) against the JAX package's ``repro.bank.GPBank``
on the same numpy inputs, on both backends (the JAX ``pallas`` backend in
interpret mode, the port's its kernels' plain versions on the CPU).

Gates are the JAX package's own: downdate against refit_window at 1e-5 in
mean and variance (tests/test_lifecycle.py:386-407, and the churn
benchmark's shape, benchmarks/tenant_churn.py:48-53); chol, u and b across
the two packages at the 5e-3 chol gate (tests/test_streaming_fit.py:214);
serving across the packages at 1e-5 (tests/test_gp_bank.py:90); a lost
pivot leaves the slot bit-exactly unchanged (tests/test_lifecycle.py:409-424).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_common import nn, specs, tt, uniform  # noqa: E402

from repro.bank import GPBank as JBank  # noqa: E402
from repro.data import make_gp_dataset as j_make  # noqa: E402
from repro_torch.bank import GPBank  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

BACKENDS = ["jnp", "pallas"]
LEAVES = ("lam", "sqrtlam", "chol", "u", "b")
CHOL = dict(rtol=5e-3, atol=1e-3)                  # tests/test_streaming_fit.py:214
U = dict(rtol=5e-3, atol=1e-4)


def _fleet(B, N, p, n, *, backend="jnp", noise=0.1, seed=0):
    """tests/test_lifecycle.py::_fleet: tenant s gets make_gp_dataset(N, p,
    seed=seed + s); the bank fitted in both packages."""
    Xb = np.zeros((B, N, p), np.float32)
    yb = np.zeros((B, N), np.float32)
    for s in range(B):
        X, y, *_ = j_make(N, p, seed=seed + s)
        Xb[s], yb[s] = np.asarray(X), np.asarray(y)
    js, ts = specs("hermite", p, n=n, backend=backend, noise=noise)
    return (JBank.fit(jnp.asarray(Xb), jnp.asarray(yb), js),
            GPBank.fit(tt(Xb), tt(yb), ts), Xb, yb)


def _serve(bank, ids, Xq):
    mu, var = bank.mean_var(ids, Xq)
    return nn(mu), nn(var)


def _queries(B, p, rows, seed):
    rng = np.random.default_rng(seed)
    Xq = uniform(rng, (rows, p))
    return Xq, [int(t) for t in rng.integers(0, B, rows)]


# ---------------------------------------------------------------------------
# tests/test_lifecycle.py::TestForgetting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_downdate_matches_refit_on_retained_window(backend):
    """The rank-k downdate == the refit on the retained rows to <= 1e-5
    (mu and var), batched over several tenants at once."""
    B, N, p, n, k = 4, 40, 2, 6, 8
    _, bank, Xb, yb = _fleet(B, N, p, n, backend=backend)
    down, ok = bank.downdate(list(range(B)), tt(Xb[:, :k]), tt(yb[:, :k]))
    assert isinstance(ok, np.ndarray) and ok.dtype == bool and ok.all()
    refit = bank.refit_window(list(range(B)), tt(Xb[:, k:]), tt(yb[:, k:]))
    Xq, ids = _queries(B, p, 12, 11)
    mu_d, var_d = _serve(down, ids, tt(Xq))
    mu_r, var_r = _serve(refit, ids, tt(Xq))
    np.testing.assert_allclose(mu_d, mu_r, atol=1e-5, rtol=0)
    np.testing.assert_allclose(var_d, var_r, atol=1e-5, rtol=0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_pd_loss_leaves_slot_untouched_and_flags(backend):
    """Downdating rows that were never absorbed loses positive
    definiteness: ok=False and the slot is BIT-exactly unchanged."""
    B, N, p, n = 2, 40, 2, 6
    _, bank, _, _ = _fleet(B, N, p, n, backend=backend)
    new, ok = bank.downdate([0], torch.full((1, 8, p), 0.3), torch.full((1, 8), 50.0))
    assert not ok[0]
    s = bank.slot_of(0)
    for f in LEAVES:
        assert torch.equal(getattr(new.stack, f)[s], getattr(bank.stack, f)[s]), f


@pytest.mark.parametrize("backend", BACKENDS)
def test_churn_benchmark_shape_downdate_equals_refit(backend):
    """benchmarks/tenant_churn.py's gate at its shape (B = 16, N = 40,
    p = 2, n = 6, noise 0.1, k = 6; its queries, 256 over the first 8
    tenants from seed 11): downdate == refit_window within 1e-5, in both
    packages."""
    B, N, p, n, k = 16, 40, 2, 6, 6
    jb, bank, Xb, yb = _fleet(B, N, p, n, backend=backend)
    ids = list(range(B))
    rng = np.random.default_rng(11)
    batches = []
    for _ in range(4):
        q_ids = [ids[int(i)] for i in rng.integers(0, 8, 64)]
        batches.append((q_ids, rng.uniform(-1, 1, size=(64, p)).astype(np.float32)))
    for b, X_, y_ in ((bank, tt(Xb), tt(yb)), (jb, jnp.asarray(Xb), jnp.asarray(yb))):
        down, ok = b.downdate(ids, X_[:, :k], y_[:, :k])
        assert np.all(ok)
        refit = b.refit_window(ids, X_[:, k:], y_[:, k:])
        for q_ids, Xq in batches:
            Xq = tt(Xq) if b is bank else jnp.asarray(Xq)
            md, vd = down.mean_var(q_ids, Xq)
            mr, vr = refit.mean_var(q_ids, Xq)
            assert np.abs(nn(md) - nn(mr)).max() <= 1e-5
            assert np.abs(nn(vd) - nn(vr)).max() <= 1e-5


# ---------------------------------------------------------------------------
# the port's downdate and refit against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_downdate_matches_jax_with_padding_and_bogus_groups(backend):
    """One slot-addressed call of four groups: two real downdates, a fully
    masked padding group and a bogus group (rows never absorbed).  The
    ``ok`` flags equal the JAX package's; chol, u and b at the chol gate;
    serving at 1e-5; the padding and bogus slots bitwise unchanged."""
    B, N, p, n, k = 5, 40, 2, 6, 8
    jb, bank, Xb, yb = _fleet(B, N, p, n, backend=backend)
    Xg = np.stack([Xb[0, :k], Xb[2, :k], np.zeros((k, p), np.float32),
                   np.full((k, p), 0.3, np.float32)])
    yg = np.stack([yb[0, :k], yb[2, :k], np.zeros(k, np.float32),
                   np.full(k, 50.0, np.float32)])
    mg = np.ones((4, k), np.float32)
    mg[0, k - 2:] = 0.0           # a ragged group: its last two rows stay
    mg[2] = 0.0                   # padding
    slots = [0, 2, 3, 4]
    jd, jok = jb._downdate_at_slots(jnp.asarray(np.array(slots, np.int32)), jnp.asarray(Xg),
                                    jnp.asarray(yg), jnp.asarray(mg))
    td, tok = bank._downdate_at_slots(torch.tensor(slots), tt(Xg), tt(yg), tt(mg))
    assert tok.tolist() == np.asarray(jok).tolist() == [True, True, True, False]
    for f, gate in (("chol", CHOL), ("u", U), ("b", CHOL)):
        np.testing.assert_allclose(nn(getattr(td.stack, f)), np.asarray(getattr(jd.stack, f)),
                                   **gate, err_msg=f)
    for s in (1, 3, 4):
        for f in LEAVES:
            assert torch.equal(getattr(td.stack, f)[s], getattr(bank.stack, f)[s]), (s, f)
    Xq, ids = _queries(B, p, 20, 3)
    mu_t, var_t = _serve(td, ids, tt(Xq))
    mu_j, var_j = _serve(jd, ids, jnp.asarray(Xq))
    np.testing.assert_allclose(mu_t, mu_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(var_t, var_j, atol=1e-5, rtol=0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_refit_window_matches_jax(backend):
    """A ragged refit (per-group masks) of three tenants in both packages:
    each slot's leaves at the chol gate, its eigenvalue rows at rtol 1e-5
    (each package exponentiates a float32 sum of per-dimension logs: the
    homogeneous fits' rows already differ by up to 2e-6 relative in the
    smallest eigenvalues) and its serving at 1e-5; a fully masked group
    leaves its slot untouched."""
    B, N, p, n = 4, 40, 2, 6
    jb, bank, Xb, yb = _fleet(B, N, p, n, backend=backend)
    W = 30
    mw = np.ones((3, W), np.float32)
    mw[1, 20:] = 0.0
    mw[2] = 0.0
    slots = [1, 0, 3]
    Xw, yw = Xb[slots, 10:], yb[slots, 10:]
    jr = jb._refit_at_slots(jnp.asarray(np.array(slots, np.int32)), jnp.asarray(Xw),
                            jnp.asarray(yw), jnp.asarray(mw))
    tr = bank._refit_at_slots(torch.tensor(slots), tt(Xw), tt(yw), tt(mw))
    for f, gate in (("chol", CHOL), ("u", U), ("b", CHOL),
                    ("lam", dict(rtol=1e-5, atol=0)), ("sqrtlam", dict(rtol=1e-5, atol=0))):
        np.testing.assert_allclose(nn(getattr(tr.stack, f)), np.asarray(getattr(jr.stack, f)),
                                   **gate, err_msg=f)
    for f in LEAVES:
        assert torch.equal(getattr(tr.stack, f)[3], getattr(bank.stack, f)[3]), f
    Xq, ids = _queries(B, p, 16, 5)
    for got, want in zip(_serve(tr, ids, tt(Xq)), _serve(jr, ids, jnp.asarray(Xq))):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_refit_window_equals_a_fresh_fit_of_the_window():
    """refit_window on the retained rows serves as GPBank.fit on them."""
    B, N, p, n = 3, 40, 2, 6
    _, bank, Xb, yb = _fleet(B, N, p, n)
    refit = bank.refit_window([0, 1, 2], tt(Xb[:, 12:]), tt(yb[:, 12:]))
    fresh = GPBank.fit(tt(Xb[:, 12:]), tt(yb[:, 12:]), bank.spec)
    for f in ("chol", "u", "b"):
        np.testing.assert_allclose(nn(getattr(refit.stack, f)), nn(getattr(fresh.stack, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


# ---------------------------------------------------------------------------
# the bank's own contracts
# ---------------------------------------------------------------------------


def test_downdate_and_refit_leave_the_old_bank_and_carry_the_cache():
    B, N, p, n, k = 4, 40, 2, 6, 8
    _, bank, Xb, yb = _fleet(B, N, p, n)
    bank.mean_var([0], torch.zeros(1, p))          # pays for the B^-1 cache
    before = {f: getattr(bank.stack, f).clone() for f in LEAVES}
    down, ok = bank.downdate([1, 3], tt(Xb[[1, 3], :k]), tt(yb[[1, 3], :k]))
    refit = down.refit_window([2], tt(Xb[2:3, k:]), tt(yb[2:3, k:]))
    for f, v in before.items():
        assert torch.equal(getattr(bank.stack, f), v), f
    for b in (down, refit):
        carried = b.__dict__["_binv_cache"]
        fresh = torch.cholesky_inverse(b.stack.chol)
        np.testing.assert_allclose(nn(carried), nn(fresh), rtol=1e-5, atol=1e-6)
    assert ok.all()


def test_downdate_and_refit_refuse_bad_batches():
    _, bank, Xb, yb = _fleet(3, 40, 2, 5)
    X3, y3 = tt(Xb[:2, :4]), tt(yb[:2, :4])
    with pytest.raises(ValueError, match="duplicate tenant"):
        bank.downdate([0, 0], X3, y3)
    with pytest.raises(ValueError, match="duplicate tenant"):
        bank.refit_window([1, 1], X3, y3)
    with pytest.raises(ValueError, match="one tenant id per downdate group"):
        bank.downdate([0], X3, y3)
    with pytest.raises(ValueError, match="mask must be"):
        bank.downdate([0, 1], X3, y3, mask=torch.ones(2, 3))
    with pytest.raises(ValueError, match="wants Xw"):
        bank.refit_window([0, 1], X3[0], y3)
    with pytest.raises(ValueError, match="distinct slots"):
        bank._downdate_at_slots(torch.tensor([1, 1]), X3, y3)
    with pytest.raises(KeyError, match="not in this bank"):
        bank.downdate([0, 9], X3, y3)


def test_downdate_on_the_cpu_launches_nothing():
    _, bank, Xb, yb = _fleet(2, 40, 2, 5, backend="pallas")
    ops.reset_launch_counts()
    bank.downdate([0, 1], tt(Xb[:, :4]), tt(yb[:, :4]))
    bank.refit_window([0], tt(Xb[:1, 4:]), tt(yb[:1, 4:]))
    assert all(not v for v in ops.launch_counts().values())


def test_full_width_downdate_sits_as_far_from_its_refit_as_jax():
    """ROADMAP.md section C, C7: at the fleet's per-tenant width (N = 10^4,
    p = 4, n = 5, M = 625, noise 0.05; four tenants of the fleet's data,
    16 rows forgotten) the float32 downdate and refit_window differ by more
    than the 1e-5 gate in the mean, in the JAX package as in the port (jnp
    backend; 256 mixed queries).  Both distances are printed; the port's
    may not exceed the reference's by more than float32 noise, and the
    variances hold the gate in both."""
    from repro_torch.launch.serve_gp import fleet_dataset

    B, N, p, n, K = 4, 10_000, 4, 5, 16
    _, Xb, yb, _ = fleet_dataset(np.random.default_rng(0), tenants=B, n_train=N, p=p,
                                 rounds=1, observations_per_round=8, noise=0.05, seed=0)
    Xq = uniform(np.random.default_rng(13), (256, p))
    ids = [int(t) for t in np.random.default_rng(14).integers(0, B, 256)]
    js, ts = specs("hermite", p, n=n, noise=0.05)
    dist = {}
    for name, bank, X_, y_, Q in (
            ("jax", JBank.fit(jnp.asarray(Xb), jnp.asarray(yb), js), jnp.asarray(Xb),
             jnp.asarray(yb), jnp.asarray(Xq)),
            ("port", GPBank.fit(tt(Xb), tt(yb), ts), tt(Xb), tt(yb), tt(Xq))):
        down, ok = bank.downdate(list(range(B)), X_[:, :K], y_[:, :K])
        assert np.all(ok)
        refit = bank.refit_window(list(range(B)), X_[:, K:], y_[:, K:])
        (md, vd), (mr, vr) = down.mean_var(ids, Q), refit.mean_var(ids, Q)
        dist[name] = (float(np.abs(nn(md) - nn(mr)).max()), float(np.abs(nn(vd) - nn(vr)).max()))
    print(f"downdate vs refit_window at N={N}, M={n ** p}, K={K} (mean, variance): "
          f"JAX {dist['jax']}, port {dist['port']}")
    assert dist["port"][0] <= 4 * dist["jax"][0] + 1e-5
    assert max(dist["jax"][1], dist["port"][1]) <= 1e-5
