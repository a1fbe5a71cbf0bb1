"""Port parity for the fleet's bank: ``repro_torch.bank.GPBank`` and its two
kernels (the bank fused fit and the batched rank-K sweep) against the JAX
package's ``repro.bank.GPBank`` (backend ``pallas`` in interpret mode, and
``jnp``) on the same numpy inputs, at the tolerances of
``tests/test_gp_bank.py``; plus the bank's own contracts (immutability,
padding identities, the B^-1 cache, admission checks) and the card-only
checks (marked ``cuda``, skipped without a card)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_common import gp_data, nn, specs, tt, uniform  # noqa: E402

from repro.bank import GPBank as JBank  # noqa: E402
from repro.core import fagp as jfagp  # noqa: E402
from repro_torch.bank import GPBank  # noqa: E402
from repro_torch.core import expansions as texp  # noqa: E402
from repro_torch.core import fagp as tfagp  # noqa: E402
from repro_torch.core.convert import bank_from_numpy  # noqa: E402
from repro_torch.core.gp import GP  # noqa: E402
from repro_torch.kernels import chol_update as tchol  # noqa: E402
from repro_torch.kernels import hermite_phi as thp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import phi_gram as tgram  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


def _stack(B, N, p, seed=0):
    """(Xb (B, N, p), yb (B, N)) numpy: tenant s gets Eq. 21 data of seed
    seed + s."""
    Xb = np.zeros((B, N, p), np.float32)
    yb = np.zeros((B, N), np.float32)
    for s in range(B):
        Xb[s], yb[s] = gp_data(N, p, seed + s)
    return Xb, yb


def _queries(B, p, rows, seed=1):
    rng = np.random.default_rng(seed)
    return uniform(rng, (rows, p)), [int(t) for t in rng.integers(0, B, rows)]


def _carry(jbank, ts):
    """A JAX bank carried across as its numpy leaves."""
    st = jbank.stack
    return bank_from_numpy(
        idx=np.asarray(st.idx), lam=np.asarray(st.lam), sqrtlam=np.asarray(st.sqrtlam),
        chol=np.asarray(st.chol), u=np.asarray(st.u), b=np.asarray(st.b),
        slots=dict(jbank.slots), active=jbank.active, spec=ts,
    )


def _fleet(B, N, p, n, *, backend="jnp", capacity=None, seed=0):
    """The same fleet fitted in both packages: (jax bank, port bank, Xb, yb,
    jax spec, port spec)."""
    Xb, yb = _stack(B, N, p, seed)
    js, ts = specs("hermite", p, n=n, backend=backend)
    jb = JBank.fit(jnp.asarray(Xb), jnp.asarray(yb), js, capacity=capacity)
    tb = GPBank.fit(tt(Xb), tt(yb), ts, capacity=capacity)
    return jb, tb, Xb, yb, js, ts


def _leaves(bank):
    return {f: getattr(bank.stack, f).clone() for f in ("lam", "sqrtlam", "chol", "u", "b")}


def _assert_unchanged(bank, before):
    for f, v in before.items():
        assert torch.equal(getattr(bank.stack, f), v), f"{f} of the old bank changed"


# ---------------------------------------------------------------------------
# the bank kernel (TPU kernel #4) and its plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("expansion", ["hermite", "rff_se"])
@pytest.mark.parametrize("ragged", [False, True])
def test_bank_moments_match_jax(expansion, ragged):
    """The port's bank moments (the bank kernel's plain version behind
    ``pallas``, the batched plain scan behind ``jnp``) == the JAX bank
    kernel in interpret mode, with and without per-slot row masks
    (tests/test_gp_bank.py:48 gate, 1e-3)."""
    B, N, p, n = 5, 40, 2, 6
    rng = np.random.default_rng(3)
    Xb = uniform(rng, (B, N, p))
    yb = rng.standard_normal((B, N)).astype(np.float32)
    mask = ((rng.uniform(size=(B, N)) > 0.4) if ragged else np.ones((B, N))).astype(np.float32)
    js, ts = specs(expansion, p, n=n, num_features=16)
    idx_np = js.indices()
    jbe = jfagp.get_backend("pallas")
    Gj, bj = jbe.bank_moments(jnp.asarray(Xb), jnp.asarray(yb), js, jnp.asarray(idx_np),
                              jbe.prepare(idx_np, js), 64, jnp.asarray(mask))
    idx = tfagp._idx_tensor(ts)
    for name in ("pallas", "jnp"):
        G, b = tfagp.get_backend(name).bank_moments(tt(Xb), tt(yb), ts, idx, 64, tt(mask))
        assert G.shape == (B, idx.shape[0], idx.shape[0]) and b.shape == (B, idx.shape[0])
        np.testing.assert_allclose(nn(G), nn(Gj), rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(nn(b), nn(bj), rtol=1e-3, atol=1e-3)


def test_bank_plain_matches_materialized_oracle():
    """Slot by slot, the plain bank moments == Phi^T Phi and Phi^T y of the
    slot's kept rows with Phi materialized by the one-hot oracle."""
    B, N, p, n = 4, 37, 3, 4
    rng = np.random.default_rng(5)
    Xb, yb = uniform(rng, (B, N, p)), rng.standard_normal((B, N)).astype(np.float32)
    mask = (rng.uniform(size=(B, N)) > 0.3).astype(np.float32)
    mask[2] = 0.0  # a fully-masked slot
    _, ts = specs("hermite", p, n=n)
    tile = texp.get_expansion("hermite").tile_args(ts, tfagp._idx_tensor(ts))
    S = tt(tref.one_hot_selection(ts.indices(), n))
    G, b = tgram.bank_phi_gram_plain(tt(Xb), tt(yb), tt(mask), tile)
    for s in range(B):
        keep = mask[s] > 0
        Gr, br = tref.ref_fused_fit_moments(tt(Xb[s][keep]), tt(yb[s][keep]), tile.consts,
                                            S, None, 1.0, n, scale=False)
        np.testing.assert_allclose(nn(G[s]), nn(Gr), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(nn(b[s]), nn(br), rtol=1e-4, atol=1e-5)
    assert not torch.any(G[2]) and not torch.any(b[2])


def test_bank_fused_fit_moments_validates_shapes():
    _, ts = specs("hermite", 2, n=3)
    tile = texp.get_expansion("hermite").tile_args(ts, tfagp._idx_tensor(ts))
    with pytest.raises(ValueError, match="Xb must be"):
        ops.bank_fused_fit_moments(torch.zeros(4, 2), torch.zeros(4), tile)
    with pytest.raises(ValueError, match="yb must be"):
        ops.bank_fused_fit_moments(torch.zeros(2, 4, 2), torch.zeros(2, 5), tile)
    with pytest.raises(ValueError, match="mask must be"):
        ops.bank_fused_fit_moments(torch.zeros(2, 4, 2), torch.zeros(2, 4), tile,
                                   torch.ones(1, 4))


# ---------------------------------------------------------------------------
# the batched sweep and its plain version
# ---------------------------------------------------------------------------


def _spd_factors(G, M, seed):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((G, M, M)).astype(np.float32)
    B = np.eye(M, dtype=np.float32) + R @ R.transpose(0, 2, 1) / M
    return np.linalg.cholesky(B).astype(np.float32)


@pytest.mark.parametrize("G,M,K", [(3, 40, 5), (5, 64, 4)])
def test_batched_sweep_matches_jax_and_single_systems(G, M, K):
    """The plain batched sweep (vectorised over the group axis) == the JAX
    package's vmapped rank-1 scan, and == the single-system sweep system by
    system (the same arithmetic, element by element)."""
    import jax

    L = _spd_factors(G, M, G)
    W = np.random.default_rng(K).standard_normal((G, K, M)).astype(np.float32)

    def jsweep(Lg, Wg):
        return jax.lax.scan(lambda c, w: (jfagp._chol_rank1_update(c, w), None), Lg, Wg)[0]

    want = jax.jit(jax.vmap(jsweep))(jnp.asarray(L), jnp.asarray(W))
    got = ops.chol_update(tt(L), tt(W))
    assert got.shape == (G, M, M)
    # tests/test_streaming_fit.py:214 gate for chol: rtol 5e-3, atol 1e-3
    np.testing.assert_allclose(nn(got), nn(want), rtol=5e-3, atol=1e-3)
    for g in range(G):
        np.testing.assert_allclose(nn(got[g]), nn(tchol.chol_update_plain(tt(L[g]), tt(W[g]))),
                                   rtol=1e-6, atol=1e-7)
    ref = np.linalg.cholesky(L.astype(np.float64) @ L.transpose(0, 2, 1)
                             + W.transpose(0, 2, 1).astype(np.float64) @ W)
    np.testing.assert_allclose(nn(got), ref, rtol=5e-3, atol=1e-3)


def test_batched_sweep_validates_and_leaves_inputs_untouched():
    L, W = tt(_spd_factors(2, 12, 1)), torch.randn(2, 3, 12)
    L0, W0 = L.clone(), W.clone()
    ops.chol_update(L, W)
    assert torch.equal(L, L0) and torch.equal(W, W0)
    with pytest.raises(ValueError, match="shapes"):
        ops.chol_update(L, torch.randn(3, 3, 12))
    with pytest.raises(ValueError, match="shapes"):
        ops.chol_update(L, torch.randn(3, 12))


# ---------------------------------------------------------------------------
# the bank against the JAX bank and against single sessions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_carried_bank_serves_as_jax(backend):
    """A JAX bank carried across serves a mixed-tenant batch as the JAX
    bank does (the 1e-5 abs serving gate, tests/test_gp_bank.py:90)."""
    jb, _, _, _, js, ts = _fleet(8, 16, 2, 6, backend=backend, capacity=10)
    tb = _carry(jb, ts)
    assert tb.capacity == 10 and len(tb) == 8 and tb.n_features == 36
    Xq, ten = _queries(8, 2, 24)
    mj, vj = jb.mean_var(ten, jnp.asarray(Xq))
    mt, vt = tb.mean_var(ten, tt(Xq))
    np.testing.assert_allclose(nn(mt), nn(mj), atol=1e-5)
    np.testing.assert_allclose(nn(vt), nn(vj), atol=1e-5)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("ragged", [False, True])
def test_bank_fit_matches_jax(backend, ragged):
    """GPBank.fit in the port == GPBank.fit in the JAX package, ragged per
    tenant N included (f32-fit tolerance, tests/test_gp_bank.py:103)."""
    B, N, p, n = 6, 24, 2, 6
    Xb, yb = _stack(B, N, p)
    mask = np.ones((B, N), np.float32)
    if ragged:
        for t, cut in enumerate([24, 20, 7, 24, 1, 0]):
            mask[t, cut:] = 0.0
    js, ts = specs("hermite", p, n=n, backend=backend)
    jb = JBank.fit(jnp.asarray(Xb), jnp.asarray(yb), js, mask=jnp.asarray(mask))
    tb = GPBank.fit(tt(Xb), tt(yb), ts, mask=tt(mask))
    Xq, ten = _queries(B, p, 30)
    mj, vj = jb.mean_var(ten, jnp.asarray(Xq))
    mt, vt = tb.mean_var(ten, tt(Xq))
    np.testing.assert_allclose(nn(mt), nn(mj), rtol=5e-3, atol=2e-4)
    np.testing.assert_allclose(nn(vt), nn(vj), rtol=5e-3, atol=2e-4)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_mean_var_matches_loop_b64(backend):
    """The acceptance gate of tests/test_gp_bank.py:82: a B = 64 bank of
    small tenants serves a mixed-tenant batch like a loop of single-model
    sessions over the same states (<= 1e-5 abs)."""
    Xb, yb = _stack(64, 8, 2)
    _, ts = specs("hermite", 2, n=8, backend=backend)
    bank = GPBank.fit(tt(Xb), tt(yb), ts)
    Xq, ten = _queries(64, 2, 192)
    mu, var = bank.mean_var(ten, tt(Xq))
    for t in sorted(set(ten)):
        rows = np.flatnonzero(np.asarray(ten) == t)
        m1, v1 = GP.from_state(bank.state(t)).mean_var(tt(Xq[rows]))
        np.testing.assert_allclose(nn(mu)[rows], nn(m1), atol=1e-5)
        np.testing.assert_allclose(nn(var)[rows], nn(v1), atol=1e-5)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_bank_fit_matches_single_fits(backend):
    """Batched fit == per-tenant fit (f32-fit tolerance)."""
    Xb, yb = _stack(6, 24, 2)
    _, ts = specs("hermite", 2, n=6, backend=backend)
    bank = GPBank.fit(tt(Xb), tt(yb), ts)
    Xq, _ = _queries(6, 2, 8)
    for t in range(6):
        m1, v1 = tfagp.predict_mean_var(tfagp.fit(tt(Xb[t]), tt(yb[t]), ts), tt(Xq))
        m2, v2 = bank.mean_var([t] * 8, tt(Xq))
        np.testing.assert_allclose(nn(m2), nn(m1), rtol=5e-3, atol=2e-4)
        np.testing.assert_allclose(nn(v2), nn(v1), rtol=5e-3, atol=2e-4)


# (n, k): M = 36 with k = 8 takes the refactor branch (8 * 8 > 36); M = 64
# with k = 4 takes the batched sweep (4 * 8 <= 64)
BRANCHES = {"refactor": (6, 8), "sweep": (8, 4)}


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_batched_update_matches_jax_and_loop(backend, branch, monkeypatch):
    """GPBank.update (a ragged group included) == the JAX bank's update of
    the same carried-across bank, and == a loop of single fit_updates on the
    kept rows (1e-5, tests/test_gp_bank.py:110); untouched tenants keep
    their exact posterior; the old bank is unchanged."""
    n, k = BRANCHES[branch]
    jb, _, _, _, js, ts = _fleet(6, 24, 2, n, backend=backend)
    tb = _carry(jb, ts)
    M = tb.n_features
    assert (k * 8 <= M) == (branch == "sweep")
    rng = np.random.default_rng(11)
    ids = [1, 4, 5]
    Xk = uniform(rng, (3, k, 2))
    yk = rng.standard_normal((3, k)).astype(np.float32)
    mask = np.ones((3, k), np.float32)
    mask[2, 3:] = 0.0  # tenant 5 ingests only 3 real rows
    sweeps = []
    plain = tchol.chol_update_plain
    monkeypatch.setattr(tchol, "chol_update_plain",
                        lambda L, W: sweeps.append(tuple(L.shape)) or plain(L, W))
    if backend == "jnp":
        monkeypatch.setitem(tfagp._BACKENDS, "jnp", dataclasses.replace(
            tfagp.get_backend("jnp"), rank_update=tchol.chol_update_plain))
    before = _leaves(tb)
    up = tb.update(ids, tt(Xk), tt(yk), tt(mask))
    assert sweeps == ([(3, M, M)] if branch == "sweep" else [])
    _assert_unchanged(tb, before)
    ju = jb.update(ids, jnp.asarray(Xk), jnp.asarray(yk), jnp.asarray(mask))
    Xq, _ = _queries(6, 2, 6)
    for g, t in enumerate(ids):
        kept = int(mask[g].sum())
        st = tfagp.fit_update(tb.state(t), tt(Xk[g, :kept]), tt(yk[g, :kept]))
        m1, v1 = tfagp.predict_mean_var(st, tt(Xq))
        m2, v2 = up.mean_var([t] * 6, tt(Xq))
        mj, vj = ju.mean_var([t] * 6, jnp.asarray(Xq))
        for got, want in ((m2, m1), (v2, v1), (m2, mj), (v2, vj)):
            np.testing.assert_allclose(nn(got), nn(want), atol=1e-5)
    for f in ("chol", "u", "b"):
        assert torch.equal(getattr(up.stack, f)[0], getattr(tb.stack, f)[0])


def test_update_of_one_tenant_matches_its_slot_in_a_larger_update():
    """A one-tenant update (a batch of one system) gives the factor that the
    same rows give that tenant in an update of several tenants."""
    _, tb, *_ = _fleet(4, 16, 2, 8)
    rng = np.random.default_rng(7)
    Xk, yk = uniform(rng, (2, 3, 2)), rng.standard_normal((2, 3)).astype(np.float32)
    one = tb.update([1], tt(Xk[:1]), tt(yk[:1]))
    two = tb.update([1, 2], tt(Xk), tt(yk))
    np.testing.assert_allclose(nn(one.stack.chol[1]), nn(two.stack.chol[1]), rtol=1e-6, atol=1e-6)
    assert torch.equal(one.stack.chol[2], tb.stack.chol[2])
    assert not torch.equal(one.stack.chol[1], tb.stack.chol[1])


def test_fully_masked_group_leaves_its_slot_bit_identical():
    """A fully-masked group (the router's padding) writes nothing: its slot
    is bit-identical, while a real group in the same call moves."""
    _, tb, *_ = _fleet(4, 16, 2, 8)
    rng = np.random.default_rng(2)
    Xk, yk = uniform(rng, (2, 4, 2)), rng.standard_normal((2, 4)).astype(np.float32)
    mask = np.ones((2, 4), np.float32)
    mask[1] = 0.0
    up = tb.update([0, 3], tt(Xk), tt(yk), tt(mask))
    for f in ("chol", "u", "b"):
        assert torch.equal(getattr(up.stack, f)[3], getattr(tb.stack, f)[3])
    assert not torch.equal(up.stack.chol[0], tb.stack.chol[0])


def test_fully_masked_slots_serve_the_prior():
    """A reserved (capacity > B) slot and a fully-masked fit slot both hold
    the prior state (chol = I, u = b = 0, the leaves ``create`` builds);
    the masked tenant serves the prior: zero mean, variance |Phi D|^2."""
    Xb, yb = _stack(3, 16, 2)
    mask = np.ones((3, 16), np.float32)
    mask[1] = 0.0
    _, ts = specs("hermite", 2, n=5)
    bank = GPBank.fit(tt(Xb), tt(yb), ts, mask=tt(mask), capacity=5)
    empty = GPBank.create(ts, 1)
    for slot in (1, 3):
        np.testing.assert_allclose(nn(bank.stack.chol[slot]), np.eye(bank.n_features), atol=1e-6)
        for f in ("u", "b"):
            assert not torch.any(getattr(bank.stack, f)[slot])
        for f in ("lam", "sqrtlam"):
            assert torch.equal(getattr(bank.stack, f)[slot], getattr(empty.stack, f)[0])
    Xq, _ = _queries(1, 2, 4)
    mu, var = bank.mean_var([1] * 4, tt(Xq))
    prior = torch.sum((tfagp.build_features(tt(Xq), ts) * bank.stack.sqrtlam[1]) ** 2, dim=1)
    assert not torch.any(mu)
    np.testing.assert_allclose(nn(var), nn(prior), rtol=1e-5, atol=1e-7)
    assert list(bank.active) == [True, True, True, False, False]


def test_masked_fit_equals_unpadded_fits():
    """Tenants with different true N on one fixed (B, N, p) stack: the row
    mask makes the padding invisible (tests/test_gp_bank.py:213)."""
    B, N, p = 5, 32, 2
    Xb, yb = _stack(B, N, p)
    true_n = [32, 20, 7, 32, 1]
    mask = np.zeros((B, N), np.float32)
    for t, cut in enumerate(true_n):
        mask[t, :cut] = 1.0
    _, ts = specs("hermite", p, n=6, backend="pallas")
    bank = GPBank.fit(tt(Xb), tt(yb), ts, mask=tt(mask))
    Xq, _ = _queries(B, p, 6)
    for t, cut in enumerate(true_n):
        m1, v1 = tfagp.predict_mean_var(tfagp.fit(tt(Xb[t, :cut]), tt(yb[t, :cut]), ts), tt(Xq))
        m2, v2 = bank.mean_var([t] * 6, tt(Xq))
        np.testing.assert_allclose(nn(m2), nn(m1), rtol=5e-3, atol=2e-4)
        np.testing.assert_allclose(nn(v2), nn(v1), rtol=5e-3, atol=2e-4)


# ---------------------------------------------------------------------------
# membership churn and the serving cache
# ---------------------------------------------------------------------------


def test_insert_evict_reuse_slot_and_immutability():
    """insert -> serve -> evict cycles reuse the free slot; the bank an
    insert or evict came from serves exactly as before."""
    _, bank, _, _, _, ts = _fleet(3, 16, 2, 5, capacity=4)
    Xq, _ = _queries(3, 2, 4)
    before = _leaves(bank)
    m0, v0 = bank.mean_var([0, 1, 2, 0], tt(Xq))
    b = bank
    for r in range(3):
        Xn, yn = gp_data(16, 2, 60 + r)
        b = b.insert(f"tenant-{r}", (tt(Xn), tt(yn)))
        assert b.slot_of(f"tenant-{r}") == 3 and len(b) == 4
        m1, v1 = tfagp.predict_mean_var(tfagp.fit(tt(Xn), tt(yn), ts), tt(Xq))
        m2, v2 = b.mean_var([f"tenant-{r}"] * 4, tt(Xq))
        np.testing.assert_allclose(nn(m2), nn(m1), atol=1e-5)
        np.testing.assert_allclose(nn(v2), nn(v1), atol=1e-5)
        b = b.evict(f"tenant-{r}")
        assert f"tenant-{r}" not in b
        np.testing.assert_array_equal(nn(b.stack.chol[3]), np.eye(b.n_features))
    _assert_unchanged(bank, before)
    m3, v3 = bank.mean_var([0, 1, 2, 0], tt(Xq))
    assert torch.equal(m3, m0) and torch.equal(v3, v0)


def test_insert_validates_spec_and_capacity():
    _, bank, _, _, _, ts = _fleet(2, 16, 2, 5)
    X, y = map(tt, gp_data(16, 2, 9))
    with pytest.raises(ValueError, match="bank is full"):
        bank.insert("t", (X, y))
    bank4 = GPBank.create(ts, 4)
    with pytest.raises(ValueError, match="spec/state mismatch"):
        bank4.insert("t", tfagp.fit(X, y, ts.replace(n=4)))
    with pytest.raises(ValueError, match="noise differs"):
        bank4.insert("t", tfagp.fit(X, y, ts.replace(noise=torch.tensor(0.5))))
    with pytest.raises(ValueError, match="multi-output"):
        bank4.insert("t", tfagp.fit(X, torch.stack([y, y], 1), ts))
    with pytest.raises(ValueError, match="already in the bank"):
        bank.insert(0, (X, y))
    with pytest.raises(ValueError, match="capacity"):
        GPBank.create(ts, 0)


def test_evicted_tenant_is_gone_and_states_roundtrip():
    _, bank, *_ = _fleet(3, 16, 2, 5)
    b = bank.evict(1)
    assert 1 not in b and len(b) == 2 and b.tenants == [0, 2]
    with pytest.raises(KeyError, match="not in this bank"):
        b.slot_of(1)
    rebuilt = GPBank.from_states(b.states(), capacity=3)
    Xq, _ = _queries(3, 2, 4)
    m1, v1 = b.mean_var([0, 2, 0, 2], tt(Xq))
    m2, v2 = rebuilt.mean_var([0, 2, 0, 2], tt(Xq))
    np.testing.assert_allclose(nn(m2), nn(m1), atol=1e-6)
    np.testing.assert_allclose(nn(v2), nn(v1), atol=1e-6)
    with pytest.raises(ValueError, match="at least one"):
        GPBank.from_states({})


def test_incremental_binv_carry_matches_fresh_cache():
    """A bank whose serving cache was carried through update / insert /
    evict answers exactly like one that rebuilds the cache from scratch
    (tests/test_gp_bank.py:158), the variance too: a slot's B^{-1} is the
    same chain of operations whether it is refreshed alone or with the
    whole stack (``fagp._bank_binv``)."""
    _, bank, *_ = _fleet(5, 16, 2, 5, capacity=6)
    Xq, ten = _queries(5, 2, 6)
    bank.mean_var(ten, tt(Xq))  # populate the parent cache
    rng = np.random.default_rng(8)
    Xk, yk = tt(uniform(rng, (2, 4, 2))), tt(rng.standard_normal((2, 4)).astype(np.float32))
    Xn, yn = map(tt, gp_data(16, 2, 70))

    def mutate(b):
        return b.update([1, 3], Xk, yk).evict(0).insert("n", (Xn, yn))

    carried = mutate(bank)
    assert "_binv_cache" in carried.__dict__  # the cache rode along
    fresh = mutate(GPBank.from_states(bank.states(), capacity=6))
    assert "_binv_cache" not in fresh.__dict__
    q = ["n", 1, 3, 2, "n", 4]
    m1, v1 = carried.mean_var(q, tt(Xq))
    m2, v2 = fresh.mean_var(q, tt(Xq))
    np.testing.assert_array_equal(nn(m1), nn(m2))
    np.testing.assert_array_equal(nn(v1), nn(v2))


@pytest.mark.parametrize("expansion", ["hermite", "rff_se"])
def test_bank_serves_the_same_states_alike_on_both_backends(expansion):
    """One mixed-tenant batch of the same fitted states served on the
    kernel backend (``pallas``) and on the plain one (``jnp``): only the
    feature map differs, so the two agree within the fleet's serving gate
    (tests/test_gp_bank.py:90, 1e-5 abs), the check chip_smoke.py makes on
    the card at the fleet's width."""
    Xb, yb = _stack(6, 40, 2)
    _, ts = specs(expansion, 2, n=6, num_features=16, backend="pallas")
    bank = GPBank.fit(tt(Xb), tt(yb), ts)
    plain = dataclasses.replace(bank, stack=bank.stack.with_spec(backend="jnp"))
    assert plain.spec.backend == "jnp" and bank.spec.backend == "pallas"
    Xq, ten = _queries(6, 2, 30)
    mk, vk = bank.mean_var(ten, tt(Xq))
    mp, vp = plain.mean_var(ten, tt(Xq))
    np.testing.assert_allclose(nn(mk), nn(mp), rtol=0, atol=1e-5)
    np.testing.assert_allclose(nn(vk), nn(vp), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_update_and_fit_refuse_bad_batches():
    _, bank, _, _, _, ts = _fleet(4, 16, 2, 5)
    Xk, yk = torch.zeros(2, 3, 2), torch.zeros(2, 3)
    with pytest.raises(ValueError, match="duplicate tenant"):
        bank.update([2, 2], Xk, yk)
    with pytest.raises(ValueError, match="mask must be"):
        bank.update([0, 1], Xk, yk, mask=torch.ones(1, 3))
    with pytest.raises(ValueError, match="one tenant id per update group"):
        bank.update([0], Xk, yk)
    with pytest.raises(ValueError, match="distinct slots"):
        bank._update_at_slots(torch.tensor([1, 1]), Xk, yk)
    with pytest.raises(ValueError, match="mask must be"):
        GPBank.fit(torch.zeros(2, 4, 2), torch.zeros(2, 4), ts, mask=torch.ones(4))
    with pytest.raises(ValueError, match="capacity"):
        GPBank.fit(torch.zeros(2, 4, 2), torch.zeros(2, 4), ts, capacity=1)
    with pytest.raises(ValueError, match="one tenant id per query row"):
        bank.mean_var([0, 1], torch.zeros(3, 2))
    with pytest.raises(TypeError, match="sequence of tenant ids"):
        bank.mean_var(0, torch.zeros(1, 2))


def test_unported_bank_paths_name_their_roadmap_items():
    """No bank path is refused any more: what A2 and A3 brought (downdate,
    refit_window, optimize, a per-slot overlay) runs
    (tests/test_torch_downdate.py, tests/test_torch_hetero_bank.py), and so
    does A4's donated update, which writes in place and leaves the donor
    raising on use (tests/test_torch_engine.py).  An overlay must be
    per-slot ``SEKernelParams``."""
    jb, bank, _, _, _, ts = _fleet(2, 16, 2, 5)
    Xk, yk = torch.zeros(1, 3, 2), torch.zeros(1, 3)
    new = bank._update_at_slots(torch.tensor([0]), Xk, yk, donate=True)
    assert isinstance(new, GPBank) and new.stack.chol is bank.stack.chol
    with pytest.raises(RuntimeError, match="donated"):
        bank.mean_var([0], torch.zeros(1, 2))
    st = jb.stack
    for call in (lambda: GPBank(stack=bank.stack, active=bank.active, slots=bank.slots,
                                hypers=object()),
                 lambda: bank_from_numpy(
                     idx=np.asarray(st.idx), lam=np.asarray(st.lam),
                     sqrtlam=np.asarray(st.sqrtlam), chol=np.asarray(st.chol),
                     u=np.asarray(st.u), b=np.asarray(st.b), slots=dict(jb.slots),
                     active=jb.active, spec=ts, hypers=object())):
        with pytest.raises(TypeError, match="SEKernelParams|eps, rho and noise"):
            call()


def test_bank_from_numpy_validates_leaves():
    jb, _, _, _, _, ts = _fleet(2, 16, 2, 5, capacity=3)
    st = jb.stack
    leaves = {f: np.asarray(getattr(st, f)) for f in ("idx", "lam", "sqrtlam", "chol", "u", "b")}
    with pytest.raises(ValueError, match="each active slot"):
        bank_from_numpy(**leaves, slots={0: 0, 1: 2}, active=jb.active, spec=ts)
    with pytest.raises(ValueError, match="chol must be"):
        bank_from_numpy(**{**leaves, "chol": leaves["chol"][:, :-1]}, slots=dict(jb.slots),
                        active=jb.active, spec=ts)


# ---------------------------------------------------------------------------
# card-only checks (skipped without a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (repro_torch's CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("expansion", ["hermite", "rff_se"])
def test_cuda_bank_kernel_matches_plain(cuda_device, expansion):
    B, N, p = 5, 1037, 3
    gen = torch.Generator().manual_seed(0)
    Xb = (torch.rand(B, N, p, generator=gen) * 2 - 1).to(cuda_device)
    yb = torch.randn(B, N, generator=gen).to(cuda_device)
    mask = (torch.rand(B, N, generator=gen) > 0.3).float().to(cuda_device)
    _, ts = specs(expansion, p, n=5, num_features=100)
    tile = texp.get_expansion(expansion).tile_args(ts, tfagp._idx_tensor(ts))
    tile = dataclasses.replace(tile, **{f: getattr(tile, f).to(cuda_device)
                                        for f in ("consts", "coef", "idx", "table")
                                        if getattr(tile, f) is not None})
    ops.reset_launch_counts()
    G, b = ops.bank_fused_fit_moments(Xb, yb, tile, mask)
    assert ops.launch_counts()["phi_gram"] == {"bank": 1}
    Gp, bp = tgram.bank_phi_gram_plain(Xb, yb, mask, tile)
    assert torch.equal(G, G.mT)
    # chip_smoke.py's gate: 1e-4 of the sums' Cauchy-Schwarz magnitude
    # |phi_i| |phi_j| (|phi_i| |y| for b); elementwise gates fail on entries
    # that cancel to far below their terms
    for s in range(B):
        cn = (thp.phi_features_plain(Xb[s], tile) * mask[s, :, None]).norm(dim=0)
        assert torch.all((G[s] - Gp[s]).abs() <= 1e-5 + 1e-4 * torch.maximum(
            Gp[s].abs(), cn[:, None] * cn[None, :]))
        assert torch.all((b[s] - bp[s]).abs() <= 1e-5 + 1e-4 * torch.maximum(
            bp[s].abs(), cn * (yb[s] * mask[s]).norm()))


# one body serves both kernels: each slot's unscaled G and b are the bits
# of the one-model kernel on that slot's rows and mask (Hermite at the
# fleet's n = 5 on both sides of the 128-column tile edge, and RFF)
@pytest.mark.cuda
@pytest.mark.parametrize("expansion,p", [("hermite", 3), ("hermite", 4), ("rff_se", 3)])
def test_cuda_bank_slots_are_bitwise_the_one_model_kernel(cuda_device, expansion, p):
    B, N = 5, 1037
    gen = torch.Generator().manual_seed(p)
    Xb = (torch.rand(B, N, p, generator=gen) * 2 - 1).to(cuda_device)
    yb = torch.randn(B, N, generator=gen).to(cuda_device)
    mask = (torch.rand(B, N, generator=gen) > 0.3).float().to(cuda_device)
    _, ts = specs(expansion, p, n=5, num_features=100)
    tile = texp.get_expansion(expansion).tile_args(ts, tfagp._idx_tensor(ts))
    tile = dataclasses.replace(tile, **{f: getattr(tile, f).to(cuda_device)
                                        for f in ("consts", "coef", "idx", "table")
                                        if getattr(tile, f) is not None})
    G, b = ops.bank_fused_fit_moments(Xb, yb, tile, mask)
    for s in range(B):
        Gs, bs = ops.fused_fit_moments(Xb[s], yb[s], tile, None, 1.0, mask[s], scale=False)
        assert torch.equal(G[s], Gs) and torch.equal(b[s], bs)


@pytest.mark.cuda
def test_cuda_bank_fit_and_update_launch_their_kernels(cuda_device):
    Xb, yb = _stack(6, 200, 2)
    ts = tfagp.GPSpec.create(8, np.full(2, 0.8, np.float32), 2.0, 0.05, backend="pallas",
                             device=cuda_device)
    ops.reset_launch_counts()
    bank = GPBank.fit(tt(Xb), tt(yb), ts)
    before = _leaves(bank)
    rng = np.random.default_rng(4)
    up = bank.update([0, 2], tt(uniform(rng, (2, 4, 2))),
                     tt(rng.standard_normal((2, 4)).astype(np.float32)))
    counts = ops.launch_counts()
    assert counts["phi_gram"] == {"bank": 1}
    assert counts["chol_update"] == {"batched": 1}
    _assert_unchanged(bank, before)
    cpu = GPBank.fit(tt(Xb), tt(yb), dataclasses.replace(
        ts, **{f: getattr(ts, f).cpu() for f in ("eps", "rho", "noise")}))
    Xq, ten = _queries(6, 2, 16)
    np.testing.assert_allclose(nn(bank.mean_var(ten, tt(Xq))[0]),
                               nn(cpu.mean_var(ten, tt(Xq))[0]), rtol=1e-3, atol=1e-4)
    assert up.capacity == 6


@pytest.mark.cuda
def test_cuda_bank_update_of_one_tenant_takes_the_cooperative_sweep(cuda_device):
    """One tenant is a batch of one system: the cooperative sweep, once,
    within the chol gate of the CPU bank's update."""
    Xb, yb = _stack(6, 200, 2)
    ts = tfagp.GPSpec.create(8, np.full(2, 0.8, np.float32), 2.0, 0.05, backend="pallas",
                             device=cuda_device)
    bank = GPBank.fit(tt(Xb), tt(yb), ts)
    cpu = GPBank.fit(tt(Xb), tt(yb), dataclasses.replace(
        ts, **{f: getattr(ts, f).cpu() for f in ("eps", "rho", "noise")}))
    rng = np.random.default_rng(5)
    Xk, yk = uniform(rng, (1, 4, 2)), rng.standard_normal((1, 4)).astype(np.float32)
    ops.reset_launch_counts()
    up = bank.update([3], tt(Xk), tt(yk))
    assert ops.launch_counts()["chol_update"] == {"": 1}
    # tests/test_streaming_fit.py:214 gate for chol: rtol 5e-3, atol 1e-3
    np.testing.assert_allclose(nn(up.stack.chol[3]), nn(cpu.update([3], tt(Xk), tt(yk)).stack.chol[3]),
                               rtol=5e-3, atol=1e-3)
    assert torch.equal(up.stack.chol[0], bank.stack.chol[0])


def _card_factors(G, M, K, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    R = torch.randn(G, M, M, generator=gen, device=device)
    L = torch.linalg.cholesky(torch.eye(M, device=device) + R @ R.mT / M)
    return L, torch.randn(G, K, M, generator=gen, device=device) * 0.3


def _assert_binv_independent_of_batch(L):
    """A slot's B^-1 refreshed alone or with a few others (a carried cache)
    is bitwise the same slot inverted with the whole stack (a fresh
    cache)."""
    full = tfagp._bank_binv(L)
    C = L.shape[0]
    for sl in ([1, 3], [2], [5, 6, 7], [0, C - 1], list(range(1, C))):
        assert torch.equal(tfagp._bank_binv(L[sl]), full[sl]), sl
        idx = torch.tensor(sl, device=L.device)
        assert torch.equal(tfagp._bank_binv(L, idx), full[sl]), sl
    assert torch.equal(tfagp._bank_binv(L, slice(4, 5))[0], full[4])


# M = 25 (the bank tests' n = 5, p = 2), 32 (no padding), 125
@pytest.mark.parametrize("M", [25, 32, 125])
def test_binv_of_a_few_slots_is_bitwise_the_whole_stacks(M):
    _assert_binv_independent_of_batch(_card_factors(12, M, 1, M, "cpu")[0])


# on the card, at the bank tests' M = 25 and the fleet's 625
@pytest.mark.cuda
@pytest.mark.parametrize("M", [25, 625])
def test_cuda_binv_of_a_few_slots_is_bitwise_the_whole_stacks(cuda_device, M):
    _assert_binv_independent_of_batch(_card_factors(64, M, 1, M, cuda_device)[0])


@pytest.mark.cuda
def test_cuda_incremental_binv_carry_matches_fresh_cache(cuda_device):
    """test_incremental_binv_carry_matches_fresh_cache on the card, through
    the kernel path: the carried cache answers bitwise like a fresh one."""
    Xb, yb = _stack(5, 16, 2)
    ts = tfagp.GPSpec.create(5, np.full(2, 0.8, np.float32), 2.0, 0.05, backend="pallas",
                             device=cuda_device)
    bank = GPBank.fit(tt(Xb), tt(yb), ts, capacity=6)
    Xq, ten = _queries(5, 2, 6)
    bank.mean_var(ten, tt(Xq))
    rng = np.random.default_rng(8)
    Xk, yk = tt(uniform(rng, (2, 4, 2))), tt(rng.standard_normal((2, 4)).astype(np.float32))
    Xn, yn = map(tt, gp_data(16, 2, 70))

    def mutate(b):
        return b.update([1, 3], Xk, yk).evict(0).insert("n", (Xn, yn))

    carried = mutate(bank)
    assert "_binv_cache" in carried.__dict__
    fresh = mutate(GPBank.from_states(bank.states(), capacity=6))
    assert "_binv_cache" not in fresh.__dict__
    assert torch.equal(carried._binv, fresh._binv)
    q = ["n", 1, 3, 2, "n", 4]
    m1, v1 = carried.mean_var(q, tt(Xq))
    m2, v2 = fresh.mean_var(q, tt(Xq))
    assert torch.equal(m1, m2) and torch.equal(v1, v2)


def _assert_batched_sweep(L, W):
    """One launch of the batched sweep: bitwise the cooperative kernel
    system by system (the same rotations, rounded alike), lower-triangular,
    within the chol gate of the plain sweep; its inputs untouched."""
    L0, W0 = L.clone(), W.clone()
    ops.reset_launch_counts()
    got = ops.chol_update(L, W)
    assert ops.launch_counts()["chol_update"] == {"batched": 1}
    assert torch.equal(L, L0) and torch.equal(W, W0)
    for g in range(L.shape[0]):
        assert torch.equal(got[g], ops.chol_update(L[g], W[g]))
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))
    # tests/test_streaming_fit.py:214 gate for chol: rtol 5e-3, atol 1e-3
    np.testing.assert_allclose(nn(got), nn(tchol.chol_update_plain(L, W)), rtol=5e-3, atol=1e-3)


# the batched sweep at its edges: one row group or several, M on both
# sides of a 32-column panel (and the fleet's 625), K = 1, K on both sides
# of the apply's 8-update chunks, K = 64; G = 512 fills the card
@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 16, 17, 64])
@pytest.mark.parametrize("M", [1, 31, 32, 33, 625, 640])
@pytest.mark.parametrize("G", [2, 3, 512])
def test_cuda_batched_sweep_is_bitwise_the_cooperative_sweep(cuda_device, G, M, K):
    _assert_batched_sweep(*_card_factors(G, M, K, G + M + K, cuda_device))


# where W does not fit in shared memory at once: in chunks of K (and the
# chunk itself in global scratch), each element still updated in order
@pytest.mark.cuda
def test_cuda_batched_sweep_in_chunks_of_w(cuda_device):
    plan = tchol.chol_update_batch_plan(96, 600)
    assert plan["w_chunk"] < 600
    _assert_batched_sweep(*_card_factors(2, 96, 600, 7, cuda_device))


@pytest.mark.cuda
def test_cuda_batched_sweep_plan(cuda_device):
    # the fleet's shape: W (16 x 20 row groups of 32) and one panel's
    # rotations (16 x 32 float4) in shared memory, with the factoring warps'
    # pivots (32 float4), hand-off (2 x 32) and counters (4)
    plan = tchol.chol_update_batch_plan(625, 16)
    assert {k: v for k, v in plan.items() if k != "resident_blocks_per_sm"} == {
        "threads": 96, "w_chunk": 16, "w_in_shared": 1,
        "smem_bytes": 16 * (16 * 32 + 32) + 4 * (20 * 16 * 32 + 2 * 32 + 4),
        "scratch_floats": 2 * 16 * 32 * 4}
    assert plan["resident_blocks_per_sm"] >= 1
    # W past shared memory at any chunk: kept in global scratch
    big = tchol.chol_update_batch_plan(8192, 200)
    assert big["w_in_shared"] == 0 and big["scratch_floats"] == (8 + 256) * 200 * 32


# the C entry repro_chol_update keeps its contract for a batch: in place
# on column-major factors, the bits of the wrapper's out-of-place launch
@pytest.mark.cuda
def test_cuda_chol_update_entry_sweeps_a_batch_in_place(cuda_device):
    L, W = _card_factors(3, 100, 8, 5, cuda_device)
    work = L.mT.contiguous().clone()
    scratch = torch.empty((3 * tchol.chol_update_batch_plan(100, 8)["scratch_floats"],),
                          device=cuda_device)
    rc = tchol._lib().repro_chol_update(work.data_ptr(), W.data_ptr(), 3, 100, 8,
                                        scratch.data_ptr(),
                                        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    assert torch.equal(work.mT, ops.chol_update(L, W))
