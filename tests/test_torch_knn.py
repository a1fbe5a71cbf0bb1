"""The port's blocked k-NN search (``repro_torch/kernels/knn.py``) against
the JAX package's (``repro/kernels/knn.py``) and against a dense numpy
oracle, on the CPU, at the sizes of tests/test_vecchia.py.

Distances are held at that test's gate (rtol 1e-4, atol 1e-5).  Index sets
are compared only on rows whose boundary is clear: where the k-th and the
(k+1)-th oracle distances differ by more than twice that gate, since
q^2 + t^2 - 2 q.t rounds differently in each package and a near-tie at
the boundary may resolve either way.  The memory claim is pinned as in
tests/test_vecchia.py: no operator of a search outputs a tensor with two
axes both data-sized.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_common import nn, tt  # noqa: E402
from test_torch_hyperopt import _Numels  # noqa: E402

from repro.data.gp_synthetic import make_clustered_dataset as jclustered  # noqa: E402
from repro.kernels import knn as jknn  # noqa: E402
from repro_torch.data import make_clustered_dataset  # noqa: E402
from repro_torch.kernels import knn  # noqa: E402

DIST = dict(rtol=1e-4, atol=1e-5)           # tests/test_vecchia.py:74


def _points(N, p=2, seed=0, lo=-2.0, hi=2.0):
    """tests/test_vecchia.py:_points, as numpy."""
    return np.random.default_rng(seed).uniform(lo, hi, (N, p)).astype(np.float32)


def _dense(Xq, Xt):
    return np.sum((Xq[:, None, :] - Xt[None, :, :]) ** 2, axis=-1)


def _clear(Drow, k):
    """True when the k-th and (k+1)-th smallest distances of a row are
    further apart than the distance gate allows either package to move."""
    s = np.sort(Drow)
    if k >= s.size:
        return True
    return s[k] - s[k - 1] > 2 * (DIST["atol"] + DIST["rtol"] * s[k])


@pytest.mark.parametrize("k,block_q,block_t", [
    (1, 128, 512), (7, 16, 32), (16, 33, 17), (40, 128, 512),
])
def test_knn_matches_dense_oracle_and_jax(k, block_q, block_t):
    """tests/test_vecchia.py:56-79: the distances equal the O(Q x N)
    oracle's and the JAX package's at the gate, ascending, and the index
    sets equal both on every row with a clear boundary."""
    Xq, Xt = _points(57, seed=1), _points(143, seed=2)
    d, i = knn.knn_search(tt(Xq), tt(Xt), k, block_q=block_q, block_t=block_t)
    jd, ji = jknn.knn_search(jnp.asarray(Xq), jnp.asarray(Xt), k, block_q=block_q,
                             block_t=block_t)
    D = _dense(Xq, Xt)
    got_d, got_i, jd, ji = nn(d), nn(i), np.asarray(jd), np.asarray(ji)
    assert got_d.shape == got_i.shape == (57, k) and i.dtype == torch.int64
    clear = 0
    for r in range(57):
        np.testing.assert_allclose(got_d[r], np.sort(D[r])[:k], **DIST)
        np.testing.assert_allclose(got_d[r], jd[r], **DIST)
        if _clear(D[r], k):
            clear += 1
            ref = set(np.argsort(D[r], kind="stable")[:k])
            assert set(got_i[r]) == ref == set(ji[r]), f"row {r}"
    assert np.all(np.diff(got_d, axis=1) >= 0)
    print(f"k={k}: index sets compared on {clear} of 57 rows")
    assert clear >= 50


def test_k_equals_n():
    Xq, Xt = _points(20, seed=3), _points(12, seed=4)
    _, i = knn.knn_search(tt(Xq), tt(Xt), 12, block_t=5)
    for r in range(20):
        assert set(nn(i)[r]) == set(range(12))


def test_bad_k_raises():
    X = tt(_points(10))
    with pytest.raises(ValueError, match="1 <= k <= N"):
        knn.knn_search(X, X, 0)
    with pytest.raises(ValueError, match="1 <= k <= N"):
        knn.knn_search(X, X, 11)
    with pytest.raises(ValueError, match="1 <= k <= N"):
        knn.ordered_topk(X, 11)


@pytest.mark.parametrize("block_q,block_t", [(128, 512), (13, 7)])
def test_ordered_topk_matches_oracle_and_jax(block_q, block_t):
    """tests/test_vecchia.py:89-108: row i conditions on the nearest among
    j < i only, with exactly min(i, k) valid slots; masked slots are
    clamped in bounds (to 0, as in the JAX package); the valid sets equal
    the oracle's and the JAX package's on rows with a clear boundary."""
    X = _points(71, seed=5)
    k = 9
    idx, mask = knn.ordered_topk(tt(X), k, block_q=block_q, block_t=block_t)
    jidx, jmask = jknn.ordered_topk(jnp.asarray(X), k, block_q=block_q, block_t=block_t)
    D = _dense(X, X)
    idx_n, mask_n = nn(idx), nn(mask)
    assert mask.dtype == torch.float32
    np.testing.assert_array_equal(mask_n, np.asarray(jmask))
    for r in range(71):
        assert int(mask_n[r].sum()) == min(r, k), f"row {r}"
        assert np.all(idx_n[r][mask_n[r] == 0] == 0)
        assert np.all(idx_n[r] >= 0) and np.all(idx_n[r] < 71)
        if r and _clear(D[r, :r], k):
            valid = set(idx_n[r][mask_n[r] > 0])
            assert valid == set(np.argsort(D[r, :r], kind="stable")[:k]), f"row {r}"
            assert valid == set(np.asarray(jidx)[r][np.asarray(jmask)[r] > 0]), f"row {r}"


def test_sq_dists_matches_jax():
    Xq, Xt = _points(40, p=3, seed=6), _points(30, p=3, seed=7)
    np.testing.assert_allclose(nn(knn.sq_dists(tt(Xq), tt(Xt))),
                               np.asarray(jknn.sq_dists(jnp.asarray(Xq), jnp.asarray(Xt))),
                               **DIST)
    np.testing.assert_allclose(nn(knn.sq_dists(tt(Xq), tt(Xt))), _dense(Xq, Xt), **DIST)


@pytest.mark.parametrize("candidates", [1 << 24, 64])
def test_a_rows_result_does_not_depend_on_its_pass(monkeypatch, candidates):
    """The rows taken together against a training block (all 400 here, or
    one 16-row block at a time when the tile budget is cut to 64 floats)
    change no bit of any row's result, distances and indices, ordered or
    not, with duplicate points making exact ties: of a tied pair the lower
    index comes first, and the k-th slot (k odd) keeps the lower one."""
    Xq, Xt = _points(400, seed=8), _points(300, seed=9)
    Xt[150:] = Xt[:150]                         # every distance tied twice
    want = knn.knn_search(tt(Xq[:16]), tt(Xt), 11, block_q=16, block_t=64)
    want_o = knn.ordered_topk(tt(Xt), 11, block_q=16, block_t=64)
    monkeypatch.setattr(knn, "_CANDIDATES", candidates)
    got = knn.knn_search(tt(Xq), tt(Xt), 11, block_q=16, block_t=64)
    got_o = knn.ordered_topk(tt(Xt), 11, block_q=16, block_t=64)
    for a, b in zip(got, want):
        assert torch.equal(a[:16], b)
    for a, b in zip(got_o, want_o):
        assert torch.equal(a, b)
    i = nn(got[1])
    assert np.all(i[:, 0::2] < 150) and np.all(i[:, 1::2] == i[:, 0:-1:2] + 150)


N_SWEEP, Q_SWEEP, K_SWEEP, LIMIT = 600, 400, 8, 256   # tests/test_vecchia.py:114


def big_intermediate(fn, *args):
    """The first operator output with two axes both >= LIMIT, or None
    (recorded by tests/test_torch_hyperopt.py's dispatch-mode recorder)."""
    with _Numels() as rec:
        fn(*args)
    for _, func, shape in rec.numels:
        if sum(s >= LIMIT for s in shape) >= 2:
            return shape, func
    return None


def test_knn_search_streams():
    Xq, Xt = tt(_points(Q_SWEEP, seed=0)), tt(_points(N_SWEEP, seed=1))
    hit = big_intermediate(lambda a, b: knn.knn_search(a, b, K_SWEEP, block_q=128,
                                                       block_t=128), Xq, Xt)
    assert hit is None, hit
    hit = big_intermediate(lambda a: knn.ordered_topk(a, K_SWEEP, block_q=128, block_t=128), Xt)
    assert hit is None, hit


def test_sweep_catches_a_dense_search():
    """The recorder itself: a search through the full Q x N matrix trips it."""
    Xq, Xt = tt(_points(Q_SWEEP, seed=0)), tt(_points(N_SWEEP, seed=1))
    hit = big_intermediate(
        lambda a, b: torch.argsort(knn.sq_dists(a, b), dim=1)[:, :K_SWEEP], Xq, Xt)
    assert hit is not None and hit[0] == (Q_SWEEP, N_SWEEP)


def test_clustered_dataset_is_the_references():
    """tests/test_vecchia.py:239-247, and the same draws as the JAX
    package's generator, bit for bit, as float32 tensors on the device."""
    X, y, Xs, ys = make_clustered_dataset(300, seed=1, device="cpu")
    assert X.shape == (300, 2) and y.shape == (300,)
    assert Xs.shape == (30, 2) and ys.shape == (30,)
    assert X.dtype == torch.float32 and X.device.type == "cpu"
    kw = dict(extent=6.0, length_scale=0.15, noise=0.02, n_bumps=120, seed=0)
    for got, want in zip(make_clustered_dataset(500, device="cpu", **kw),
                         jclustered(500, **kw)):
        np.testing.assert_array_equal(nn(got), np.asarray(want))
    X2, *_ = make_clustered_dataset(300, seed=1, device="cpu")
    assert torch.equal(X, X2)
