"""Port parity for each kernel module: the plain PyTorch version (what a
CPU tensor runs) against the JAX kernel in interpret mode and against the
oracles; plus the build helper's refusal and the card-only checks (marked
``cuda``, skipped without a card)."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_common import nn, specs, tt, uniform  # noqa: E402

from repro.core import fagp as jfagp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import expansions as texp  # noqa: E402
from repro_torch.core.fagp import _idx_tensor  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import chol_update as tchol  # noqa: E402
from repro_torch.kernels import diag_quad as tdq  # noqa: E402
from repro_torch.kernels import hermite_phi as thp  # noqa: E402
from repro_torch.kernels import phi_gram as tgram  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


def _tiles(expansion, p, n, R):
    """(JAX consts, table, tile_fn, n_max) and the port's TileArgs for the
    same spec."""
    js, ts = specs(expansion, p, n=n, num_features=R)
    jexp = jfagp.get_expansion(expansion)
    idx_np = js.indices()
    aux = jexp.pallas_prepare(idx_np, js)
    jt = (jexp.tile_consts(js), jexp.tile_table(aux, js), jexp.tile_fn(), js.n)
    tile = texp.get_expansion(expansion).tile_args(ts, _idx_tensor(ts))
    return js, ts, jt, tile


# (expansion, N, p, n, R): ragged N everywhere; R = 40 -> M = 80 is padded
# to a 128-column block by the JAX wrapper (padded RFF columns are cos(0))
CASES = [
    ("hermite", 100, 2, 6, None),
    ("hermite", 77, 3, 5, None),
    ("rff_se", 130, 2, 1, 40),
    ("rff_matern52", 61, 3, 1, 24),
]


@pytest.mark.parametrize("expansion,N,p,n,R", CASES)
def test_features_match_jax_kernel(expansion, N, p, n, R):
    js, ts, (c, table, fn, n_max), tile = _tiles(expansion, p, n, R)
    X = uniform(np.random.default_rng(N), (N, p), -1.5, 1.5)
    want = jops.expansion_phi(jnp.asarray(X), c, table, n_max=n_max, tile_fn=fn)
    got = ops.expansion_phi(tt(X), tile)
    assert got.shape == (N, tile.M)
    # tests/test_kernels.py:48 gate: rtol 4e-5 * max(4, n_max)
    np.testing.assert_allclose(nn(got), nn(want), rtol=4e-5 * max(4, n_max), atol=1e-5)


def test_hermite_features_match_one_hot_oracle():
    js, ts, _, tile = _tiles("hermite", 3, 5, None)
    X = uniform(np.random.default_rng(5), (45, 3), -2.0, 2.0)
    S = tt(tref.one_hot_selection(js.indices(), 5))
    want = tref.ref_phi(tt(X).T.contiguous(), tile.consts, S, 5)
    np.testing.assert_allclose(nn(ops.expansion_phi(tt(X), tile)), nn(want),
                               rtol=4e-5 * 5, atol=1e-5)


def _fit_inputs(N, p, seed):
    rng = np.random.default_rng(seed)
    X = uniform(rng, (N, p), -1.5, 1.5)
    y = rng.standard_normal(N).astype(np.float32)
    return X, y


@pytest.mark.parametrize("expansion,N,p,n,R", CASES)
@pytest.mark.parametrize("scale", [True, False])
def test_fused_fit_matches_jax_kernel(expansion, N, p, n, R, scale):
    js, ts, (c, table, fn, n_max), tile = _tiles(expansion, p, n, R)
    X, y = _fit_inputs(N, p, N + int(scale))
    d = np.geomspace(1.0, 1e-3, tile.M).astype(np.float32)
    sig2 = 0.01 if scale else 1.0
    mask = None if scale else (np.arange(N) % 5 != 2).astype(np.float32)
    jB, jb = jops.fused_fit_moments(
        jnp.asarray(X), jnp.asarray(y), c, table, jnp.asarray(d), jnp.float32(sig2),
        None if mask is None else jnp.asarray(mask), n_max=n_max, scale=scale,
        tile_fn=fn)
    B, b = ops.fused_fit_moments(tt(X), tt(y), tile, tt(d), sig2,
                                 None if mask is None else tt(mask), scale=scale)
    # tests/test_streaming_fit.py:55 gate: 1e-3 on B and b
    np.testing.assert_allclose(nn(B), nn(jB), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(nn(b), nn(jb), rtol=1e-3, atol=1e-3)


def _sliced_tiles(M):
    """A Hermite tile cut to its first M columns (p = 4, n = 5: 625
    columns), in both packages: (JAX consts, table, tile_fn, n_max) and the
    port's TileArgs."""
    js, ts, (c, _, fn, n_max), tile = _tiles("hermite", 4, 5, None)
    idx_np = js.indices()[:M]
    table = jfagp.get_expansion("hermite").pallas_prepare(idx_np, js)
    return (c, table, fn, n_max), dataclasses.replace(tile, M=M, idx=tile.idx[:M].contiguous())


def _gram64(X, y, mask, jtile, d, sig2, scale):
    """(B or G, b) in float64 from the JAX kernel's float32 features of X,
    summed in numpy: a reference that owes nothing to the port."""
    c, table, fn, n_max = jtile
    Phi = np.asarray(jops.expansion_phi(jnp.asarray(X), c, table, n_max=n_max, tile_fn=fn),
                     np.float64)
    m = np.ones(X.shape[0]) if mask is None else mask.astype(np.float64)
    Phi = Phi * m[:, None]
    G = Phi.T @ Phi
    if scale:
        dd = d.astype(np.float64)
        G = np.eye(G.shape[0]) + dd[:, None] * G * dd[None, :] / sig2
    return G, Phi.T @ (y.astype(np.float64) * m)


def _gates(got, want, rtol=1e-3, atol=1e-3):
    """The largest |got - want| in units of the gate (<= 1 passes)."""
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


# the CUDA kernel's 128-column tile edges, N not a multiple of its 32-row
# step; the plain version the CPU runs against the JAX kernel
@pytest.mark.parametrize("M", [127, 129, 257])
@pytest.mark.parametrize("scale", [True, False])
def test_fused_fit_matches_jax_kernel_at_tile_edges(M, scale):
    """The port's float32 moments against float64 moments summed in numpy
    from the JAX kernel's features (interpret mode), at
    tests/test_streaming_fit.py:55's gate (1e-3 on B and b): a reference
    that owes nothing to the port, so a wrong feature or a dropped column
    at a tile edge fails here.  The two packages' float32 moments are
    printed beside it, each one's distance from that reference and their
    distance from each other: two float32 sums in different orders sit up
    to the sum of their own distances apart (on some CPUs 1.16 gates at
    the masked M = 257, both within 0.76 of the reference)."""
    jtile, tile = _sliced_tiles(M)
    c, table, fn, n_max = jtile
    N = 301
    X, y = _fit_inputs(N, 4, M + int(scale))
    d = np.geomspace(1.0, 1e-3, M).astype(np.float32)
    sig2 = 0.01 if scale else 1.0
    mask = None if scale else (np.arange(N) % 7 != 3).astype(np.float32)
    jB, jb = jops.fused_fit_moments(
        jnp.asarray(X), jnp.asarray(y), c, table, jnp.asarray(d), jnp.float32(sig2),
        None if mask is None else jnp.asarray(mask), n_max=n_max, scale=scale,
        tile_fn=fn)
    B, b = ops.fused_fit_moments(tt(X), tt(y), tile, tt(d), sig2,
                                 None if mask is None else tt(mask), scale=scale)
    assert B.shape == (M, M) and b.shape == (M,)
    B64, b64 = _gram64(X, y, mask, jtile, d, sig2, scale)
    print(f"M={M}: gates from float64: port {max(_gates(nn(B), B64), _gates(nn(b), b64)):.3f}, "
          f"JAX {max(_gates(nn(jB), B64), _gates(nn(jb), b64)):.3f}; port from JAX "
          f"{max(_gates(nn(B), nn(jB)), _gates(nn(b), nn(jb))):.3f}")
    np.testing.assert_allclose(nn(B), B64, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(nn(b), b64, rtol=1e-3, atol=1e-3)


def test_fused_fit_matches_materialized_oracle():
    js, ts, _, tile = _tiles("hermite", 2, 6, None)
    X, y = _fit_inputs(150, 2, 9)
    d = np.geomspace(1.0, 1e-4, tile.M).astype(np.float32)
    S = tt(tref.one_hot_selection(js.indices(), 6))
    Be, be = tref.ref_fused_fit_moments(tt(X), tt(y), tile.consts, S, tt(d), 0.01, 6)
    B, b = ops.fused_fit_moments(tt(X), tt(y), tile, tt(d), 0.01)
    np.testing.assert_allclose(nn(B), nn(Be), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(nn(b), nn(be), rtol=1e-3, atol=1e-3)


def test_fused_fit_mask_excludes_rows():
    """Masked call == the kept subset (Hermite phi(0) != 0, so a masked row
    must be dropped from both G and b, not zeroed in X)."""
    _, _, _, tile = _tiles("hermite", 3, 4, None)
    X, y = _fit_inputs(90, 3, 4)
    keep = np.random.default_rng(0).uniform(size=90) > 0.3
    G, b = ops.fused_fit_moments(tt(X), tt(y), tile, None, 1.0,
                                 tt(keep.astype(np.float32)), scale=False)
    Gk, bk = ops.fused_fit_moments(tt(X[keep]), tt(y[keep]), tile, None, 1.0,
                                   scale=False)
    np.testing.assert_allclose(nn(G), nn(Gk), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(nn(b), nn(bk), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("N,M", [(7, 12), (100, 125), (64, 216)])
def test_diag_quad_matches_jax_kernel(N, M):
    rng = np.random.default_rng(M)
    A = rng.standard_normal((N, M)).astype(np.float32)
    R = rng.standard_normal((M, M)).astype(np.float32)
    C = (R @ R.T / M + np.eye(M)).astype(np.float32)
    want = jops.diag_quad(jnp.asarray(A), jnp.asarray(C))
    got = ops.diag_quad(tt(A), tt(C))
    # tests/test_kernels.py:168 gate for variances: rtol 2e-3, atol 1e-5
    np.testing.assert_allclose(nn(got), nn(want), rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(nn(got), nn(jref.ref_diag_quad(jnp.asarray(A), jnp.asarray(C))),
                               rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(nn(got), nn(tref.ref_diag_quad(tt(A), tt(C))),
                               rtol=2e-3, atol=1e-5)


def _spd_factor(M, seed):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((M, M)).astype(np.float32)
    B = (np.eye(M) + R @ R.T / M).astype(np.float32)
    return np.linalg.cholesky(B).astype(np.float32)


@pytest.mark.parametrize("M,K", [(16, 1), (125, 8), (40, 5)])
def test_chol_update_matches_jax_sweep(M, K):
    L = _spd_factor(M, M)
    W = np.random.default_rng(K).standard_normal((K, M)).astype(np.float32)
    Lj = jnp.asarray(L)
    for w in W:
        Lj = jax.jit(jfagp._chol_rank1_update)(Lj, jnp.asarray(w))
    got = ops.chol_update(tt(L), tt(W))
    # tests/test_streaming_fit.py:214 gate for chol: rtol 5e-3, atol 1e-3
    np.testing.assert_allclose(nn(got), nn(Lj), rtol=5e-3, atol=1e-3)
    ref = np.linalg.cholesky(L.astype(np.float64) @ L.T + W.T.astype(np.float64) @ W)
    np.testing.assert_allclose(nn(got), ref, rtol=5e-3, atol=1e-3)
    assert np.all(np.triu(nn(got), 1) == 0.0)


def test_diag_quad_reads_a_column_major_c_as_its_transpose():
    """diag(A C A^T) = diag(A C^T A^T): a column-major C (B^-1 from
    torch.cholesky_inverse) is read through its transpose, not copied."""
    rng = np.random.default_rng(5)
    A, C = tt(rng.standard_normal((9, 20))), tt(rng.standard_normal((20, 20)))
    Ccm = C.T.contiguous().T
    assert not Ccm.is_contiguous() and torch.equal(Ccm, C)
    # tests/test_kernels.py:168 variance gate
    np.testing.assert_allclose(nn(ops.diag_quad(A, Ccm)), nn(tdq.diag_quad_plain(A, C)),
                               rtol=2e-3, atol=1e-5)


def test_chol_update_leaves_inputs_untouched():
    L, W = tt(_spd_factor(12, 1)), torch.randn(2, 12)
    L0, W0 = L.clone(), W.clone()
    tchol.chol_update_plain(L, W)
    assert torch.equal(L, L0) and torch.equal(W, W0)


def test_chol_update_takes_any_layout_of_l_and_a_batch_of_one():
    """A column-major L (torch.linalg.cholesky's layout) gives the row-major
    call's factor, and a batch of one system the 2-D call's; neither input
    is written."""
    L, W = tt(_spd_factor(24, 3)), torch.randn(2, 24, generator=torch.Generator().manual_seed(3))
    Lcm = L.T.contiguous().T
    assert not Lcm.is_contiguous() and torch.equal(Lcm, L)
    want = ops.chol_update(L, W)
    assert torch.equal(ops.chol_update(Lcm, W), want)
    assert torch.equal(ops.chol_update(L[None], W[None])[0], want)
    assert torch.equal(Lcm, L) and torch.equal(L, tt(_spd_factor(24, 3)))
    with pytest.raises(ValueError, match="float64"):
        ops.chol_update(L.double(), W)


def test_cpu_path_launches_nothing():
    ops.reset_launch_counts()
    _, _, _, tile = _tiles("hermite", 2, 4, None)
    X, y = _fit_inputs(20, 2, 1)
    ops.expansion_phi(tt(X), tile)
    ops.fused_fit_moments(tt(X), tt(y), tile, None, 1.0, scale=False)
    ops.diag_quad(torch.ones(3, 4), torch.eye(4))
    ops.chol_update(torch.eye(8), torch.ones(1, 8))
    assert all(not v for v in ops.launch_counts().values())


def test_wrappers_validate_inputs():
    with pytest.raises(TypeError, match="float32"):
        ops.diag_quad(torch.ones(3, 4, dtype=torch.float64), torch.eye(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="shapes"):
        ops.diag_quad(torch.ones(3, 4), torch.eye(5))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.diag_quad(torch.ones(3, 4, device="meta"), torch.eye(4, device="meta"))
    with pytest.raises(ValueError, match="shapes"):
        ops.chol_update(torch.eye(4), torch.ones(2, 5))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc -> a clear KernelBuildError, never a stand-in library."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "_DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "_LIBS", {})
    assert _build.find_nvcc() is None
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.library("diag_quad")
    assert _build._LIBS == {}


def test_build_dir_is_the_checkouts(monkeypatch, tmp_path):
    """Kernels build under the checkout's build/; a copy installed outside
    a checkout's src/ raises instead of building beside site-packages."""
    root = Path(_build.__file__).resolve().parents[3]
    assert _build.build_dir() == root / "build" / "repro_torch_kernels"
    fake = tmp_path / "site-packages" / "repro_torch" / "kernels" / "_build.py"
    monkeypatch.setattr(_build, "__file__", str(fake))
    with pytest.raises(_build.KernelBuildError, match="not from a checkout"):
        _build.build_dir()


def test_kernel_sources_present():
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    for name in _build.HEADERS:
        assert (_build.CSRC / name).is_file()


def test_ablation_variants_edit_the_current_sources():
    """benchmarks/torch_phi_gram_ablation.py builds its variants by
    replacing statements of the kernel sources or of their copy of
    expansion.cuh: each statement it replaces is still in one of them."""
    path = Path(__file__).resolve().parents[1] / "benchmarks" / "torch_phi_gram_ablation.py"
    spec = importlib.util.spec_from_file_location("torch_phi_gram_ablation", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, (source, edits) in mod.VARIANTS.items():
        assert source in _build.SOURCES, name
        texts = [(_build.CSRC / f).read_text() for f in (f"{source}.cu", "expansion.cuh")]
        for old, _ in edits:
            assert any(old in text for text in texts), (name, source, old)


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version (skipped here)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("expansion,N,p,n,R", CASES)
def test_cuda_features_and_fit_match_plain(cuda_device, expansion, N, p, n, R):
    _, _, _, tile = _tiles(expansion, p, n, R)
    tile = thp.TileArgs(**{f: (v.to(cuda_device) if isinstance(v, torch.Tensor) else v)
                           for f, v in vars(tile).items()})
    X, y = _fit_inputs(N, p, 3)
    Xc, yc = tt(X).to(cuda_device), tt(y).to(cuda_device)
    np.testing.assert_allclose(nn(ops.expansion_phi(Xc, tile)),
                               nn(thp.phi_features_plain(Xc, tile)),
                               rtol=4e-5 * max(4, n), atol=1e-5)
    mask = (torch.arange(N, device=cuda_device) % 3 != 0).float()
    d = torch.linspace(1.0, 0.01, tile.M, device=cuda_device)
    for scale in (True, False):
        B, b = ops.fused_fit_moments(Xc, yc, tile, d, 0.01, mask, scale=scale)
        Bp, bp = tgram.phi_gram_plain(Xc, yc, mask, tile,
                                      d if scale else torch.ones_like(d),
                                      0.01 if scale else 1.0, scale)
        np.testing.assert_allclose(nn(B), nn(Bp), rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(nn(b), nn(bp), rtol=1e-3, atol=1e-3)


def _on(tile, device):
    return thp.TileArgs(**{f: (v.to(device) if isinstance(v, torch.Tensor) else v)
                           for f, v in vars(tile).items()})


# the fused fit against the scaled Gram of the stored features, on both
# sides of its 128-column tile edge, for p = 9 (past the producers unrolled
# for p <= 8), for an RFF tile, and at the paths' shapes of the features
# kernel (N x M, p = 4: a phase-3 microbatch and update, a fleet microbatch
# and ingest round, phase 6's stored Phi, the RFF path's microbatch): both
# kernels sum every entry in the same 1,024-row strips, one fmaf per row
# from 0, and add the strips in row order, from bitwise the features of
# the features kernel, so B (scale=True) and the
# masked G (scale=False; the scaled Gram with d = 1, sigma^2 = 1 is G + I)
# are equal
PATH_SHAPES = {"128x14641": ("hermite", 128, 11), "64x14641": ("hermite", 64, 11),
               "256x625": ("hermite", 256, 5), "8192x625": ("hermite", 8192, 5),
               "10000x14641": ("hermite", 10_000, 11), "128x8192rff": ("rff_se", 128, 4096)}


@pytest.mark.cuda
@pytest.mark.parametrize("M", [125, 128, 129, 257, "p9", "rff", *PATH_SHAPES])
def test_cuda_fused_fit_is_bitwise_the_scaled_gram_of_its_features(cuda_device, M):
    N, p = 1037, {"rff": 3, "p9": 9}.get(M, 4)
    if M in PATH_SHAPES:
        expansion, N, nr = PATH_SHAPES[M]
        rff = expansion != "hermite"
        _, _, _, tile = _tiles(expansion, 4, 1 if rff else nr, nr if rff else None)
    elif M == "rff":
        _, _, _, tile = _tiles("rff_se", 3, 1, 100)
    elif M == "p9":
        _, _, _, tile = _tiles("hermite", 9, 2, None)
    else:
        _, tile = _sliced_tiles(M)
    tile = _on(tile, cuda_device)
    X, y = _fit_inputs(N, p, 11)
    Xc, yc = tt(X).to(cuda_device), tt(y).to(cuda_device)
    d = torch.linspace(1.0, 0.01, tile.M, device=cuda_device)
    mask = (torch.arange(N, device=cuda_device) % 3 != 0).float()
    Phi = ops.expansion_phi(Xc, tile)
    B, _ = ops.fused_fit_moments(Xc, yc, tile, d, 0.01)
    assert torch.equal(B, ops.scaled_gram(Phi, d, 0.01))
    assert torch.equal(B, B.T)
    G, _ = ops.fused_fit_moments(Xc, yc, tile, None, 1.0, mask, scale=False)
    ones = torch.ones(tile.M, device=cuda_device)
    assert torch.equal(G + torch.eye(tile.M, device=cuda_device),
                       ops.scaled_gram((Phi * mask[:, None]).contiguous(), ones, 1.0))
    assert torch.equal(G, G.T)


@pytest.mark.cuda
def test_cuda_phi_gram_plan(cuda_device):
    one = tgram.phi_gram_plan(1037, 257, 1, "hermite", 3, 7, cuda_device)
    # shared floats: feature ring 2 x 2 x 32 x 128, mask*y and mask
    # 2 x 2 x 32, column offsets 2 x p x 128, row tables 2 x p*n x 33
    assert one == {"tile": 128, "rows_per_step": 32, "stages": 2, "steps": 33,
                   "tile_rows": 3, "blocks_per_slot": 6, "blocks": 6,
                   "smem_bytes": 4 * (16384 + 128 + 2 * 3 * 128 + 2 * 21 * 33),
                   "resident_blocks_per_sm": 2, "strip_rows": 1024}
    bank = tgram.phi_gram_plan(10_000, 625, 512, "hermite", 4, 5, cuda_device)
    assert (bank["tile_rows"], bank["blocks_per_slot"], bank["blocks"], bank["steps"]) \
        == (5, 15, 7680, 313)
    rff = tgram.phi_gram_plan(10_000, 8192, 1, "rff", 4, 1, cuda_device)
    assert rff["smem_bytes"] == 4 * (16384 + 128 + 2 * 5 * 128 + 2 * 4 * 33)
    assert rff["blocks"] == 64 * 65 // 2
    with pytest.raises(RuntimeError, match="phi_gram"):
        tgram.phi_gram_plan(10, 0, 1, "hermite", 3, 7, cuda_device)


@pytest.mark.cuda
def test_cuda_diag_quad_and_chol_update_match_plain(cuda_device):
    A = torch.randn(77, 125, device=cuda_device)
    R = torch.randn(125, 125, device=cuda_device)
    C = R @ R.T / 125 + torch.eye(125, device=cuda_device)
    np.testing.assert_allclose(nn(ops.diag_quad(A, C)), nn(tdq.diag_quad_plain(A, C)),
                               rtol=2e-3, atol=1e-5)
    L = torch.linalg.cholesky(C)
    W = torch.randn(8, 125, device=cuda_device)
    np.testing.assert_allclose(nn(ops.chol_update(L, W)),
                               nn(tchol.chol_update_plain(L, W)), rtol=5e-3, atol=1e-3)


def _spd_factor_on(M, seed, device):
    gen = torch.Generator().manual_seed(seed)
    R = torch.randn(M, M, generator=gen)
    return torch.linalg.cholesky(torch.eye(M) + R @ R.T / M).to(device)


# sweep edge shapes: M below one 32-row panel, M not a multiple of 32,
# K = 1, and K large enough that W is swept in chunks
@pytest.mark.cuda
@pytest.mark.parametrize("M,K", [(20, 4), (1000, 16), (300, 1), (96, 400)])
def test_cuda_sweep_edge_shapes_match_plain_and_one_block(cuda_device, M, K):
    L = _spd_factor_on(M, M + K, cuda_device)
    W = (torch.randn(K, M, generator=torch.Generator().manual_seed(K)) * 0.3).to(cuda_device)
    L0, W0 = L.clone(), W.clone()
    got = ops.chol_update(L, W)
    # tests/test_streaming_fit.py:214 gate for chol: rtol 5e-3, atol 1e-3
    np.testing.assert_allclose(nn(got), nn(tchol.chol_update_plain(L, W)), rtol=5e-3, atol=1e-3)
    # the one-block kernel (a G = 2 batch) rounds every rotation alike
    assert torch.equal(got, ops.chol_update(torch.stack([L, L]), torch.stack([W, W]))[0])
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))
    assert torch.equal(L, L0) and torch.equal(W, W0)


# a batch of one system, L (1, M, M), takes the cooperative sweep: the
# 2-D call's bits, counted as one launch of it; L column-major or not
@pytest.mark.cuda
@pytest.mark.parametrize("M,K", [(20, 4), (125, 8), (1000, 16)])
def test_cuda_sweep_batch_of_one_matches_plain_and_2d_call(cuda_device, M, K):
    L = _spd_factor_on(M, M + K, cuda_device)
    W = (torch.randn(K, M, generator=torch.Generator().manual_seed(K)) * 0.3).to(cuda_device)
    ops.reset_launch_counts()
    got = ops.chol_update(L[None], W[None])
    assert ops.launch_counts()["chol_update"] == {"": 1}
    # tests/test_streaming_fit.py:214 gate for chol: rtol 5e-3, atol 1e-3
    np.testing.assert_allclose(nn(got[0]), nn(tchol.chol_update_plain(L, W)),
                               rtol=5e-3, atol=1e-3)
    assert torch.equal(got[0], ops.chol_update(L, W))
    assert torch.equal(got[0], ops.chol_update(L.T.contiguous().T, W))


# the same sweep where the plain version would take minutes: W in chunks
# at M = 4,096, and a grid with several row groups per block
@pytest.mark.cuda
@pytest.mark.parametrize("M,K", [(4096, 512), (8192, 200)])
def test_cuda_sweep_large_shapes_match_refactor_and_one_block(cuda_device, M, K):
    L = _spd_factor_on(M, M + K, cuda_device)
    W = (torch.randn(K, M, generator=torch.Generator().manual_seed(K)) * 0.3).to(cuda_device)
    plan = tchol.chol_update_plan(M, K)
    assert plan["blocks"] <= -(-M // 32) and plan["w_chunk"] <= K
    got = ops.chol_update(L, W)
    np.testing.assert_allclose(nn(got), nn(torch.linalg.cholesky(L @ L.T + W.T @ W)),
                               rtol=5e-3, atol=1e-3)
    assert torch.equal(got, ops.chol_update(torch.stack([L, L]), torch.stack([W, W]))[0])


# diag-quad at the serving shape (C symmetric, as B^-1), the RFF path's M,
# one query, two row tiles, and a C that is not symmetric, row-major or
# column-major (read as its transpose)
@pytest.mark.cuda
@pytest.mark.parametrize("N,M,symmetric,column_major", [
    (128, 14641, True, False), (128, 8192, False, False), (1, 14641, False, False),
    (200, 3001, False, False), (77, 125, False, False), (128, 3001, False, True)])
def test_cuda_diag_quad_shapes_match_plain(cuda_device, N, M, symmetric, column_major):
    gen = torch.Generator(device=cuda_device).manual_seed(N + M)
    A = torch.randn(N, M, generator=gen, device=cuda_device)
    R = torch.randn(M, M, generator=gen, device=cuda_device)
    C = R @ R.T / M + 1e-3 * torch.eye(M, device=cuda_device)
    if not symmetric:
        C = C + torch.randn(M, M, generator=gen, device=cuda_device) * (1e-3 / M ** 0.5)
        assert not torch.equal(C, C.T)
    if column_major:
        C = C.T.contiguous().T
        assert not C.is_contiguous()
    A0, C0 = A.clone(), C.clone()
    # tests/test_kernels.py:168 variance gate
    np.testing.assert_allclose(nn(ops.diag_quad(A, C)), nn(tdq.diag_quad_plain(A, C)),
                               rtol=2e-3, atol=1e-5)
    assert torch.equal(A, A0) and torch.equal(C, C0)
    plan = tdq.diag_quad_plan(N, M, cuda_device)
    assert plan["strips"] == -(-M // 128) and plan["S"] >= 1


# ---------------------------------------------------------------------------
# the downdate sweep, stacked (per-slot) tiles and per-row constants: CPU
# ---------------------------------------------------------------------------


def _absorbed(M, K, seed, scale=0.3):
    """(L, W) numpy: L the factor of I + R R^T / M + W^T W, so that the K
    rows of W can be downdated out of it."""
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((M, M))
    W = (rng.standard_normal((K, M)) * scale).astype(np.float32)
    B = np.eye(M) + R @ R.T / M + W.T.astype(np.float64) @ W
    return np.linalg.cholesky(B).astype(np.float32), W


@pytest.mark.parametrize("M,K", [(16, 1), (125, 8), (40, 5)])
def test_chol_downdate_matches_jax_sweep(M, K):
    """The plain downdate against the JAX package's hyperbolic sweep
    (repro/bank/bank.py::_chol_rank1_downdate, row after row) and against
    float64 chol(L L^T - W^T W), at the chol gate (tests/test_streaming_fit.py:214)."""
    from repro.bank.bank import _chol_rank1_downdate

    L, W = _absorbed(M, K, M + K)
    Lj, okj = jnp.asarray(L), True
    for w in W:
        Lj, o = jax.jit(_chol_rank1_downdate)(Lj, jnp.asarray(w))
        okj = okj and bool(o)
    got, ok = ops.chol_downdate(tt(L), tt(W))
    assert bool(ok) and okj
    np.testing.assert_allclose(nn(got), np.asarray(Lj), rtol=5e-3, atol=1e-3)
    ref = np.linalg.cholesky(L.astype(np.float64) @ L.T - W.T.astype(np.float64) @ W)
    np.testing.assert_allclose(nn(got), ref, rtol=5e-3, atol=1e-3)
    assert np.all(np.triu(nn(got), 1) == 0.0)


def test_chol_downdate_flags_a_lost_pivot_as_jax_does():
    """Rows never absorbed: a pivot is lost in both packages; a batch keeps
    one flag per system, and the good system's factor does not depend on
    its neighbour."""
    from repro.bank.bank import _downdate_arrays

    L, W = _absorbed(24, 3, 7)
    bogus = np.full((3, 24), 2.0, np.float32)
    Lb, Wb = np.stack([L, L]), np.stack([W, bogus])
    got, ok = ops.chol_downdate(tt(Lb), tt(Wb))
    assert ok.tolist() == [True, False]
    for g in range(2):
        _, _, _, okj = _downdate_arrays(jnp.asarray(Lb[g]), jnp.zeros(24), jnp.ones(24),
                                        jnp.float32(1.0), jnp.asarray(Wb[g]), jnp.zeros(3))
        assert bool(okj) == bool(ok[g])
    one, ok1 = ops.chol_downdate(tt(L), tt(W))
    assert bool(ok1) and torch.equal(got[0], one)
    # a zero row is an exact identity
    same, ok0 = ops.chol_downdate(tt(L), torch.zeros(2, 24))
    assert bool(ok0) and torch.equal(same, tt(L))


def test_chol_downdate_undoes_the_update_and_leaves_inputs_untouched():
    L = tt(_spd_factor(40, 2))
    W = torch.randn(6, 40, generator=torch.Generator().manual_seed(2)) * 0.5
    L0, W0 = L.clone(), W.clone()
    up = ops.chol_update(L, W)
    back, ok = ops.chol_downdate(up, W)
    assert bool(ok)
    np.testing.assert_allclose(nn(back), nn(L), rtol=5e-3, atol=1e-3)
    assert torch.equal(L, L0) and torch.equal(W, W0)
    with pytest.raises(ValueError, match="shapes"):
        ops.chol_downdate(torch.eye(4), torch.ones(2, 5))


def _stacked(expansion, p, n, R, C, seed=0):
    """A port spec, its index table and a stacked tile of C slots under
    distinct (eps, rho)."""
    _, ts = specs(expansion, p, n=n, num_features=R)
    rng = np.random.default_rng(seed)
    eps = tt(rng.uniform(0.4, 1.6, (C, p)))
    rho = tt(rng.uniform(1.5, 2.5, (C, p)))
    exp = texp.get_expansion(expansion)
    idx = _idx_tensor(ts)
    return ts, exp.slot_tile_args(ts, idx, eps, rho), eps, rho


@pytest.mark.parametrize("expansion", ["hermite", "rff_se"])
def test_stacked_tile_slots_are_their_specs_tiles(expansion):
    """Slot s of a stacked tile is the tile of the spec under (eps[s],
    rho[s]), bitwise; the bank's plain version takes each slot's own."""
    ts, tile, eps, rho = _stacked(expansion, 3, 4, 16, 5)
    exp = texp.get_expansion(expansion)
    assert tile.slots == 5
    for s in range(5):
        own = exp.tile_args(ts.replace(eps=eps[s], rho=rho[s]), _idx_tensor(ts))
        got = thp.slot_tile(tile, s)
        for f in ("consts", "table", "idx", "coef"):
            a, b = getattr(got, f), getattr(own, f)
            assert (a is None and b is None) or torch.equal(a, b), f
    X, y = _fit_inputs(37, 3, 2)
    Xb, yb = tt(np.stack([X] * 5)), tt(np.stack([y] * 5))
    G, b = ops.bank_fused_fit_moments(Xb, yb, tile)
    for s in (0, 3):
        Gs, bs = tgram.phi_gram_plain(Xb[s], yb[s], torch.ones(37), thp.slot_tile(tile, s),
                                      None, 1.0, False)
        assert torch.equal(G[s], Gs) and torch.equal(b[s], bs)


def test_per_row_constants_plain_version():
    """Row r of the per-row features is the shared version under slot
    slots[r]'s constants; with every slot's constants equal it is the
    shared features.  (Bitwise on the card, where elementwise kernels do
    not depend on the batch; here to 1 ulp-scale.)"""
    ts, tile, _, _ = _stacked("hermite", 3, 5, None, 4)
    X = tt(uniform(np.random.default_rng(4), (50, 3)))
    slots = torch.tensor(np.random.default_rng(5).integers(0, 4, 50), dtype=torch.int32)
    got = ops.expansion_phi(X, tile, slots)
    for s in range(4):
        rows = torch.nonzero(slots == s)[:, 0]
        want = thp.phi_features_plain(X[rows], thp.slot_tile(tile, s))
        np.testing.assert_allclose(nn(got[rows]), nn(want), rtol=1e-6, atol=1e-7)
    shared = texp.get_expansion("hermite").tile_args(ts, _idx_tensor(ts))
    same = dataclasses.replace(shared, consts=shared.consts.expand(4, 3, 3).contiguous())
    np.testing.assert_allclose(nn(ops.expansion_phi(X, same, slots)),
                               nn(ops.expansion_phi(X, shared)), rtol=1e-6, atol=1e-7)


def test_stacked_and_per_row_wrappers_validate():
    ts, tile, _, _ = _stacked("hermite", 2, 4, None, 3)
    X = torch.zeros(5, 2)
    with pytest.raises(ValueError, match="stacked tile"):
        ops.expansion_phi(X, tile)
    with pytest.raises(ValueError, match="int32"):
        ops.expansion_phi(X, tile, torch.zeros(5, dtype=torch.long))
    shared = thp.slot_tile(tile, 0)
    with pytest.raises(ValueError, match="stacked Hermite"):
        ops.expansion_phi(X, shared, torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="stacked tile"):
        ops.bank_fused_fit_moments(torch.zeros(2, 4, 2), torch.zeros(2, 4), tile)
    _, rtile, _, _ = _stacked("rff_se", 2, 1, 8, 3)
    with pytest.raises(ValueError, match="stacked Hermite"):
        ops.expansion_phi(X, rtile, torch.zeros(5, dtype=torch.int32))
    # the launch entry checks the same way, then refuses CPU tensors
    with pytest.raises(ValueError, match="on the CPU"):
        thp.phi_features_launch(X, tile, torch.empty(5, tile.M), torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="stacked tile"):
        thp.phi_features_launch(X, tile, torch.empty(5, tile.M))


# ---------------------------------------------------------------------------
# the downdate sweep, stacked tiles and per-row constants: on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("M,K", [(20, 4), (125, 8), (625, 16), (1000, 16), (96, 400)])
def test_cuda_chol_downdate_matches_plain_and_refactor(cuda_device, M, K):
    """The batched downdate kernel against its plain version and the
    batched refactor at the chol gate, on a G = 3 batch (W in chunks at
    K = 400); its inputs untouched, zeros above the diagonal, every ok."""
    Ls, Ws = zip(*(_absorbed(M, K, M + K + g, scale=0.3 if K < 100 else 0.05)
                   for g in range(3)))
    L, W = tt(np.stack(Ls)).to(cuda_device), tt(np.stack(Ws)).to(cuda_device)
    L0, W0 = L.clone(), W.clone()
    ops.reset_launch_counts()
    got, ok = ops.chol_downdate(L, W)
    assert ops.launch_counts()["chol_update"] == {"downdate": 1}
    assert bool(ok.all())
    want, okp = tchol.chol_downdate_plain(L, W)
    assert torch.equal(ok, okp)
    np.testing.assert_allclose(nn(got), nn(want), rtol=5e-3, atol=1e-3)
    np.testing.assert_allclose(nn(got), nn(torch.linalg.cholesky(L @ L.mT - W.mT @ W)),
                               rtol=5e-3, atol=1e-3)
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))
    assert torch.equal(L, L0) and torch.equal(W, W0)
    # a 2-D call is a batch of one, with the batch's bits
    one, ok1 = ops.chol_downdate(L[1], W[1])
    assert bool(ok1) and torch.equal(one, got[1])


@pytest.mark.cuda
def test_cuda_chol_downdate_lost_pivot_stays_in_its_system(cuda_device):
    """A system that loses a pivot reports it and corrupts nothing else:
    its neighbours' factors are bitwise those of a batch without it."""
    L, W = _absorbed(125, 8, 3)
    bogus = np.full((8, 125), 2.0, np.float32)
    Lb = tt(np.stack([L, L, L])).to(cuda_device)
    Wb = tt(np.stack([W, bogus, W * 0.5])).to(cuda_device)
    got, ok = ops.chol_downdate(Lb, Wb)
    assert ok.tolist() == [True, False, True]
    assert tchol.chol_downdate_plain(Lb, Wb)[1].tolist() == [True, False, True]
    clean, okc = ops.chol_downdate(Lb[[0, 2]], Wb[[0, 2]])
    assert bool(okc.all()) and torch.equal(got[[0, 2]], clean)


@pytest.mark.cuda
def test_cuda_chol_downdate_batch_plan(cuda_device):
    down = tchol.chol_downdate_batch_plan(625, 16)
    up = tchol.chol_update_batch_plan(625, 16)
    assert down["w_chunk"] == up["w_chunk"] == 16 and down["w_in_shared"] == 1
    assert down["smem_bytes"] == up["smem_bytes"] and down["resident_blocks_per_sm"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("expansion,p", [("hermite", 4), ("hermite", 9), ("rff_se", 3)])
def test_cuda_bank_fit_with_per_slot_maps(cuda_device, expansion, p):
    """The bank kernel with a stacked tile: each slot bitwise the shared
    launch under that slot's own map; with every map equal, bitwise the
    shared launch; against its plain version at the fit gate."""
    C, N = 5, 777
    ts, tile, _, _ = _stacked(expansion, p, 3 if p == 4 else 2, 64, C)
    tile = _on(tile, cuda_device)
    gen = torch.Generator().manual_seed(1)
    Xb = (torch.rand(C, N, p, generator=gen) * 2 - 1).to(cuda_device)
    yb = torch.randn(C, N, generator=gen).to(cuda_device)
    mb = (torch.rand(C, N, generator=gen) > 0.2).float().to(cuda_device)
    ops.reset_launch_counts()
    G, b = ops.bank_fused_fit_moments(Xb, yb, tile, mb)
    assert ops.launch_counts()["phi_gram"] == {"bank_slots": 1}
    for s in range(C):
        Gs, bs = ops.bank_fused_fit_moments(Xb, yb, thp.slot_tile(tile, s), mb)
        assert torch.equal(G[s], Gs[s]) and torch.equal(b[s], bs[s])
    Gp, bp = tgram.bank_phi_gram_plain(Xb, yb, mb, tile)
    np.testing.assert_allclose(nn(G), nn(Gp), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(nn(b), nn(bp), rtol=1e-3, atol=1e-3)
    shared = thp.slot_tile(tile, 2)
    per = shared.consts if expansion == "hermite" else shared.table
    field = "consts" if expansion == "hermite" else "table"
    same = dataclasses.replace(shared, **{field: per.expand((C,) + per.shape).contiguous()})
    assert all(torch.equal(a, c) for a, c in zip(ops.bank_fused_fit_moments(Xb, yb, same, mb),
                                                 ops.bank_fused_fit_moments(Xb, yb, shared, mb)))


@pytest.mark.cuda
@pytest.mark.parametrize("N,p,n", [(256, 4, 5), (1037, 2, 8), (300, 9, 2)])
def test_cuda_features_with_per_row_constants(cuda_device, N, p, n):
    """The features kernel with per-row slots: each row bitwise the plain
    version under its own slot's tile (C3: the plain version equals the
    kernel bitwise); with every slot's constants equal, bitwise the shared
    launch; one launch, counted as variant "slots"."""
    ts, tile, _, _ = _stacked("hermite", p, n, None, 7)
    tile = _on(tile, cuda_device)
    X = tt(uniform(np.random.default_rng(N), (N, p))).to(cuda_device)
    slots = torch.tensor(np.random.default_rng(p).integers(0, 7, N), dtype=torch.int32,
                         device=cuda_device)
    ops.reset_launch_counts()
    got = ops.expansion_phi(X, tile, slots)
    assert ops.launch_counts()["phi_features"] == {"slots": 1}
    assert torch.equal(got, thp.phi_features_plain(X, tile, slots))
    for s in range(7):
        rows = torch.nonzero(slots == s)[:, 0]
        assert torch.equal(got[rows], thp.phi_features_plain(X[rows], thp.slot_tile(tile, s)))
    shared = thp.slot_tile(tile, 3)
    same = dataclasses.replace(shared, consts=shared.consts.expand(7, p, 3).contiguous())
    assert torch.equal(ops.expansion_phi(X, same, slots), ops.expansion_phi(X, shared))
