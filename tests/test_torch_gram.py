"""Port parity for the scaled-Gram kernel module (``kernels/gram.py``):
the port's ``ops.scaled_gram`` on CPU tensors (the kernel's plain version)
against the JAX ``ops.scaled_gram`` in interpret mode, at the JAX tests'
shapes and gates (tests/test_kernels.py:81-112); its dtype contract; and
the CUDA kernel against its plain version, at its tile edges and bitwise
against the fused fit (marked ``cuda``, skipped without a card)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_common import nn, tt  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import expansions as texp  # noqa: E402
from repro_torch.core import fagp as tfagp  # noqa: E402
from repro_torch.kernels import gram as tgram  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _inputs(N, M, seed=1, lo=1e-6):
    rng = np.random.default_rng(seed)
    Phi = rng.standard_normal((N, M)).astype(np.float32)
    d = np.geomspace(1.0, lo, M).astype(np.float32)
    return Phi, d


@pytest.mark.parametrize("N,M", [(64, 16), (512, 128), (300, 100), (1024, 256), (100, 257)])
def test_scaled_gram_matches_jax(N, M):
    Phi, d = _inputs(N, M)
    want = jops.scaled_gram(jnp.asarray(Phi), jnp.asarray(d), jnp.float32(0.01))
    got = ops.scaled_gram(tt(Phi), tt(d), 0.01)
    assert got.shape == (M, M) and got.dtype == torch.float32
    # tests/test_kernels.py:90 gate
    np.testing.assert_allclose(nn(got), nn(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scaled_gram_dtypes_match_jax(dtype):
    """A bfloat16 Phi is accumulated in float32 and gives a float32 B, as in
    the JAX op (tests/test_kernels.py:94-105: 1e-4 for float32, 5e-2 for
    bfloat16, against the float32 oracle on the rounded Phi)."""
    rng = np.random.default_rng(2)
    Phi = rng.standard_normal((256, 64)).astype(np.float32)
    jphi = jnp.asarray(Phi).astype(getattr(jnp, dtype))
    tphi = tt(Phi).to(getattr(torch, dtype))
    want = jops.scaled_gram(jphi, jnp.ones((64,), jnp.float32), jnp.float32(0.5))
    got = ops.scaled_gram(tphi, torch.ones(64), 0.5)
    assert got.dtype == torch.float32
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(nn(got), np.asarray(want), rtol=tol, atol=tol)
    # both round Phi to the same bfloat16 values
    np.testing.assert_array_equal(nn(tphi.float()), np.asarray(jphi.astype(jnp.float32)))


def test_scaled_gram_spd():
    Phi, d = _inputs(512, 96, seed=3, lo=1e-4)
    out = nn(ops.scaled_gram(tt(Phi), tt(d), 0.1))
    np.testing.assert_allclose(out, out.T, atol=1e-5)
    assert np.linalg.eigvalsh(out).min() >= 0.99  # >= I by construction


def test_scaled_gram_refuses_what_the_kernel_does_not_take():
    ops.reset_launch_counts()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.scaled_gram(torch.ones(8, 4, dtype=torch.float16), torch.ones(4), 1.0)
    with pytest.raises(ValueError, match="sqrtlam has 3"):
        ops.scaled_gram(torch.ones(8, 4), torch.ones(3), 1.0)
    with pytest.raises(ValueError, match=r"\(N, M\)"):
        ops.scaled_gram(torch.ones(8), torch.ones(8), 1.0)
    with pytest.raises(ValueError, match="several devices"):
        ops.scaled_gram(torch.ones(8, 4), torch.ones(4, device="meta"), 1.0)
    # a CPU tensor runs the plain version and launches nothing
    ops.scaled_gram(torch.ones(8, 4), torch.ones(4), 1.0)
    assert ops.launch_counts()["scaled_gram"] == {}


def test_plain_version_is_the_oracle():
    Phi, d = _inputs(37, 21)
    B = tgram.scaled_gram_plain(tt(Phi), tt(d), 0.2)
    G = Phi.astype(np.float64).T @ Phi.astype(np.float64)
    want = np.eye(21) + d[:, None] * G * d[None, :] / 0.2
    np.testing.assert_allclose(nn(B), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version (skipped here)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _assert_gram_close(got, want, Phi, d, sig2):
    """|got - want| <= 1e-5 + 1e-4 max(|want|, s) with s the Cauchy-Schwarz
    magnitude |phi_i| |phi_j| d_i d_j / sig2 of each entry's sum: a float32
    sum of N terms errs relative to its terms, not to a result that
    cancels (chip_smoke.py holds the fused fit by the same gate)."""
    cn = np.linalg.norm(Phi.astype(np.float64), axis=0) * d
    scale = np.maximum(np.abs(want), np.outer(cn, cn) / sig2)
    assert np.all(np.abs(got - want) <= 1e-5 + 1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("N,M", [(64, 16), (300, 257), (1037, 125), (2000, 640)])
def test_cuda_scaled_gram_matches_plain(cuda_device, N, M):
    Phi, d = _inputs(N, M, lo=1e-3)
    Pc, dc = tt(Phi).to(cuda_device), tt(d).to(cuda_device)
    ops.reset_launch_counts()
    B = ops.scaled_gram(Pc, dc, 0.01)
    assert ops.launch_counts()["scaled_gram"] == {"": 1}
    assert torch.equal(B, B.T)
    _assert_gram_close(nn(B), nn(tgram.scaled_gram_plain(Pc, dc, 0.01)), Phi, d, 0.01)
    Ph = Pc.to(torch.bfloat16)
    Bh = ops.scaled_gram(Ph, dc, 0.01)
    assert Bh.dtype == torch.float32
    assert ops.launch_counts()["scaled_gram"] == {"": 1, "bf16": 1}
    # the kernel and the plain version widen the same bfloat16 values, so
    # they differ only in the order of the float32 sums, as above
    _assert_gram_close(nn(Bh), nn(tgram.scaled_gram_plain(Ph, dc, 0.01)),
                       nn(Ph.float()), d, 0.01)


# the kernel at its tile edges: M on both sides of one and two 128-column
# tiles (and the fleet's 625), N on both sides of a 32-row step, float32
# and bfloat16 (widened from 2-byte loads); B exactly symmetric
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [1, 31, 32, 33, 1037])
@pytest.mark.parametrize("M", [1, 127, 128, 129, 255, 257, 625])
def test_cuda_scaled_gram_at_tile_edges(cuda_device, M, N, dtype):
    Phi, d = _inputs(N, M, seed=M + N, lo=1e-3)
    Pc = tt(Phi).to(cuda_device).to(getattr(torch, dtype))
    dc = tt(d).to(cuda_device)
    P0 = Pc.clone()
    B = ops.scaled_gram(Pc, dc, 0.01)
    assert B.dtype == torch.float32 and torch.equal(B, B.T)
    assert torch.equal(Pc, P0)
    _assert_gram_close(nn(B), nn(tgram.scaled_gram_plain(Pc, dc, 0.01)),
                       nn(Pc.float()), d, 0.01)


# B of the stored features is bitwise the fused fit's B of the same X:
# both sum every entry in row order, one fmaf per row from 0, and scale it
# by the same pinned epilogue; ragged M = 129 and 625
@pytest.mark.cuda
@pytest.mark.parametrize("M,N", [(129, 1037), (625, 33), (128, 1)])
def test_cuda_scaled_gram_is_bitwise_the_fused_fit(cuda_device, M, N):
    ts = tfagp.GPSpec.create(5, np.full(4, 0.8, np.float32), 2.0, 0.05)
    tile = texp.get_expansion("hermite").tile_args(ts, tfagp._idx_tensor(ts))
    tile = dataclasses.replace(tile, M=M, idx=tile.idx[:M].contiguous())
    tile = dataclasses.replace(tile, **{f: getattr(tile, f).to(cuda_device)
                                        for f in ("consts", "coef", "idx")})
    rng = np.random.default_rng(M + N)
    X = tt(rng.uniform(-1, 1, (N, 4)).astype(np.float32)).to(cuda_device)
    y = tt(rng.standard_normal(N).astype(np.float32)).to(cuda_device)
    d = torch.linspace(1.0, 0.01, M, device=cuda_device)
    B, _ = ops.fused_fit_moments(X, y, tile, d, 0.01)
    assert torch.equal(ops.scaled_gram(ops.expansion_phi(X, tile), d, 0.01), B)


@pytest.mark.cuda
def test_cuda_scaled_gram_plan(cuda_device):
    for bf16 in (False, True):
        plan = tgram.scaled_gram_plan(10_000, 14_641, bf16, cuda_device)
        # three stages of two (32, 128) float32 slices; 115 tile rows
        assert {k: v for k, v in plan.items() if k != "resident_blocks_per_sm"} == {
            "tile": 128, "rows_per_step": 32, "stages": 3, "steps": 313,
            "blocks": 115 * 116 // 2, "smem_bytes": 4 * 3 * 2 * 32 * 128,
            "strip_rows": 1024}
        assert plan["resident_blocks_per_sm"] >= 1
    with pytest.raises(RuntimeError, match="scaled_gram"):
        tgram.scaled_gram_plan(10, 0, False, cuda_device)
