"""The port's Mercer-feature linear attention
(``repro_torch.models.mercer_attention``) against the JAX package's on the
same numpy inputs (float32, rtol 1e-5 / atol 1e-6: the same arithmetic in
another summation order), and against exact softmax attention at the JAX
test's own bounds (``tests/test_mercer_attention.py``), on both the causal
and the non-causal path."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import mercer_attention as jma  # noqa: E402
from repro_torch.models import mercer_attention as tma  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


def _norm_clamp(x, target=1.0):
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x * (target / np.maximum(n, 1e-6))


def _softmax_attention(q, k, v, causal=True):
    S = q.shape[1]
    logits = np.einsum("bqhd,bkhd->bhqk", q, k)
    if causal:
        logits = np.where(np.tril(np.ones((S, S), bool))[None, None], logits, -1e30)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


def test_torch_mercer_features_match_reference():
    rng = np.random.default_rng(0)
    x = 0.7 * rng.standard_normal((3, 5, 8)).astype(np.float32)
    got = tma.mercer_features_deg2(torch.from_numpy(x)).numpy()
    want = np.asarray(jma.mercer_features_deg2(jnp.asarray(x)))
    assert got.shape == (3, 5, 1 + 8 + 8 * 9 // 2)
    np.testing.assert_allclose(got, want, **TOL)
    # the feature inner product approximates the Gaussian kernel (the JAX
    # test's bounds)
    a = _norm_clamp(rng.standard_normal((50, 8)).astype(np.float32))
    b = _norm_clamp(rng.standard_normal((50, 8)).astype(np.float32))
    approx = np.einsum("nm,nm->n", tma.mercer_features_deg2(torch.from_numpy(a)).numpy(),
                       tma.mercer_features_deg2(torch.from_numpy(b)).numpy())
    np.testing.assert_allclose(approx, np.exp(-0.5 * np.sum((a - b) ** 2, axis=1)),
                               rtol=0.05, atol=0.01)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_mercer_attention_matches_reference(causal, dtype):
    rng = np.random.default_rng(1)
    B, S, H, D = 2, 64, 2, 8
    q = 1.5 * rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = 1.5 * rng.standard_normal((B, S, H, D)).astype(np.float32)
    v = rng.standard_normal((B, S, H, D)).astype(np.float32)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    got = tma.mercer_linear_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                      causal=causal, target_norm=1.2)
    want = jma.mercer_linear_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                       causal=causal, target_norm=1.2)
    assert got.dtype == tdt and got.shape == (B, S, H, D)
    # bfloat16: the inputs are the same bf16 values, the work is float32,
    # only the output's rounding (one bf16 ulp) can differ
    tol = TOL if dtype == "float32" else dict(rtol=2.0 ** -8, atol=2.0 ** -8)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("causal", [True, False])
def test_torch_mercer_attention_close_to_softmax(causal):
    """tests/test_mercer_attention.py:56-68's bound, in the port."""
    rng = np.random.default_rng(1)
    B, S, H, D = 2, 64, 2, 8
    q = _norm_clamp(rng.standard_normal((B, S, H, D)).astype(np.float32))
    k = _norm_clamp(rng.standard_normal((B, S, H, D)).astype(np.float32))
    v = rng.standard_normal((B, S, H, D)).astype(np.float32)
    out = tma.mercer_linear_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal).numpy()
    ref = _softmax_attention(q, k, v, causal=causal)
    assert np.abs(out - ref).max() < 0.08 * np.abs(ref).max()


def test_torch_mercer_attention_long_sequence_is_linear():
    rng = np.random.default_rng(2)
    B, S, H, D = 1, 4096, 1, 8
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32))
               for _ in range(3))
    out = tma.mercer_linear_attention(q, k, v, causal=True)
    assert out.shape == (B, S, H, D) and torch.isfinite(out).all()
