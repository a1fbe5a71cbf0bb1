"""The port's LM layer library (``repro_torch.models.layers``) against the
JAX package's (``repro/models/layers.py``), function by function, on the
same numpy inputs: float32 at rtol 1e-5 (ulp-level differences of exp,
rsqrt and the summation order of the products), bfloat16 within one
bfloat16 ulp (2^-8 relative) of the reference for a single rounding, and
for the layers that round products to bfloat16 in between (projections,
attention layers, MLPs) within twice the JAX package's own bfloat16 vs
float32 distance on the same inputs; the chunked (flash)
attention against JAX's own at ``tests/test_layers.py``'s five shapes and
gate (rtol 2e-4, atol 2e-5)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_lm_common import f32, smoke  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2.0 ** -8, atol=2.0 ** -8)   # one bfloat16 ulp
FLASH_TOL = dict(rtol=2e-4, atol=2e-5)            # tests/test_layers.py:38-41


def _pair(a, dtype):
    """One numpy array as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    t = torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), **tol)


def _tol(dtype):
    return BF16_TOL if dtype == "bfloat16" else F32_TOL


def _to32(tree):
    return {k: jnp.asarray(v, jnp.float32) for k, v in tree.items()} \
        if isinstance(tree, dict) else jnp.asarray(tree, jnp.float32)


def _gate(got, jfn, jargs, dtype):
    """float32: F32_TOL.  bfloat16: |port - JAX| within twice JAX's own
    bfloat16 vs float32 distance, the float32 run on the same values."""
    want = jfn(*jargs)
    if dtype == "float32":
        for g, w in zip(got, want):
            _close(g, w, F32_TOL)
        return
    want32 = jfn(*[_to32(a) for a in jargs])
    for g, w, w32 in zip(got, want, want32):
        bound = 2.0 * float(np.abs(f32(w) - f32(w32)).max())
        assert float(np.abs(f32(g) - f32(w)).max()) <= bound


def _qkv(B, Sq, Skv, H, K, D, Dv=None, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Skv, K, D)).astype(np.float32),
            rng.standard_normal((B, Skv, K, Dv or D)).astype(np.float32))


def test_torch_layers_dense_and_norm_init():
    gen = torch.Generator().manual_seed(0)
    w = tl.dense_init(gen, 256, 512, torch.bfloat16)
    assert w.shape == (256, 512) and w.dtype == torch.bfloat16
    # N(0, 1) / sqrt(d_in), drawn in float32 then cast
    assert abs(float(w.float().std()) * math.sqrt(256) - 1.0) < 0.02
    wo = tl.dense_init(gen, 64, 32, torch.float32, scale=0.5)
    assert abs(float(wo.std()) - 0.5) < 0.05
    assert torch.equal(tl.norm_init(7), torch.ones(7))
    assert tl.norm_init(7).dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_layers_rmsnorm_and_layernorm(dtype):
    rng = np.random.default_rng(1)
    x = 3.0 * rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(48)).astype(np.float32)
    b = (0.2 * rng.standard_normal(48)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    _close(tl.rmsnorm(tx, tw, 1e-5), jl.rmsnorm(jx, jw, 1e-5), _tol(dtype))
    assert tl.rmsnorm(tx, tw).dtype == tx.dtype
    _close(tl.layernorm(tx, tw, torch.from_numpy(b), 1e-5),
           jl.layernorm(jx, jw, jnp.asarray(b), 1e-5), _tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("positions", ["prefill", "decode"])
def test_torch_layers_rope(dtype, positions):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 6, 2, 32)).astype(np.float32)
    pos = (np.arange(6) + 17 if positions == "prefill"
           else rng.integers(0, 4000, size=(3, 6))).astype(np.int32)
    jx, tx = _pair(x, dtype)
    got = tl.rope(tx, torch.from_numpy(pos), 1e6)
    assert got.dtype == tx.dtype
    tol = dict(_tol(dtype))
    if dtype == "float32":
        # the two exps of the frequencies may differ in their last bit
        # (2^-23 relative), which an angle of `pos` radians carries into the
        # rotation: |dy| <= (|x1| + |x2|) * pos * 2^-23
        tol["atol"] += 2 * float(np.abs(x).max()) * float(pos.max()) * 2.0 ** -23
    _close(got, jl.rope(jx, jnp.asarray(pos), 1e6), tol)


@pytest.mark.parametrize("causal,window,valid,q_start", [
    (True, 0, None, 0), (True, 5, None, 3), (False, 0, 7, 0), (True, 4, 9, 6)])
def test_torch_layers_mask_logits(causal, window, valid, q_start):
    logits = np.random.default_rng(3).standard_normal((2, 3, 5, 12)).astype(np.float32)
    got = tl._mask_logits(torch.from_numpy(logits), q_start, 2, causal, window, valid)
    want = jl._mask_logits(jnp.asarray(logits), q_start, 2, causal, window, valid)
    np.testing.assert_array_equal(f32(got), f32(want))
    assert float(got.min()) in (float(np.float32(-1e30)), float(logits.min()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,q_offset,valid,softcap", [
    (True, 0, 0, None, 0.0), (True, 6, 0, None, 0.0), (False, 0, 0, None, 30.0),
    (True, 0, 9, 10, 0.0), (True, 4, 9, 10, 5.0)])
def test_torch_layers_attention_simple(dtype, causal, window, q_offset, valid, softcap):
    B, Sq, Skv, H, K, D = 2, 16 if q_offset == 0 else 1, 16, 4, 2, 16
    q, k, v = _qkv(B, Sq, Skv, H, K, D, seed=4)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_valid_len=valid,
              softcap=softcap)
    got = tl._attention_simple(tq.reshape(B, Sq, K, 2, D), tk, tv, **kw)
    want = jl._attention_simple(jq.reshape(B, Sq, K, 2, D), jk, jv, **kw)
    assert got.dtype == tv.dtype
    _close(got, want, _tol(dtype))


@pytest.mark.parametrize("causal,window,Skv", [
    (True, 0, 4096), (True, 1024, 4096), (False, 0, 4096),
    (True, 0, 3000), (False, 0, 1500)])
def test_torch_layers_flash_matches_jax_flash(causal, window, Skv):
    """tests/test_layers.py's five shapes: the port's flash route against
    the JAX package's flash route and against its own simple route."""
    B, Sq, H, K, D = 2, 2048, 4, 2, 32
    q, k, v = _qkv(B, Sq, Skv, H, K, D)
    kw = dict(causal=causal, window=window, kv_valid_len=None, softcap=0.0)
    got = tl._attention_flash(torch.from_numpy(q).reshape(B, Sq, K, 2, D),
                              torch.from_numpy(k), torch.from_numpy(v),
                              q_chunk=512, kv_chunk=1024, **kw)
    want = jl._attention_flash(jnp.asarray(q).reshape(B, Sq, K, 2, D), jnp.asarray(k),
                               jnp.asarray(v), q_chunk=512, kv_chunk=1024, **kw)
    _close(got, want, FLASH_TOL)
    simple = tl._attention_simple(torch.from_numpy(q).reshape(B, Sq, K, 2, D),
                                  torch.from_numpy(k), torch.from_numpy(v),
                                  q_offset=0, **kw)
    _close(got, simple, FLASH_TOL)


def test_torch_layers_flash_with_valid_len_and_softcap():
    B, Sq, H, K, D = 1, 2048, 2, 2, 16
    q, k, v = _qkv(B, Sq, 2048, H, K, D, seed=3)
    kw = dict(causal=True, window=0, kv_valid_len=1500, softcap=30.0)
    got = tl._attention_flash(torch.from_numpy(q).reshape(B, Sq, K, 1, D),
                              torch.from_numpy(k), torch.from_numpy(v), **kw)
    want = jl._attention_flash(jnp.asarray(q).reshape(B, Sq, K, 1, D), jnp.asarray(k),
                               jnp.asarray(v), **kw)
    _close(got, want, FLASH_TOL)


@pytest.mark.parametrize("Sq,q_offset,route", [
    (2048, 0, "flash"), (256, 0, "simple"), (2560, 0, "flash"), (2304, 0, "simple"),
    (1, 7, "simple")])
def test_torch_layers_gqa_attention_dispatch(Sq, q_offset, route, monkeypatch):
    """The flash route only for Sq >= 2048, Sq % 512 == 0 and q_offset the
    int 0, as in the reference; the result equals the reference's."""
    taken = []
    for name in ("_attention_flash", "_attention_simple"):
        orig = getattr(tl, name)
        monkeypatch.setattr(tl, name, lambda *a, _o=orig, _n=name, **kw: (
            taken.append(_n), _o(*a, **kw))[1])
    B, H, K, D, Dv = 1, 4, 2, 16, 8
    Skv = max(Sq, 16)
    q, k, v = _qkv(B, Sq, Skv, H, K, D, Dv=Dv, seed=6)
    kw = dict(causal=True, q_offset=q_offset, kv_valid_len=None if q_offset == 0 else 8)
    got = tl.gqa_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    want = jl.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    assert taken == [f"_attention_{route}"]
    assert got.shape == (B, Sq, H, Dv)
    _close(got, want, FLASH_TOL)


def _attn_params(cfg, dtype, seed=7):
    rng = np.random.default_rng(seed)
    d, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": (d, H * Dh), "wk": (d, K * Dh), "wv": (d, K * Dh), "wo": (H * Dh, d),
              "bq": (H * Dh,), "bk": (K * Dh,), "bv": (K * Dh,)}
    p = {k: (rng.standard_normal(s) / math.sqrt(s[0] if len(s) == 2 else 10)).astype(np.float32)
         for k, s in shapes.items()}
    jp, tp = {}, {}
    for k, a in p.items():
        jp[k], tp[k] = _pair(a, dtype)
    return jp, tp


def test_torch_layers_attn_init_shapes():
    _, cfg = smoke("qwen2-1.5b")
    p = tl.attn_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    jp = jl.attn_init(jax.random.key(0), cfg, jnp.bfloat16)
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in jp.items()}
    assert all(v.dtype == torch.bfloat16 for v in p.values())
    assert not any(float(p[b].abs().max()) for b in ("bq", "bk", "bv"))
    cross = tl.attn_init(torch.Generator().manual_seed(0), cfg, torch.float32, cross=True,
                         d_kv_in=32)
    assert set(cross) == {"wq", "wk", "wv", "wo"} and cross["wk"].shape == (32, 32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "starcoder2-3b"])
def test_torch_layers_attn_apply_and_project(dtype, arch):
    jcfg, cfg = smoke(arch, dtype)
    jp, tp = _attn_params(cfg, dtype)
    x = np.random.default_rng(8).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    _gate(tl._project_qkv(tp, tx, tx, cfg), lambda p, x: jl._project_qkv(p, x, x, jcfg),
          (jp, jx), dtype)
    out, (k, v) = tl.attn_apply(tp, tx, cfg, return_kv=True)

    def japply(p, x):
        o, (k, v) = jl.attn_apply(p, x, jcfg, return_kv=True)
        return o, k, v
    _gate((out, k, v), japply, (jp, jx), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_layers_update_cache_and_attn_decode(dtype):
    jcfg, cfg = smoke("starcoder2-3b", dtype)     # sliding window 32
    jp, tp = _attn_params(cfg, dtype, seed=9)
    rng = np.random.default_rng(10)
    B, S, K, Dh = 2, 48, cfg.n_kv_heads, cfg.head_dim
    ck = rng.standard_normal((B, S, K, Dh)).astype(np.float32)
    cv = rng.standard_normal((B, S, K, Dh)).astype(np.float32)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    (jck, tck), (jcv, tcv), (jx, tx) = _pair(ck, dtype), _pair(cv, dtype), _pair(x, dtype)
    pos = 40
    got, gk, gv = tl.attn_decode(tp, tx, cfg, tck, tcv, pos)
    assert gk is tck and gv is tcv                 # written in place
    _gate((got, gk, gv), lambda p, x, ck, cv: jl.attn_decode(
        p, x, jcfg, ck, cv, jnp.asarray(pos, jnp.int32)), (jp, jx, jck, jcv), dtype)
    # update_cache alone, at another position, on the same cache
    new = rng.standard_normal((B, 1, K, Dh)).astype(np.float32)
    jn, tn = _pair(new, dtype)
    base = jnp.asarray(f32(tck)).astype(jck.dtype)
    out = tl.update_cache(tck, tn, 3)
    assert out is tck
    np.testing.assert_array_equal(f32(out), f32(jl.update_cache(base, jn, 3)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["silu", "gelu_gated", "gelu_plain"])
def test_torch_layers_mlp(dtype, kind):
    d, f = 24, 40
    gen = torch.Generator().manual_seed(1)
    tp = tl.mlp_init(gen, d, f, torch.float32, gated=kind != "gelu_plain")
    jp_shapes = jl.mlp_init(jax.random.key(1), d, f, jnp.float32, gated=kind != "gelu_plain")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp_shapes.items()}
    rng = np.random.default_rng(11)
    p = {k: (v.numpy() + (0.1 * rng.standard_normal(v.shape) if k[0] == "b" else 0)
             ).astype(np.float32) for k, v in tp.items()}
    jp, tpp = {}, {}
    for k, a in p.items():
        jp[k], tpp[k] = _pair(a, dtype)
    x = 2.0 * rng.standard_normal((3, 5, d)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    act = "silu" if kind == "silu" else "gelu"
    _gate((tl.mlp_apply(tpp, tx, act),), lambda p, x: (jl.mlp_apply(p, x, act),),
          (jp, jx), dtype)
