"""The port's MLA (``repro_torch.models.mla``) against the JAX package's
(``repro.models.mla``) on the same numpy inputs and weights, on
deepseek-v3's SMOKE config (d 64, 4 heads, q_lora 32, kv_lora 16, nope 16,
rope 8, v 16): ``mla_init``'s leaves, the expanded form (``mla_apply``)
and its gradients, ``mla_prefill_cache``, the absorbed form
(``mla_decode``) at several positions (the last slot included, the
cache's tail still zero), the two forms against each other, both
attention routes at deepseek-v3's full head widths (Dqk = 192, Dv = 128),
and the deepseek block's MoE FFN with its shared expert.  ``q_ln`` and
``kv_ln`` are seeded random values (ones would hide a norm fault).

Gates, those of the LM family files: float32 at rtol 1e-4 / atol 1e-5
(``tests/test_torch_lm.py``); bfloat16 within twice the JAX package's own
bfloat16-vs-float32 distance on the same values; the flash route against
the simple one and against JAX's at ``tests/test_layers.py``'s 2e-4 /
2e-5; the absorbed form against the expanded form in float32 within twice
the JAX package's own distance between its two forms, measured here; the
MoE FFN at ``tests/test_distributed.py:195-196``'s 2e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_lm_common import f32, smoke  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

ARCH = "deepseek-v3-671b"
F32_TOL = dict(rtol=1e-4, atol=1e-5)       # tests/test_torch_lm.py
FLASH_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/test_layers.py:38-41
MOE_TOL = dict(rtol=2e-5, atol=2e-5)       # tests/test_distributed.py:195-196
B, S, CAP = 2, 12, 16
NORMS = ("q_ln", "kv_ln")


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _tdt(dtype):
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def _setup(dtype, seed=0):
    """(jcfg, tcfg, JAX params, port params, x numpy): the JAX package's
    init at ``seed`` (norms perturbed), the same values in both packages,
    the norms float32 as the reference keeps them."""
    jcfg, tcfg = smoke(ARCH, dtype)
    jp = jmla.mla_init(jax.random.key(seed), jcfg, jnp.float32)
    rng = np.random.default_rng(100 + seed)
    tree = {k: (1.0 + 0.2 * rng.standard_normal(v.shape)).astype(np.float32) if k in NORMS
            else np.asarray(v, np.float32) for k, v in jp.items()}
    jp = {k: jnp.asarray(v, jnp.float32 if k in NORMS else _jdt(dtype))
          for k, v in tree.items()}
    tp = {k: torch.from_numpy(v.copy()).to(torch.float32 if k in NORMS else _tdt(dtype))
          for k, v in tree.items()}
    x = rng.standard_normal((B, S + 1, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _to32(jp):
    return {k: jnp.asarray(v, jnp.float32) for k, v in jp.items()}


def _gate(got, want, want32, dtype, what=""):
    """float32: F32_TOL; bfloat16: within twice the reference's own
    bfloat16-vs-float32 distance."""
    if dtype == "float32":
        np.testing.assert_allclose(f32(got), f32(want), err_msg=what, **F32_TOL)
        return
    bound = 2.0 * float(np.abs(f32(want) - f32(want32)).max())
    err = float(np.abs(f32(got) - f32(want)).max())
    assert 0.0 < bound and err <= bound, (what, err, bound)


def test_mla_init_matches_reference_leaves():
    """Leaf names, shapes and dtypes (the two norms float32), each leaf's
    spread near the reference's (``wo`` at 1/sqrt(H dv)), repeatable from
    a seed."""
    jcfg, tcfg = smoke(ARCH)
    jp = jmla.mla_init(jax.random.key(0), jcfg, jnp.bfloat16)
    tp = tmla.mla_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.items()} == {
        k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in tp.items()}
    assert tp["q_ln"].dtype == tp["kv_ln"].dtype == torch.float32
    for k, v in tp.items():
        if k in NORMS:
            assert torch.equal(v, torch.ones_like(v))
            continue
        want = float(np.asarray(jp[k], np.float32).std())
        assert abs(float(v.float().std()) - want) < 0.15 * want, k
    again = tmla.mla_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    assert all(torch.equal(tp[k], again[k]) for k in tp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_apply_matches_jax(dtype):
    jcfg, tcfg, jp, tp, x = _setup(dtype)
    xs = x[:, :S]
    got = tmla.mla_apply(tp, torch.from_numpy(xs).to(_tdt(dtype)), tcfg)
    want = jmla.mla_apply(jp, jnp.asarray(xs, _jdt(dtype)), jcfg)
    want32 = jmla.mla_apply(_to32(jp), jnp.asarray(xs), dataclasses.replace(jcfg,
                                                                            dtype="float32"))
    assert got.shape == want.shape and got.dtype == _tdt(dtype)
    _gate(got, want, want32, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_cache_matches_jax(dtype):
    """The cache rows: the normalized latent, then the roped k_rope."""
    jcfg, tcfg, jp, tp, x = _setup(dtype)
    xt = torch.from_numpy(x[:, :S]).to(_tdt(dtype))
    got = tmla.mla_prefill_cache(tp, xt, tcfg)
    want = jmla.mla_prefill_cache(jp, jnp.asarray(x[:, :S], _jdt(dtype)), jcfg)
    want32 = jmla.mla_prefill_cache(_to32(jp), jnp.asarray(x[:, :S]), jcfg)
    assert tuple(got.shape) == (B, S, tcfg.kv_lora_rank + tcfg.qk_rope_dim)
    _gate(got, want, want32, dtype)


def _port_cache(tp, x, pos, dtype, tcfg):
    """A (B, CAP, 24) cache holding positions [0, pos) from the port's
    prefill, its tail zero."""
    tc = torch.zeros((B, CAP, tcfg.kv_lora_rank + tcfg.qk_rope_dim), dtype=_tdt(dtype))
    if pos:
        tc[:, :pos] = tmla.mla_prefill_cache(tp, torch.from_numpy(x[:, :pos]).to(_tdt(dtype)),
                                             tcfg)
    return tc


def _jax_cache(jp, x, pos, dtype, jcfg):
    """The same from the JAX package's prefill."""
    jc = jnp.zeros((B, CAP, jcfg.kv_lora_rank + jcfg.qk_rope_dim), _jdt(dtype))
    if pos:
        jc = jc.at[:, :pos].set(jmla.mla_prefill_cache(jp, jnp.asarray(x[:, :pos], _jdt(dtype)),
                                                       jcfg))
    return jc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 5, S, CAP - 1])
def test_mla_decode_matches_jax(dtype, pos):
    """One absorbed-form step at ``pos`` (0, the middle, the prompt's end,
    the cache's last slot): its output and the cache it writes in place,
    the positions after ``pos`` still zero."""
    jcfg, tcfg, jp, tp, _ = _setup(dtype)
    x = np.random.default_rng(7).standard_normal((B, CAP, jcfg.d_model)).astype(np.float32)
    tc, jc = _port_cache(tp, x, pos, dtype, tcfg), _jax_cache(jp, x, pos, dtype, jcfg)
    xt = x[:, pos:pos + 1]
    got, gc = tmla.mla_decode(tp, torch.from_numpy(xt).to(_tdt(dtype)), tcfg, tc, pos)
    assert gc is tc and got.dtype == _tdt(dtype)
    want, wc = jmla.mla_decode(jp, jnp.asarray(xt, _jdt(dtype)), jcfg, jc, pos)
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    jc32 = _jax_cache(_to32(jp), x, pos, "float32", jcfg32)
    want32, wc32 = jmla.mla_decode(_to32(jp), jnp.asarray(xt), jcfg32, jc32, pos)
    _gate(got, want, want32, dtype, "out")
    _gate(gc[:, :pos + 1], wc[:, :pos + 1], wc32[:, :pos + 1], dtype, "cache")
    assert float(gc[:, pos + 1:].abs().max() if pos + 1 < CAP else 0.0) == 0.0
    assert float(gc[:, pos].abs().max()) > 0


def _forms_distance(apply, decode, prefill_cache, p, x, cfg, new_cache):
    """max |absorbed - expanded| over every position of ``x``: the expanded
    form over the whole sequence, each decode step on the cache of the
    positions before it."""
    full = np.asarray(f32(apply(p, x, cfg)))
    cache = new_cache()
    worst = 0.0
    for pos in range(x.shape[1]):
        out, cache = decode(p, x[:, pos:pos + 1], cfg, cache, pos)
        worst = max(worst, float(np.abs(f32(out)[:, 0] - full[:, pos]).max()))
    return worst


def test_mla_absorbed_form_agrees_with_expanded_float32():
    """In float32 the two forms differ only by rounding: the port's
    distance between them, over every position of a 16-token sequence, is
    within twice the JAX package's own."""
    jcfg, tcfg, jp, tp, _ = _setup("float32")
    x = np.random.default_rng(8).standard_normal((B, CAP, jcfg.d_model)).astype(np.float32)
    W = tcfg.kv_lora_rank + tcfg.qk_rope_dim
    want = _forms_distance(jmla.mla_apply, jmla.mla_decode, jmla.mla_prefill_cache, jp,
                           jnp.asarray(x), jcfg, lambda: jnp.zeros((B, CAP, W), jnp.float32))
    got = _forms_distance(tmla.mla_apply, tmla.mla_decode, tmla.mla_prefill_cache, tp,
                          torch.from_numpy(x), tcfg,
                          lambda: torch.zeros((B, CAP, W), dtype=torch.float32))
    assert 0.0 < want < 1e-4
    assert got <= 2.0 * want, (got, want)


def test_mla_apply_gradients_match_jax_float32():
    """The expanded form's gradients (every leaf and x) against
    ``jax.grad`` of the same weighted sum."""
    jcfg, tcfg, jp, tp, x = _setup("float32")
    r = np.random.default_rng(9).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jg = jax.grad(lambda p, xx: jnp.sum(jmla.mla_apply(p, xx, jcfg) * r), argnums=(0, 1))(
        jp, jnp.asarray(x[:, :S]))
    tpg = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x[:, :S]).requires_grad_(True)
    out = torch.sum(tmla.mla_apply(tpg, xt, tcfg) * torch.from_numpy(r))
    grads = torch.autograd.grad(out, list(tpg.values()) + [xt])
    for (k, g) in zip(list(tpg) + ["x"], grads):
        want = jg[1] if k == "x" else jg[0][k]
        np.testing.assert_allclose(f32(g), f32(want), err_msg=k, **F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_mla_attention_routes_at_full_head_widths(causal):
    """deepseek-v3's attention shape (Dqk = nope + rope = 192, Dv = 128,
    K = H) through both routes at Sq = 2,048, the flash route's threshold:
    the port's flash against its simple route and against JAX's flash
    route, float32."""
    cfg = smoke(ARCH)[0]
    full = __import__("repro.configs", fromlist=["ARCHS"]).ARCHS[ARCH].CONFIG
    Dqk, Dv = full.qk_nope_dim + full.qk_rope_dim, full.v_head_dim
    assert (Dqk, Dv) == (192, 128) and cfg.use_mla
    Bq, Sq, H = 1, 2048, 2
    rng = np.random.default_rng(10)
    q = rng.standard_normal((Bq, Sq, H, Dqk)).astype(np.float32)
    k = rng.standard_normal((Bq, Sq, H, Dqk)).astype(np.float32)
    v = rng.standard_normal((Bq, Sq, H, Dv)).astype(np.float32)
    kw = dict(causal=causal, window=0, kv_valid_len=None, softcap=0.0)
    qg = torch.from_numpy(q).reshape(Bq, Sq, H, 1, Dqk)
    got = tl._attention_flash(qg, torch.from_numpy(k), torch.from_numpy(v), **kw)
    simple = tl._attention_simple(qg, torch.from_numpy(k), torch.from_numpy(v), q_offset=0,
                                  **kw)
    want = jl._attention_flash(jnp.asarray(q).reshape(Bq, Sq, H, 1, Dqk), jnp.asarray(k),
                               jnp.asarray(v), q_chunk=512, kv_chunk=1024, **kw)
    assert tuple(got.shape) == (Bq, Sq, H, 1, Dv)
    np.testing.assert_allclose(f32(got), f32(want), **FLASH_TOL)
    np.testing.assert_allclose(f32(got), f32(simple), **FLASH_TOL)
    # gqa_attention takes the flash route at this length, as mla_apply calls it
    out = tl.gqa_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           causal=causal)
    np.testing.assert_allclose(f32(out), f32(got).reshape(Bq, Sq, H, Dv), rtol=0, atol=0)


def test_deepseek_moe_ffn_with_shared_expert_matches_jax():
    """The deepseek block's FFN (8 routed experts top-2 and one shared
    expert, capacity factor 8): ``moe_apply``'s output, aux and gradients
    against the JAX package's, float32; the shared branch is what the
    port adds to the routed output."""
    jcfg, tcfg = smoke(ARCH, "float32")
    assert jcfg.n_shared_experts == 1
    jp = jmoe.moe_init(jax.random.key(3), jcfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert {"shared_wg", "shared_wu", "shared_wd"} <= set(tp)
    x = np.random.default_rng(11).standard_normal((48, jcfg.d_model)).astype(np.float32)
    _, jtopi, _ = jmoe._route(jp, jnp.asarray(x), jcfg)
    _, ttopi, _ = tmoe._route(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(np.asarray(jtopi), ttopi.numpy())
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(f32(ty), f32(jy), **MOE_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    routed = tmoe.moe_apply({k: v for k, v in tp.items() if not k.startswith("shared")},
                            torch.from_numpy(x), tcfg)[0]
    xt = torch.from_numpy(x)
    shared = (torch.nn.functional.silu(xt @ tp["shared_wg"]) * (xt @ tp["shared_wu"])) \
        @ tp["shared_wd"]
    assert float(shared.abs().max()) > 0
    assert torch.equal(ty, routed + shared)
    jg = jax.grad(lambda p: jnp.sum(jmoe.moe_apply(p, jnp.asarray(x), jcfg)[0])
                  + jmoe.moe_apply(p, jnp.asarray(x), jcfg)[1])(jp)
    tpg = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    y, aux = tmoe.moe_apply(tpg, torch.from_numpy(x), tcfg)
    grads = torch.autograd.grad(y.sum() + aux, list(tpg.values()))
    for k, g in zip(tpg, grads):
        np.testing.assert_allclose(f32(g), f32(jg[k]), err_msg=k, **F32_TOL)


def test_tf32_stays_off_for_the_absorbed_products():
    """The absorbed form's float32 score and context products need full
    float32 products on the card: importing the port leaves TF32 off."""
    import repro_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
