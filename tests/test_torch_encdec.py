"""``repro_torch.models.encdec`` (whisper's encoder-decoder) against the
JAX package's ``repro.models.encdec``, function by function, on
whisper-small's SMOKE config and one set of weights
(``test_torch_lm_common.numpy_params``: LayerNorm weights and biases and
the MLP biases seeded random values): ``sinusoids`` bitwise, at the SMOKE
and the published shapes; the init's leaves (names, shapes, dtypes, the
constant leaves equal, the random ones at the reference's spread);
``encode`` on seeded frames, ``_decode_full`` with its self and cross K/V,
``prefill`` and ``decode_step`` at three positions, in float32 at rtol =
atol = 1e-5 and in bfloat16 at twice the JAX package's own
bfloat16-vs-float32 distance."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_lm_common import both, f32, smoke, tokens  # noqa: E402

from repro.models import encdec as jencdec  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402

ARCH = "whisper-small"
TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 12


def _frames(cfg, b=B, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_len, cfg.d_model)).astype(np.float32)


def _gate(got, want, want32, dtype, what=""):
    """float32: TOL; bfloat16: within twice the reference's own
    bfloat16-vs-float32 distance."""
    if dtype == "float32":
        np.testing.assert_allclose(f32(got), f32(want), err_msg=what, **TOL)
        return
    bound = 2.0 * float(np.abs(f32(want) - f32(want32)).max())
    err = float(np.abs(f32(got) - f32(want)).max())
    assert 0.0 < bound and err <= bound, (what, err, bound)


def _both32(arch, dtype):
    """The models on one set of weights at ``dtype``, and the JAX package's
    float32 twin (its config and weights in float32) for the bfloat16
    gate."""
    jcfg, tcfg, _, _, jp, tp = both(arch, dtype)
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    jp32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jp)
    return jcfg, tcfg, jp, tp, jcfg32, jp32


@pytest.mark.parametrize("shape", [(32, 64), (1500, 768), (7, 10)])
def test_sinusoids_bitwise(shape):
    """numpy float64, then float32, in both packages: bit for bit, at the
    SMOKE and the published shapes."""
    got = tencdec.sinusoids(*shape)
    want = np.asarray(jencdec.sinusoids(*shape))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_leaves_match_the_reference():
    """Names, shapes and dtypes of every leaf (LayerNorms float32), the
    LayerNorm weights 1 and biases 0, the MLP biases 0, the random leaves
    at the reference's spread (``tok_emb`` 0.02, ``dec_pos`` 0.01, the
    projections 1/sqrt(d_in)), repeatable from a seed."""
    jcfg, tcfg = smoke(ARCH)
    jp = jencdec.init_params(jax.random.key(0), jcfg)
    tp = tencdec.init_params(torch.Generator().manual_seed(0), tcfg)
    assert isinstance(tp, tencdec.EncDec) and tp.device == torch.device("cpu")
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [p.key for p in path]
        stacked = keys[0] in ("enc_blocks", "dec_blocks")
        for idx in np.ndindex(*leaf.shape[:1 if stacked else 0]):
            want[".".join([keys[0]] + [str(i) for i in idx] + keys[1:])] = leaf[idx]
    named = dict(tp.named_parameters())
    assert set(named) == set(want)
    for k, w in want.items():
        g = named[k]
        assert tuple(g.shape) == tuple(w.shape), k
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), k
        w = np.asarray(w, np.float32)
        if w.std() == 0:
            np.testing.assert_array_equal(f32(g), w, err_msg=k)
        else:
            assert abs(float(g.float().std()) - float(w.std())) < 0.15 * float(w.std()), k
    again = tencdec.init_params(0, tcfg, device="cpu")
    first = tencdec.init_params(0, tcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(first.parameters(), again.parameters()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype):
    """Frames + sinusoids through the bidirectional encoder, then
    ``ln_enc``."""
    jcfg, tcfg, jp, tp, jcfg32, jp32 = _both32(ARCH, dtype)
    fr = _frames(jcfg, seed=1)
    want = jax.jit(lambda p, f: jencdec.encode(p, f, jcfg))(jp, jnp.asarray(fr))
    want32 = jax.jit(lambda p, f: jencdec.encode(p, f, jcfg32))(jp32, jnp.asarray(fr))
    got = tencdec.encode(tp, torch.from_numpy(fr), tcfg)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert tuple(got.shape) == (B, jcfg.enc_len, jcfg.d_model)
    _gate(got, want, want32, dtype, "encode")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_full_matches_jax(dtype):
    """The decoder over a sequence on the reference's encoder output: the
    hidden states and, per layer, the self and cross K/V the reference
    collects (``collect_kv``), written here into a cache."""
    jcfg, tcfg, jp, tp, jcfg32, jp32 = _both32(ARCH, dtype)
    toks = tokens(jcfg.vocab, B, S, seed=2)

    def jrun(cfg, p):
        enc = jencdec.encode(p, jnp.asarray(_frames(jcfg, seed=3)), cfg)
        h, kv = jencdec._decode_full(p, jnp.asarray(toks), enc, cfg, collect_kv=True)
        return enc, h, kv

    enc, h, kv = jax.jit(lambda p: jrun(jcfg, p))(jp)
    _, h32, kv32 = jax.jit(lambda p: jrun(jcfg32, p))(jp32)
    cache = tencdec.init_cache(tcfg, B, S, device="cpu")
    enc_t = torch.tensor(f32(enc)).to(tp.tok_emb.dtype)
    got = tencdec._decode_full(tp, torch.from_numpy(toks), enc_t, tcfg, cache=cache)
    _gate(got, h, h32, dtype, "hidden")
    for name, w, w32 in zip(("self_k", "self_v", "cross_k", "cross_v"), kv, kv32):
        _gate(cache[name], w, w32, dtype, name)
    again = tencdec._decode_full(tp, torch.from_numpy(toks), enc_t, tcfg)
    assert torch.equal(again, got)                  # the cache changes nothing


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_steps_match_jax(dtype):
    """``prefill`` (last-token logits, every cache entry, the self K/V
    padded to the capacity) and three decode steps at positions S, S + 1,
    S + 2 (``dec_pos[pos]`` added, the self K/V written at ``pos`` in
    place, the cross K/V read), each step's logits and cache."""
    jcfg, tcfg, jp, tp, jcfg32, jp32 = _both32(ARCH, dtype)
    toks, fr = tokens(jcfg.vocab, B, S, seed=4), _frames(jcfg, seed=5)
    steps = [tokens(jcfg.vocab, B, 1, seed=6 + i) for i in range(3)]
    names = ("self_k", "self_v", "cross_k", "cross_v")

    def jrun(cfg, p):
        pre = jax.jit(lambda p_, b: jencdec.prefill(p_, b, cfg, cache_len=S + 3))
        dec = jax.jit(lambda p_, b, c: jencdec.decode_step(p_, b, c, cfg))
        logits, cache = pre(p, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)})
        out = [logits] + [cache[k] for k in names]
        for i, st in enumerate(steps):
            logits, cache = dec(p, {"token": jnp.asarray(st), "pos": S + i}, cache)
            out += [logits] + [cache[k] for k in names]
        return out

    want, want32 = jrun(jcfg, jp), jrun(jcfg32, jp32)
    logits, cache = tencdec.prefill(tp, {"tokens": torch.from_numpy(toks),
                                         "frames": torch.from_numpy(fr)}, tcfg, cache_len=S + 3)
    got = [logits] + [cache[k].clone() for k in names]
    cross = cache["cross_k"].clone()
    for i, st in enumerate(steps):
        logits, out = tencdec.decode_step(tp, {"token": torch.from_numpy(st), "pos": S + i},
                                          cache, tcfg)
        assert out is cache
        got += [logits] + [cache[k].clone() for k in names]
    assert torch.equal(cache["cross_k"], cross)
    assert float(cache["self_k"][:, :, S + 2].abs().max()) > 0
    for i, (g, w, w32) in enumerate(zip(got, want, want32)):
        assert g.shape == w.shape, i
        assert g.dtype == (torch.float32 if i % 5 == 0 else tp.tok_emb.dtype), i
        _gate(g, w, w32, dtype, f"output {i}")


def test_init_cache_shapes():
    _, tcfg = smoke(ARCH)
    c = tencdec.init_cache(tcfg, 3, 10, device="cpu")
    L, K, Dh = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim
    assert {k: tuple(v.shape) for k, v in c.items()} == {
        "self_k": (L, 3, 10, K, Dh), "self_v": (L, 3, 10, K, Dh),
        "cross_k": (L, 3, tcfg.enc_len, K, Dh), "cross_v": (L, 3, tcfg.enc_len, K, Dh)}
    assert all(v.dtype == torch.bfloat16 and float(v.abs().max()) == 0 for v in c.values())
