"""The parity cases of the two families whose batches carry more than
tokens, the audio family (whisper-small, ``repro_torch.models.encdec``:
``frames`` (B, enc_len, d)) and the VLM family (llama-3.2-vision-11b,
``repro_torch.models.lm``: ``img`` (B, n_img_tokens, d)), held against the
JAX package's on one set of weights; ``tests/test_torch_lm_audio.py`` and
``tests/test_torch_lm_vlm.py`` run each case on their family (this file
holds no tests).

The weights are ``test_torch_lm_common.numpy_params``: biases, norm and
LayerNorm weights and biases, and the VLM's cross-block gates seeded
random values (the gates are zero at init, where the image would change
no logit and every cross-block leaf but the gates would get a zero
gradient).  The extras are seeded float32 standard normals, cast to the
model dtype by both packages.

Gates, those of the other family files: float32 at rtol 1e-4 / atol 1e-5
(``tests/test_torch_lm.py``), bfloat16 at twice the JAX package's own
bfloat16-vs-float32 distance, the loss, grad norm and lr at rtol 1e-5 and
the gradients within 1e-5 of each leaf's largest entry, the parameters
after AdamW steps at ``test_torch_lm_common.adamw_gate``; prefill(S) +
decode(S) against prefill(S + 1) at rtol = atol = 0.15
(``tests/test_arch_smoke.py:65-83``).
"""
import dataclasses
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_lm_common import (adamw_gate, assert_params_within, both, f32,  # noqa: E402
                                  jax_params, jax_train_run, numpy_params, smoke, tokens)

from repro import checkpoint as jcheckpoint  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.data import TokenStream as JStream  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.launch.train import build as jbuild  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.runtime import TrainLoopConfig as JLoopConfig  # noqa: E402
from repro.runtime import train_loop as jtrain_loop  # noqa: E402
from repro_torch import checkpoint, optim  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import get_model as tget_model  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.runtime import TrainLoopConfig, train_loop  # noqa: E402

AUDIO, VLM = "whisper-small", "llama-3.2-vision-11b"
F32_TOL = dict(rtol=1e-4, atol=1e-5)
B, S, EXTRA = 2, 20, 4
SEQ, LR = 80, 3e-3              # SEQ = 2 chunks of 32 + a remainder of 16
LOOP_SEQ = 48
QUIET = dict(log_fn=lambda s: None)
CACHE = {AUDIO: ("self_k", "self_v", "cross_k", "cross_v"),
         VLM: ("k", "v", "img_k", "img_v")}
EXTRA_KEY = {AUDIO: "frames", VLM: "img"}
# the stacks and their stacked leading axes in the reference's tree
LEAD = {AUDIO: {"enc_blocks": 1, "dec_blocks": 1},
        VLM: {"cross_blocks": 1, "self_groups": 2}}
TOPS = {AUDIO: ["dec_blocks", "dec_pos", "enc_blocks", "ln_dec", "ln_enc", "tok_emb"],
        VLM: ["cross_blocks", "final_norm", "lm_head", "self_groups", "tok_emb"]}


def extras(cfg, b, seed):
    """{"frames": (b, enc_len, d)} or {"img": (b, n_img_tokens, d)}, float32
    standard normal numpy from ``seed``."""
    n = cfg.enc_len if cfg.family == "audio" else cfg.n_img_tokens
    x = np.random.default_rng(seed).standard_normal((b, n, cfg.d_model)).astype(np.float32)
    return {EXTRA_KEY[AUDIO if cfg.family == "audio" else VLM]: x}


def jbatch(toks, ex):
    return {"tokens": jnp.asarray(toks), **{k: jnp.asarray(v) for k, v in ex.items()}}


def tbatch(toks, ex):
    return {"tokens": torch.tensor(np.asarray(toks)),
            **{k: torch.from_numpy(v) for k, v in ex.items()}}


class WithExtras:
    """A token stream whose batches carry fixed extras, as ``build``'s
    extras ride on every batch of the train loop."""

    def __init__(self, stream, ex, port):
        self.stream, self.port = stream, port
        self.ex = ({k: torch.from_numpy(v) for k, v in ex.items()} if port
                   else {k: jnp.asarray(v) for k, v in ex.items()})

    def batch(self, s, device=None):
        if self.port:
            return self.stream.batch(s, self.ex, device="cpu")
        return self.stream.batch(s, self.ex)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _leaf_close(got, want, rel=1e-5, what=""):
    got, want = f32(got), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# serving: prefill, decode, the caches
# ---------------------------------------------------------------------------


def _run_jax(arch, jm, jp, toks, ex, S_cap, step_tok):
    logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=S_cap))(jp, jbatch(toks, ex))
    dlogits, dcache = jax.jit(jm.decode_step)(
        jp, {"token": jnp.asarray(step_tok), "pos": jnp.asarray(toks.shape[1], jnp.int32)},
        cache)
    return [logits] + [cache[k] for k in CACHE[arch]] + [dlogits] + [dcache[k]
                                                                   for k in CACHE[arch]]


def _run_port(arch, tm, tp, toks, ex, S_cap, step_tok):
    logits, cache = tm.prefill(tp, tbatch(toks, ex), cache_len=S_cap)
    assert set(cache) == set(CACHE[arch])
    out = [logits] + [cache[k].clone() for k in CACHE[arch]]
    held = dict(cache)
    dlogits, dcache = tm.decode_step(
        tp, {"token": torch.from_numpy(step_tok), "pos": toks.shape[1]}, cache)
    assert dcache is cache and all(dcache[k] is v for k, v in held.items())   # in place
    return out + [dlogits] + [dcache[k] for k in CACHE[arch]]


def _names(arch):
    return (["prefill logits"] + [f"prefill {k}" for k in CACHE[arch]] + ["decode logits"]
            + [f"decode {k}" for k in CACHE[arch]])


def prefill_decode_float32(arch):
    """The logits and every cache entry after the prefill and after one
    decode step: the self K/V padded to the capacity, the cross or image
    K/V written by the prefill and left by the step."""
    jcfg, tcfg, jm, tm, jp, tp = both(arch, "float32")
    toks, step = tokens(jcfg.vocab, B, S, seed=1), tokens(jcfg.vocab, B, 1, seed=2)
    ex = extras(jcfg, B, seed=3)
    want = _run_jax(arch, jm, jp, toks, ex, S + EXTRA, step)
    got = _run_port(arch, tm, tp, toks, ex, S + EXTRA, step)
    for name, g, w in zip(_names(arch), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(f32(g), f32(w), err_msg=name, **F32_TOL)
    n = len(CACHE[arch])
    cache = dict(zip(CACHE[arch], got[n + 2:]))
    self_k = cache[CACHE[arch][0]]
    assert float(self_k[..., S, :, :].abs().max()) > 0          # the step's row
    assert float(self_k[..., S + 1:, :, :].abs().max()) == 0.0
    ctx = cache[CACHE[arch][2]]
    assert torch.equal(ctx, got[3])                               # never written by a step
    return got


def prefill_decode_bfloat16(arch):
    jcfg, tcfg, jm, tm, jp, tp = both(arch, "bfloat16")
    toks, step = tokens(jcfg.vocab, B, S, seed=4), tokens(jcfg.vocab, B, 1, seed=5)
    ex = extras(jcfg, B, seed=6)
    want = _run_jax(arch, jm, jp, toks, ex, S + EXTRA, step)
    got = _run_port(arch, tm, tp, toks, ex, S + EXTRA, step)
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    jp32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jp)
    want32 = _run_jax(arch, jget_model(jcfg32), jp32, toks, ex, S + EXTRA, step)
    for name, g, w, w32 in zip(_names(arch), got, want, want32):
        assert g.shape == w.shape, name
        assert g.dtype == (torch.float32 if "logits" in name else torch.bfloat16), name
        bound = 2.0 * float(np.abs(f32(w) - f32(w32)).max())
        err = float(np.abs(f32(g) - f32(w)).max())
        assert 0.0 < bound and err <= bound, (name, err, bound)


def _jax_greedy(jm, jp, toks, ex, gen):
    prefill = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=toks.shape[1] + gen))
    decode = jax.jit(jm.decode_step)
    logits, cache = prefill(jp, jbatch(toks, ex))
    out = []
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    for i in range(gen):
        out.append(np.asarray(tok))
        logits, cache = decode(jp, {"token": tok, "pos": jnp.asarray(toks.shape[1] + i,
                                                                     jnp.int32)}, cache)
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    return np.concatenate(out, axis=1)


def serve_greedy_tokens_float32(arch):
    """The port's generate loop with the extras in the prefill's batch, on
    the reference's weights: the reference loop's greedy tokens."""
    jcfg, tcfg, jm, tm, jp, tp = both(arch, "float32")
    toks, ex = tokens(jcfg.vocab, B, 16, seed=6), extras(jcfg, B, seed=7)
    want = _jax_greedy(jm, jp, toks, ex, 8)
    got = tserve.generate(tm, tp, torch.from_numpy(toks), 8,
                          extras={k: torch.from_numpy(v) for k, v in ex.items()})
    np.testing.assert_array_equal(got["generated"], want)


def port_model(arch, dtype, seed=0):
    """The port's SMOKE model from its own init, the VLM's gates set off
    zero (tanh 0.54 and -0.42)."""
    _, cfg = smoke(arch, dtype)
    model = tget_model(cfg)
    params = model.init_params(seed, device="cpu")
    with torch.no_grad():
        for blk in getattr(params, "cross_blocks", []):
            blk.gate_attn.fill_(0.6)
            blk.gate_mlp.fill_(-0.45)
    return cfg, model, params


def prefill_then_decode_matches_full(arch, dtype):
    """tests/test_arch_smoke.py:65-83 in the port: the decode step after
    the prefill of S tokens against the prefill of S + 1."""
    cfg, model, params = port_model(arch, dtype)
    Sp = 32
    toks = torch.from_numpy(tokens(cfg.vocab, 2, Sp + 1, seed=0).astype(np.int64))
    ex = {k: torch.from_numpy(v) for k, v in extras(cfg, 2, seed=1).items()}
    logits_pre, cache = model.prefill(params, {"tokens": toks[:, :Sp], **ex}, cache_len=Sp + 1)
    assert logits_pre.shape == (2, cfg.vocab)
    logits_dec, _ = model.decode_step(params, {"token": toks[:, Sp:Sp + 1], "pos": Sp}, cache)
    logits_full, _ = model.prefill(params, {"tokens": toks, **ex})
    np.testing.assert_allclose(f32(logits_dec), f32(logits_full), rtol=0.15, atol=0.15)


def decode_cache_shapes_stable(arch):
    """tests/test_arch_smoke.py:85-100 in the port: the reference's cache
    layout (``init_cache``), written in place at ``pos`` by a step; the
    cross or image K/V is not written by a step."""
    cfg, model, params = port_model(arch, "bfloat16")
    jshapes = jax.eval_shape(lambda: jget_model(smoke(arch)[0]).init_cache(2, 32))
    cache = model.init_cache(2, 32, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in cache.items()}
    assert shapes == {k: tuple(v.shape) for k, v in jshapes.items()}
    assert all(v.dtype == torch.bfloat16 for v in cache.values())
    logits, new_cache = model.decode_step(
        params, {"token": torch.zeros((2, 1), dtype=torch.long), "pos": 3}, cache)
    assert logits.shape == (2, cfg.vocab) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    assert {k: tuple(v.shape) for k, v in new_cache.items()} == shapes
    self_k, ctx = new_cache[CACHE[arch][0]], new_cache[CACHE[arch][2]]
    assert float(self_k[..., 3, :, :].abs().max()) > 0
    assert float(self_k[..., 4:, :, :].abs().max()) == 0.0
    assert float(ctx.abs().max()) == 0.0
    return shapes


# ---------------------------------------------------------------------------
# the parameters: layout, leaf order, ranks, conversion
# ---------------------------------------------------------------------------


def init_matches_reference_layout(arch):
    """Leaf names, shapes and dtypes of the port's init are the reference's
    (the stacks unstacked by layer, (g, l) in the VLM's groups; LayerNorms
    and gates float32), its random leaves at the reference's spread, its
    count the reference's and ``param_count``'s within 10%, repeatable from
    a seed."""
    jcfg, cfg = smoke(arch)
    jtree = jget_model(jcfg).init_params(jax.random.key(0))
    params = tget_model(cfg).init_params(torch.Generator().manual_seed(0))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        keys = [p.key for p in path]
        lead = LEAD[arch].get(keys[0], 0)
        for idx in np.ndindex(*leaf.shape[:lead]):
            want[".".join([keys[0]] + [str(i) for i in idx] + keys[1:])] = (
                leaf.shape[lead:], str(leaf.dtype), np.asarray(leaf[idx], np.float32))
    named = dict(params.named_parameters())
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in named.items()} \
        == {k: v[:2] for k, v in want.items()}
    for k, (_, _, w) in want.items():
        g = f32(named[k])
        if w.std() == 0:                     # norms, biases, gates: the reference's constants
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert abs(float(g.std()) - float(w.std())) < 0.15 * float(w.std()), k
    count = sum(v.numel() for v in params.parameters())
    assert count == sum(int(np.prod(l.shape)) for l in jax.tree.leaves(jtree))
    assert abs(count - cfg.param_count()) / count < 0.1
    again = tget_model(cfg).init_params(0, device="cpu")
    first = tget_model(cfg).init_params(0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(first.parameters(), again.parameters()))
    return named


def leaf_paths_and_ranks(arch):
    """``leaf_paths`` lists the reference's sorted tree paths, a block leaf
    layer by layer (g-major in the groups); ``ref_ndims`` gives each leaf's
    rank there.  Returns ({name: rank}, [names])."""
    jcfg, tcfg = smoke(arch, "float32")
    tp = convert.lm_params_from_jax(numpy_params(jcfg), tcfg, device="cpu")
    jp = jget_model(jcfg).init_params(jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    ref = [tuple(k.key for k in path) for path, _ in flat]
    paths = [p for _, p, _ in tlm.leaf_paths(tp)]
    assert list(dict.fromkeys(paths)) == ref
    assert list(dict.fromkeys(p[0] for p in ref)) == TOPS[arch]
    ranks = {tuple(k.key for k in path): leaf.ndim for path, leaf in flat}
    nd = tlm.ref_ndims(tp)
    for name, path, _ in tlm.leaf_paths(tp):
        assert nd[name] == ranks[path], name
    names = list(tlm.leaves(tp))
    assert names == [n for n, _, _ in tlm.leaf_paths(tp)]
    assert set(names) == {n for n, _ in tp.named_parameters()}
    return nd, names, {n: l for n, _, l in tlm.leaf_paths(tp)}


def convert_round_trip(arch):
    """The numpy tree into the port and back: every float32 leaf exactly,
    every bfloat16 one as its bfloat16 value; the LayerNorms and gates
    float32 in either model dtype."""
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = smoke(arch, dtype)
        tree = numpy_params(jcfg)
        tp = convert.lm_params_from_jax(tree, tcfg, device="cpu")
        named = dict(tp.named_parameters())
        for name, p in named.items():
            last = name.split(".")[-1]
            if last in ("w", "b") or "gate_" in last or last in ("ln1", "ln2", "final_norm"):
                assert p.dtype == torch.float32, name
            elif last in ("wq", "w1", "tok_emb", "dec_pos", "lm_head"):
                assert p.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        back = convert.lm_params_to_jax(tp)
        flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_b = dict((tuple(k.key for k in p), v)
                      for p, v in jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(flat_a) == len(flat_b)
        for p, v in flat_a:
            key = tuple(k.key for k in p)
            got = flat_b[key]
            assert got.dtype == np.float32 and got.shape == v.shape, key
            if dtype == "float32" or key[-1] in convert.F32_LEAVES:
                np.testing.assert_array_equal(got, v)
            else:        # the bfloat16 value of each float32 entry, exactly
                np.testing.assert_array_equal(
                    got, np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32))


def train_state_tree_has_the_reference_keys(arch):
    jcfg, tcfg, jm, tm, jp, tp = both(arch, "bfloat16")
    jtree = {"params": jp, "opt": joptim.init(jp, joptim.AdamWConfig())}
    ttree = convert.train_state_to_jax(tp, optim.init(tlm.leaves(tp), optim.AdamWConfig()))
    keys = convert.train_state_keys(tp)

    def flat(t):
        return {"/".join(str(getattr(k, "key", k)) for k in p): v
                for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}

    fj, ft = flat(jtree), flat(ttree)
    assert set(fj) == set(ft) == set(flat(keys))
    for k, v in fj.items():
        assert tuple(ft[k].shape) == tuple(v.shape), k
        assert str(ft[k].dtype).replace("torch.", "") == str(v.dtype), k
    return ft


# ---------------------------------------------------------------------------
# training: loss_fn, gradients, train steps, remat
# ---------------------------------------------------------------------------


def _stream(arch, seq=SEQ, batch=B):
    return JStream(vocab=smoke(arch)[0].vocab, seq=seq, global_batch=batch, seed=0)


def loss_fn_matches_jax_float32(arch):
    jcfg, tcfg, jm, tm, jp, tp = both(arch, "float32")
    toks, ex = np.asarray(_stream(arch).batch(0)["tokens"]), extras(jcfg, B, seed=8)
    jl_, jmet = jax.jit(jm.loss_fn)(jp, jbatch(toks, ex))
    tl_, tmet = tm.loss_fn(tp, tbatch(toks, ex))
    assert set(tmet) == set(jmet)
    assert tl_.grad_fn is None
    np.testing.assert_allclose(float(tl_), float(jl_), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["tokens"]), float(jmet["tokens"]))


def first_step_gradients_match_jax_float32(arch, watch):
    """Every leaf's gradient within 1e-5 of the leaf's largest entry, or
    within twice the JAX package's own float32 distance where that is
    larger: its gradient taken as the mean of the two examples' gradients
    (the same sum in another order) against its whole-batch one.  A cross
    block's gate is one entry, the sum over every token and channel of the
    gated branch times the loss's gradient there, which cancels to ~1e-4
    of its terms, so its float32 error is relative to the terms and not
    to the sum.  The ``watch`` leaves' gradients are not zero."""
    jcfg, tcfg, jm, tm, jp, tp = both(arch, "float32")
    toks, ex = np.asarray(_stream(arch).batch(0)["tokens"]), extras(jcfg, B, seed=9)

    def jgrad(t, e):
        return jax.grad(lambda p: jm.loss_fn(p, jbatch(t, e))[0])(jp)

    jg = jgrad(toks, ex)
    halves = [jgrad(toks[i:i + 1], {k: v[i:i + 1] for k, v in ex.items()}) for i in range(B)]
    witness = jax.tree.map(lambda w, a, b: np.abs(f32(w) - (f32(a) + f32(b)) / 2).max(),
                           jg, *halves)
    with tlm.trainable(tp):
        loss, _ = tm.loss_fn(tp, tbatch(toks, ex))
        named = tlm.leaves(tp)
        tg = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    for name, path, layer in tlm.leaf_paths(tp):
        want = f32(_at(jg, path))
        want = want if layer is None else want[layer]
        scale = max(float(np.abs(want).max()), 1e-30)
        tol = max(1e-5 * scale, 2.0 * float(_at(witness, path)))
        err = float(np.abs(f32(tg[name]) - want).max())
        assert err <= tol, (name, err, tol, scale)
    for name in watch:
        assert float(tg[name].abs().max()) > 0, name


def _jax_state(tp, to, jcfg):
    tree = convert.train_state_to_jax(tp, to)
    opt = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree["opt"])
    return jax_params(convert.lm_params_to_jax(tp), jcfg), opt


def three_train_steps_match_jax_float32(arch):
    """Three ``make_train_step`` steps on batches that carry the extras,
    each held against the reference's step from the same parameters and
    AdamW state (the port's before it): its loss, grad norm and lr at rtol
    1e-5 and the parameters after it at ``adamw_gate``.  A straight run is
    not held: AdamW moves an entry whose gradient sits at the float32 noise
    of its sum by up to a whole lr, as ``adamw_gate`` allows, and the later
    steps' gradients move with it."""
    jcfg, tcfg, jm, tm, jp, tp = both(arch, "float32")
    jocfg = joptim.AdamWConfig(lr=joptim.warmup_cosine(LR, 2, 50))
    tocfg = optim.AdamWConfig(lr=optim.warmup_cosine(LR, 2, 50))
    tstep = make_train_step(tm, tocfg)
    to = optim.init(tlm.leaves(tp), tocfg)
    before = {k: v.clone() for k, v in tlm.leaves(tp).items()}
    ex = extras(jcfg, B, seed=10)
    js = WithExtras(_stream(arch), ex, port=False)
    ts = WithExtras(TokenStream(vocab=tcfg.vocab, seq=SEQ, global_batch=B, seed=0), ex, True)
    for s in range(3):
        jps, jos = (jp, None) if s == 0 else _jax_state(tp, to, jcfg)
        want, _, jmets, jgrads = jax_train_run(jm, jps, jocfg, js, 1, opt_state=jos, start=s)
        out, to, m = tstep(tp, to, ts.batch(s))
        assert out is tp and int(to["step"]) == s + 1
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jmets[0][k]), rtol=1e-5,
                                       err_msg=f"step {s} {k}")
        assert_params_within(convert.lm_params_to_jax(tp), want, adamw_gate(want, jmets, jgrads))
    assert all(not torch.equal(before[k], v) for k, v in tlm.leaves(tp).items())
    assert not any(p.requires_grad for p in tp.parameters())


def bfloat16_train_step_keeps_the_float32_leaves(arch, watch):
    """AdamW's clip and update take the float32 leaves (``watch``: norms,
    LayerNorms, gates) beside the bfloat16 ones: they and their moments
    stay float32 and move."""
    jcfg, tcfg, _, tm, _, tp = both(arch, "bfloat16")
    ocfg = optim.AdamWConfig(lr=optim.warmup_cosine(LR, 2, 50))
    to = optim.init(tlm.leaves(tp), ocfg)
    named = tlm.leaves(tp)
    before = {k: named[k].detach().clone() for k in watch}
    assert all(to["mu"][k]["m"].dtype == torch.float32 for k in watch)
    step = make_train_step(tm, ocfg)
    ts = WithExtras(TokenStream(vocab=tcfg.vocab, seq=SEQ, global_batch=B, seed=0),
                    extras(jcfg, B, seed=11), True)
    for s in range(3):
        _, to, m = step(tp, to, ts.batch(s))
        assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    for k in watch:
        assert named[k].dtype == torch.float32 and not torch.equal(before[k], named[k]), k


def remat_on_and_off_agree(arch, dtype, module, fn_name, n_calls):
    """Per-block checkpointing: loss and every gradient bitwise equal with
    and without it; ``module.checkpoint`` called ``n_calls`` times on
    ``fn_name`` with it."""
    jcfg, tcfg, _, _, _, tp = both(arch, dtype)
    batch = tbatch(np.asarray(_stream(arch).batch(1)["tokens"]), extras(jcfg, B, seed=12))
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        calls = []
        orig = module.checkpoint

        def spy(f, *a, **kw):
            calls.append(f.__name__)
            return orig(f, *a, **kw)

        module.checkpoint = spy
        try:
            with tlm.trainable(tp):
                loss, _ = module.loss_fn(tp, batch, cfg)
                grads = torch.autograd.grad(loss, list(tlm.leaves(tp).values()))
        finally:
            module.checkpoint = orig
        assert calls.count(fn_name) == (n_calls if remat else 0), calls
        out.append((loss, grads))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the loop's checkpoints across packages
# ---------------------------------------------------------------------------


def _lm(arch):
    jcfg, tcfg, jm, tm, jp, tp = both(arch, "float32")
    jo = joptim.AdamWConfig(lr=joptim.warmup_cosine(LR, 2, 50))
    to = optim.AdamWConfig(lr=optim.warmup_cosine(LR, 2, 50))
    ex = extras(jcfg, B, seed=13)
    return (jm, tm, jp, tp, jo, to, WithExtras(_stream(arch, LOOP_SEQ), ex, False),
            WithExtras(TokenStream(vocab=tcfg.vocab, seq=LOOP_SEQ, global_batch=B, seed=0), ex,
                       True))


def _jax_run(jm, jp, jo, js, steps, ckpt_dir=None):
    loop = JLoopConfig(steps=steps, ckpt_every=1000, ckpt_dir=ckpt_dir and str(ckpt_dir),
                       log_every=1000, handle_signals=False, async_ckpt=False)
    return jtrain_loop(jax.jit(jmake_train_step(jm, jo)), jp, joptim.init(jp, jo), js.batch,
                       loop, **QUIET)


def _port_run(tm, tp, to, ts, steps, ckpt_dir=None, **kw):
    loop = TrainLoopConfig(steps=steps, ckpt_dir=ckpt_dir and str(ckpt_dir),
                           log_every=1000, handle_signals=False, **kw)
    return train_loop(make_train_step(tm, to), tp, optim.init(tlm.leaves(tp), to), ts.batch,
                      loop, **QUIET)


def jax_checkpoint_resumes_in_the_port(arch, tmp_path):
    """The JAX package's loop writes step 3; the port restores it and runs
    to step 6: the JAX package's run straight to 6."""
    jm, tm, jp, tp, jo, to, js, ts = _lm(arch)
    want, _, mets, grads = jax_train_run(jm, jp, jo, js, 6)
    d = tmp_path / "ck"
    _jax_run(jm, jp, jo, js, 3, d)
    assert checkpoint.latest_step(d) == 3
    logs = []
    pb, ob, rep = train_loop(
        make_train_step(tm, to), tp, optim.init(tlm.leaves(tp), to), ts.batch,
        TrainLoopConfig(steps=6, ckpt_dir=str(d), log_every=1000, handle_signals=False),
        log_fn=logs.append)
    assert "[restore] resumed from step 3" in logs and rep["final_step"] == 6
    assert int(ob["step"]) == 6
    assert_params_within(convert.lm_params_to_jax(pb), want, adamw_gate(want, mets, grads))


def port_checkpoint_resumes_in_jax(arch, tmp_path):
    """The port's loop writes step 3; the JAX package's loop restores it
    and runs to step 6: its own run straight to 6."""
    jm, tm, jp, tp, jo, to, js, ts = _lm(arch)
    want, _, mets, grads = jax_train_run(jm, jp, jo, js, 6)
    d = tmp_path / "ck"
    _port_run(tm, tp, to, ts, 3, d)
    assert jcheckpoint.latest_step(d) == 3
    got, jopt, rep = _jax_run(jm, jp, jo, js, 6, d)
    assert rep["final_step"] == 6 and int(jopt["step"]) == 6
    assert_params_within(jax.tree.map(lambda a: np.asarray(a, np.float32), got), want,
                         adamw_gate(want, mets, grads))


def train_loop_restart_is_bitwise(arch):
    """On the CPU a restart from the loop's checkpoint is the straight run
    bit for bit: 4 steps straight against 2, a fresh model restored, 2
    more."""
    runs = []
    for split in (None, 2):
        _, tm, _, tp, _, to, _, ts = _lm(arch)
        with tempfile.TemporaryDirectory() as d:
            if split:
                _port_run(tm, tp, to, ts, split, d)
                _, tm, _, tp, _, to, _, ts = _lm(arch)
            p, o, rep = _port_run(tm, tp, to, ts, 4, d)
        assert rep["final_step"] == 4
        runs.append((p, o))
    (pa, oa), (pb, ob) = runs
    for k, v in tlm.leaves(pa).items():
        assert torch.equal(v, tlm.leaves(pb)[k]), k
        assert torch.equal(oa["mu"][k]["v"], ob["mu"][k]["v"]), k


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def serve_and_train_clis_on_the_cpu(arch, capsys):
    r = tserve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "8",
                     "--gen", "3", "--device", "cpu"])
    assert r["generated"].shape == (2, 3)
    rep = ttrain.main(["--device", "cpu", "--arch", arch, "--smoke", "--steps", "3",
                       "--batch", "2", "--seq", "32"])
    assert rep["final_step"] == 3 and np.isfinite(rep["history"][0]["loss"])
    out = capsys.readouterr().out
    assert "ms/tok" in out and "first_loss=" in out


def build_and_serve_draw_the_reference_extras(arch):
    """``launch.train.build``'s extras are the reference build's bit for bit
    (float32 standard normals from numpy's generator at the seed, then
    bfloat16), on every batch of the stream; ``serve`` draws the prompt,
    then the extras, from one generator as the reference's serve does."""
    jcfg, tcfg = smoke(arch)
    key = EXTRA_KEY[arch]
    built = ttrain.build(arch, smoke=True, batch=2, seq=16, lr=1e-3, seed=3, device="cpu")
    jbuilt = jbuild(arch, smoke=True, batch=2, seq=16, lr=1e-3, seed=3)
    ex, jex = built[6], jbuilt[6]
    assert set(ex) == set(jex) == {key}
    assert ex[key].dtype == torch.bfloat16 and ex[key].shape == jex[key].shape
    np.testing.assert_array_equal(f32(ex[key]), f32(jex[key]))
    assert built[5].batch(1, ex, device="cpu")[key] is ex[key]
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    toks = rng.integers(0, tcfg.vocab, size=(2, 8))
    drawn = tserve.draw_extras(tcfg, 2, rng)
    jtoks = jrng.integers(0, jcfg.vocab, size=(2, 8))
    n = jcfg.enc_len if arch == AUDIO else jcfg.n_img_tokens
    want = jnp.asarray(jrng.standard_normal((2, n, jcfg.d_model)), jnp.bfloat16)
    np.testing.assert_array_equal(toks, jtoks)
    np.testing.assert_array_equal(f32(drawn[key]), f32(want))
    return built


def entry_points_default_to_the_card(arch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    _, cfg = smoke(arch)
    model = tget_model(cfg)
    for call in (lambda: tserve.serve(arch, smoke=True, batch=1, prompt_len=4, gen=1),
                 lambda: model.init_params(0), lambda: model.init_cache(1, 4),
                 lambda: ttrain.build(arch, smoke=True, batch=1, seq=8, lr=1e-3)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()

