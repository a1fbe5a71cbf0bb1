"""The port's MLA family (``repro_torch.models.lm`` with
``repro_torch.models.mla`` and ``repro_torch.models.moe``, through
``get_model``) against the JAX package's on one set of weights, on
deepseek-v3's SMOKE config (3 layers, the first dense, d 64, 4 heads,
kv_lora 16, rope 8, 8 experts top-2 and one shared, MTP depth 1,
capacity factor 8): forward with its aux loss, ``prefill`` (logits and
both latent caches), ``decode_step``, greedy serving, ``loss_fn`` with its
MTP term (and without it, at ``mtp_depth=0``), the first step's gradients
on every leaf and three ``make_train_step`` steps, remat, ``leaf_paths``
in the reference's tree order and ``ref_ndims`` at its ranks, the
parameters carried both ways, and train-loop checkpoints resumed across
packages.  Biases and norm weights (``q_ln``, ``kv_ln``, ``mtp_norm_h``,
``mtp_norm_e`` among them) are seeded random values
(``test_torch_lm_common``).

Gates, those of the dense and MoE family files: float32 at rtol 1e-4 /
atol 1e-5 (``tests/test_torch_lm.py``), bfloat16 at twice the JAX
package's own bfloat16-vs-float32 distance, the loss, grad norm and lr at
rtol 1e-5 and the gradients within 1e-5 of each leaf's largest entry, the
parameters after AdamW steps at ``test_torch_lm_common.adamw_gate``
(``tests/test_torch_train.py``); prefill(S) + decode(S) against
prefill(S + 1) at rtol = atol = 0.15 (``tests/test_arch_smoke.py:65-83``).
"""
import dataclasses

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
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
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
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.runtime import TrainLoopConfig, train_loop  # noqa: E402

ARCH = "deepseek-v3-671b"
F32_TOL = dict(rtol=1e-4, atol=1e-5)
B, S, EXTRA = 2, 40, 4
SEQ, LR = 80, 3e-3              # SEQ = 2 chunks of 32 + a remainder of 16
QUIET = dict(log_fn=lambda s: None)
CACHE = ("latent_dense", "latent_moe")
MTP_LEAVES = ("mtp_blocks", "mtp_norm_e", "mtp_norm_h", "mtp_proj")


def _leaf_close(got, want, rel=1e-5, what=""):
    got, want = f32(got), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# serving: prefill, decode, the latent caches, forward and its aux
# ---------------------------------------------------------------------------


def _run_jax(jm, jp, toks, S_cap, step_tok):
    logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=S_cap))(
        jp, {"tokens": jnp.asarray(toks)})
    dlogits, dcache = jax.jit(jm.decode_step)(
        jp, {"token": jnp.asarray(step_tok), "pos": jnp.asarray(toks.shape[1], jnp.int32)},
        cache)
    return [logits] + [cache[k] for k in CACHE] + [dlogits] + [dcache[k] for k in CACHE]


def _run_port(tm, tp, toks, S_cap, step_tok):
    logits, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=S_cap)
    assert set(cache) == set(CACHE)
    out = [logits] + [cache[k].clone() for k in CACHE]
    dlogits, dcache = tm.decode_step(
        tp, {"token": torch.from_numpy(step_tok), "pos": toks.shape[1]}, cache)
    assert dcache is cache
    return out + [dlogits] + [dcache[k] for k in CACHE]


NAMES = ("prefill logits", "prefill latent_dense", "prefill latent_moe", "decode logits",
         "decode latent_dense", "decode latent_moe")


def test_mla_lm_float32_prefill_decode_and_cache():
    jcfg, tcfg, jm, tm, jp, tp = both(ARCH, "float32")
    toks = tokens(jcfg.vocab, B, S, seed=1)
    step = tokens(jcfg.vocab, B, 1, seed=2)
    want = _run_jax(jm, jp, toks, S + EXTRA, step)
    got = _run_port(tm, tp, toks, S + EXTRA, step)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(f32(g), f32(w), err_msg=name, **F32_TOL)
    # (layers, B, S_cap, kv_lora + rope); the positions after the step zero
    lat = got[4]
    assert tuple(lat.shape) == (tcfg.moe_layer_start, B, S + EXTRA,
                                tcfg.kv_lora_rank + tcfg.qk_rope_dim)
    assert float(got[5][:, :, S + 1:].abs().max()) == 0.0


class _Routes:
    """While active, records each MoE call's ordered top-k in both packages,
    in call order, and the JAX package's float32 router probabilities (its
    calls run under ``jit`` and ``scan``: an ordered ``jax.debug.callback``
    reads them)."""

    def __enter__(self):
        self.j, self.t = [], []
        self._j, self._t = jmoe._route, tmoe._route

        def jroute(p, x, cfg):
            out = self._j(p, x, cfg)
            probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"].astype(jnp.float32),
                                   axis=-1)
            jax.debug.callback(lambda ti, pr: self.j.append((np.asarray(ti), np.asarray(pr))),
                               out[1], probs, ordered=True)
            return out

        def troute(p, x, cfg):
            out = self._t(p, x, cfg)
            self.t.append(out[1].numpy())
            return out

        jmoe._route, tmoe._route = jroute, troute
        return self

    def __exit__(self, *exc):
        jmoe._route, tmoe._route = self._j, self._t
        return False


def _flip_margin(pr16, pr32, t, a, b):
    """Twice the JAX package's own bfloat16-vs-float32 distance of the gap
    between token t's router probabilities of experts a and b (the
    entries where the two packages' ordered top-k differ): how far one
    bfloat16 run of the reference moves that gap from its float32 run."""
    gap16 = pr16[t, a] - pr16[t, b]
    gap32 = pr32[t, a] - pr32[t, b]
    return 2.0 * float(np.abs(gap16 - gap32).max())


def test_mla_lm_bfloat16_prefill_decode_and_cache():
    """bfloat16 at twice the JAX package's own bfloat16-vs-float32 distance.
    The packages round the MoE layers' inputs apart by an ulp here and
    there, so where a token's k-th and (k+1)-th router probabilities lie
    within the reference's own bfloat16 noise the two may route it to
    different experts.  Each such flip is required to sit at a near-tie: the
    gap of the two experts' probabilities no larger than twice the JAX
    package's bfloat16-vs-float32 distance of that gap, for that token and
    layer (``_flip_margin``; the token's later layers
    then route from inputs that differ), and the entries it feeds (the
    token's cache rows in the later layers; its row of the logits at the
    last position or in the decode step) are the only ones not held at the
    gate; at most 5% of the routings may flip (4 of 164 here)."""
    jcfg, tcfg, jm, tm, jp, tp = both(ARCH, "bfloat16")
    toks = tokens(jcfg.vocab, B, S, seed=3)
    step = tokens(jcfg.vocab, B, 1, seed=4)
    with _Routes() as r:
        want = _run_jax(jm, jp, toks, S + EXTRA, step)
        got = _run_port(tm, tp, toks, S + EXTRA, step)
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    jp32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jp)
    with _Routes() as r32:
        want32 = _run_jax(jget_model(jcfg32), jp32, toks, S + EXTRA, step)
    # the reference's prefill routes each MoE layer twice (forward, then the
    # cache pass, on the same inputs), the port's once; then the step's
    n = tcfg.n_layers - tcfg.moe_layer_start
    assert len(r.j) == 3 * n and len(r.t) == 2 * n
    for a, b in zip(r.j[:n], r.j[n:2 * n]):
        np.testing.assert_array_equal(a[0], b[0])
    skip = [np.zeros(g.shape, bool) for g in got]
    flipped = set()              # (call stage, token): routed apart before
    assert len(r32.j) == 3 * n
    for i, ((jt, pr), (_, pr32), tt) in enumerate(zip(r.j[:n] + r.j[2 * n:],
                                                       r32.j[:n] + r32.j[2 * n:], r.t)):
        for t in np.nonzero(np.any(jt != tt, axis=1))[0]:
            if (i // n, int(t)) in flipped:
                continue         # its input already differs: a later layer
            apart = jt[t] != tt[t]
            a, b_ = jt[t][apart], tt[t][apart]
            margin = float(np.abs(pr[t, a] - pr[t, b_]).max())
            allowed = _flip_margin(pr, pr32, t, a, b_)
            assert margin <= allowed, (i, int(t), jt[t], tt[t], margin, allowed)
            flipped.add((i // n, int(t)))
            layer = i % n
            if i < n:                       # the prefill: token (b, s)
                b, s_ = divmod(int(t), S)
                skip[2][layer + 1:, b, s_] = True
                skip[5][layer + 1:, b, s_] = True
                if s_ == S - 1:
                    skip[0][b] = True
                    skip[3][b] = True
            else:                           # the decode step: row t
                skip[5][layer + 1:, int(t), S] = True
                skip[3][int(t)] = True
    routings = sum(len(tt) for tt in r.t)
    assert len(flipped) <= 0.05 * routings, (flipped, routings)
    for name, g, w, w32, sk in zip(NAMES, got, want, want32, skip):
        assert g.shape == w.shape, name
        assert g.dtype == (torch.float32 if "logits" in name else torch.bfloat16), name
        bound = 2.0 * float(np.abs(f32(w) - f32(w32)).max())
        err = float(np.where(sk, 0.0, np.abs(f32(g) - f32(w))).max())
        assert 0.0 < bound and err <= bound, (name, err, bound, int(sk.sum()))


def test_mla_forward_and_aux_match_jax_float32():
    """The final hidden states and the aux loss: the MoE stack's layers
    summed in layer order, the dense stack adding none."""
    jcfg, tcfg, jm, tm, jp, tp = both(ARCH, "float32")
    toks = tokens(jcfg.vocab, B, S, seed=5)
    jh, jaux = jax.jit(lambda p, b: jlm.forward(p, b, jcfg))(jp, {"tokens": jnp.asarray(toks)})
    th, taux = tlm.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(f32(th), f32(jh), **F32_TOL)
    assert taux.dtype == torch.float32 and float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    calls = []
    orig = tmoe.moe_dispatch

    def spy(p, x, cfg):
        y, a = orig(p, x, cfg)
        calls.append(a)
        return y, a

    tmoe.moe_dispatch = spy
    try:
        _, again = tlm.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    finally:
        tmoe.moe_dispatch = orig
    assert len(calls) == tcfg.n_layers - tcfg.moe_layer_start
    total = torch.zeros((), dtype=torch.float32)
    for a in calls:
        total = total + a
    assert torch.equal(again, total) and torch.equal(again, taux)


def _jax_greedy(jm, jp, toks, gen):
    prefill = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=toks.shape[1] + gen))
    decode = jax.jit(jm.decode_step)
    logits, cache = prefill(jp, {"tokens": jnp.asarray(toks)})
    out = []
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    for i in range(gen):
        out.append(np.asarray(tok))
        logits, cache = decode(jp, {"token": tok, "pos": jnp.asarray(toks.shape[1] + i,
                                                                     jnp.int32)}, cache)
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    return np.concatenate(out, axis=1)


def test_mla_serve_greedy_tokens_float32():
    """The port's generate loop on the reference's weights: the reference
    loop's greedy tokens, token for token (the absorbed form at every
    step)."""
    jcfg, tcfg, jm, tm, jp, tp = both(ARCH, "float32")
    toks = tokens(jcfg.vocab, B, 16, seed=6)
    want = _jax_greedy(jm, jp, toks, 8)
    got = tserve.generate(tm, tp, torch.from_numpy(toks), 8)
    np.testing.assert_array_equal(got["generated"], want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mla_prefill_then_decode_matches_full_forward(dtype):
    """tests/test_arch_smoke.py:65-83 in the port, on the port's own init:
    the absorbed step after the expanded prefill against the expanded
    prefill of one more token."""
    _, cfg = smoke(ARCH, dtype)
    model = tget_model(cfg)
    params = model.init_params(0, device="cpu")
    Sp = 32
    toks = torch.from_numpy(tokens(cfg.vocab, 2, Sp + 1, seed=0).astype(np.int64))
    logits_pre, cache = model.prefill(params, {"tokens": toks[:, :Sp]}, cache_len=Sp + 1)
    assert logits_pre.shape == (2, cfg.vocab)
    logits_dec, _ = model.decode_step(params, {"token": toks[:, Sp:Sp + 1], "pos": Sp}, cache)
    logits_full, _ = model.prefill(params, {"tokens": toks})
    np.testing.assert_allclose(f32(logits_dec), f32(logits_full), rtol=0.15, atol=0.15)


def test_mla_decode_cache_shapes_stable():
    """tests/test_arch_smoke.py:85-100 in the port."""
    _, cfg = smoke(ARCH)
    model = tget_model(cfg)
    params = model.init_params(0, device="cpu")
    cache = model.init_cache(2, 32, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in cache.items()}
    W = cfg.kv_lora_rank + cfg.qk_rope_dim
    assert shapes == {"latent_dense": (cfg.moe_layer_start, 2, 32, W),
                      "latent_moe": (cfg.n_layers - cfg.moe_layer_start, 2, 32, W)}
    assert all(v.dtype == torch.bfloat16 for v in cache.values())
    logits, new_cache = model.decode_step(
        params, {"token": torch.zeros((2, 1), dtype=torch.long), "pos": 3}, cache)
    assert logits.shape == (2, cfg.vocab) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    assert {k: tuple(v.shape) for k, v in new_cache.items()} == shapes
    for k in CACHE:
        assert float(new_cache[k][:, :, 3].abs().max()) > 0
        assert float(new_cache[k][:, :, 4:].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the parameters: layout, leaf order, ranks, conversion
# ---------------------------------------------------------------------------


def test_mla_init_matches_reference_layout():
    """Leaf names, shapes and dtypes of the port's init are the reference's
    (the three stacks unstacked, the MTP head, the norms float32), and so
    is the count, within 10% of ``param_count``."""
    jcfg, cfg = smoke(ARCH)
    jtree = jget_model(jcfg).init_params(jax.random.key(0))
    params = tget_model(cfg).init_params(torch.Generator().manual_seed(0))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        keys = [p.key for p in path]
        if keys[0].endswith("blocks"):
            for l in range(leaf.shape[0]):
                want[".".join([keys[0], str(l)] + keys[1:])] = (leaf.shape[1:], str(leaf.dtype))
        else:
            want[".".join(keys)] = (leaf.shape, str(leaf.dtype))
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in params.named_parameters()}
    assert got == want
    for name in ("dense_blocks.0.attn.q_ln", "moe_blocks.1.attn.kv_ln", "mtp_norm_h",
                 "mtp_blocks.0.moe.router"):
        assert got[name][1] == "float32", name
    assert got["mtp_proj"] == ((2 * cfg.d_model, cfg.d_model), "bfloat16")
    assert isinstance(params.dense_blocks[0], tlm.MLADenseBlock)
    assert isinstance(params.moe_blocks[0], tlm.MLAMoEBlock)
    assert isinstance(params.mtp_blocks[0], tlm.MLAMoEBlock)
    assert not hasattr(params, "blocks")
    count = sum(v.numel() for v in params.parameters())
    assert count == sum(int(np.prod(l.shape)) for l in jax.tree.leaves(jtree))
    assert abs(count - cfg.param_count()) / count < 0.1
    again = tget_model(cfg).init_params(0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tlm.init_params(0, cfg, "cpu").parameters(),
                                                 again.parameters()))


@pytest.mark.parametrize("mtp_depth", [1, 0])
def test_mla_leaf_paths_and_ranks_follow_the_reference_tree(mtp_depth):
    """``leaf_paths`` lists the reference's sorted tree paths (the stacks
    and the MTP leaves interleaved by name), a block leaf layer by layer;
    ``ref_ndims`` gives each leaf's rank there, so AdamW's ``ndim >= 2``
    rule decays a stacked ``q_ln`` and not ``mtp_norm_h``."""
    jcfg, tcfg = smoke(ARCH, "float32")
    jcfg = dataclasses.replace(jcfg, mtp_depth=mtp_depth)
    tcfg = dataclasses.replace(tcfg, mtp_depth=mtp_depth)
    tp = convert.lm_params_from_jax(numpy_params(jcfg), tcfg, device="cpu")
    jp = jget_model(jcfg).init_params(jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    ref = [tuple(k.key for k in path) for path, _ in flat]
    paths = [p for _, p, _ in tlm.leaf_paths(tp)]
    assert list(dict.fromkeys(paths)) == ref
    tops = list(dict.fromkeys(p[0] for p in ref))
    assert tops == (["dense_blocks", "final_norm", "lm_head", "moe_blocks"]
                    + (["mtp_blocks", "mtp_norm_e", "mtp_norm_h", "mtp_proj"] if mtp_depth
                       else []) + ["tok_emb"])
    attn = [p[-1] for p in ref if p[:2] == ("moe_blocks", "attn")]
    assert attn == ["kv_ln", "q_ln", "wkv_a", "wkv_b", "wo", "wq_a", "wq_b"]
    ranks = {tuple(k.key for k in path): leaf.ndim for path, leaf in flat}
    nd = tlm.ref_ndims(tp)
    for name, path, _ in tlm.leaf_paths(tp):
        assert nd[name] == ranks[path], name
    names = list(tlm.leaves(tp))
    i = names.index("moe_blocks.0.attn.q_ln")
    assert names[i:i + 2] == ["moe_blocks.0.attn.q_ln", "moe_blocks.1.attn.q_ln"]
    assert nd["dense_blocks.0.attn.q_ln"] == 2
    if mtp_depth:
        assert nd["mtp_norm_h"] == 1 and nd["mtp_proj"] == 2
        assert nd["mtp_blocks.0.moe.wg"] == 4


def test_mla_convert_round_trip():
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = smoke(ARCH, dtype)
        tree = numpy_params(jcfg)
        tp = convert.lm_params_from_jax(tree, tcfg, device="cpu")
        for name in ("q_ln", "kv_ln"):
            assert tp.moe_blocks[0]["attn"][name].dtype == torch.float32
        assert tp.mtp_norm_e.dtype == torch.float32
        assert tp.mtp_proj.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        back = convert.lm_params_to_jax(tp)
        flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_b = dict((tuple(k.key for k in p), v)
                      for p, v in jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(flat_a) == len(flat_b)
        for p, v in flat_a:
            key = tuple(k.key for k in p)
            got = flat_b[key]
            assert got.dtype == np.float32 and got.shape == v.shape
            if dtype == "float32" or key[-1] in convert.F32_LEAVES:
                np.testing.assert_array_equal(got, v)
            else:        # the bfloat16 value of each float32 entry, exactly
                np.testing.assert_array_equal(
                    got, np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32))


def test_mla_train_state_tree_has_the_reference_keys():
    jcfg, tcfg, jm, tm, jp, tp = both(ARCH, "bfloat16")
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
    assert str(ft["opt/mu/mtp_norm_h/m"].dtype) == "torch.float32"
    assert str(ft["opt/mu/moe_blocks/attn/kv_ln/v"].dtype) == "torch.float32"


# ---------------------------------------------------------------------------
# training: loss_fn with its MTP term, gradients, train steps, remat
# ---------------------------------------------------------------------------


def _stream(seq=SEQ, batch=B):
    return JStream(vocab=smoke(ARCH)[0].vocab, seq=seq, global_batch=batch, seed=0)


def test_mla_loss_fn_matches_jax_float32():
    jcfg, tcfg, jm, tm, jp, tp = both(ARCH, "float32")
    toks = np.asarray(_stream().batch(0)["tokens"])
    jl_, jmet = jax.jit(jm.loss_fn)(jp, {"tokens": jnp.asarray(toks)})
    tl_, tmet = tm.loss_fn(tp, {"tokens": torch.tensor(toks)})
    assert set(tmet) == {"loss", "aux", "tokens"}
    assert tl_.grad_fn is None and float(tmet["aux"]) > 0
    np.testing.assert_allclose(float(tl_), float(jl_), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["aux"]), float(jmet["aux"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["tokens"]), float(jmet["tokens"]))
    # the MTP blocks' aux is in the aux: more than forward's
    _, h_aux = tlm.forward(tp, {"tokens": torch.tensor(toks)}, tcfg)
    assert float(tmet["aux"]) > float(h_aux) > 0


def test_mla_mtp_term_is_what_differs_at_depth_0():
    """The same weights without the MTP head (``mtp_depth=0``): both
    packages' losses agree there too, and the loss with MTP less the loss
    without it is, in both, the MTP term (0.1 of its cross-entropy, plus
    its blocks' aux)."""
    jcfg, tcfg, jm, tm, jp, tp = both(ARCH, "float32")
    toks = np.asarray(_stream().batch(0)["tokens"])
    jcfg0 = dataclasses.replace(jcfg, mtp_depth=0)
    tcfg0 = dataclasses.replace(tcfg, mtp_depth=0)
    tree0 = {k: v for k, v in numpy_params(jcfg).items() if k not in MTP_LEAVES}
    jp0 = jax_params(tree0, jcfg0)
    tp0 = convert.lm_params_from_jax(tree0, tcfg0, device="cpu")
    assert not hasattr(tp0, "mtp_blocks") and not hasattr(tp0, "mtp_proj")
    jl1 = float(jax.jit(jm.loss_fn)(jp, {"tokens": jnp.asarray(toks)})[0])
    jl0 = float(jax.jit(jget_model(jcfg0).loss_fn)(jp0, {"tokens": jnp.asarray(toks)})[0])
    tl1, m1 = tm.loss_fn(tp, {"tokens": torch.tensor(toks)})
    tl0, m0 = tget_model(tcfg0).loss_fn(tp0, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(float(tl0), jl0, rtol=1e-5)
    # the MTP term by itself, from the port's own pieces
    labels = torch.tensor(toks)
    h, _ = tlm.forward(tp, {"tokens": labels}, tcfg)
    labels = torch.cat([labels[:, 1:], torch.zeros_like(labels[:, :1])], dim=1)
    emb_next = tp.tok_emb[labels].to(h.dtype)
    cat = torch.cat([tlm.layers.rmsnorm(h, tp.mtp_norm_h, tcfg.norm_eps),
                     tlm.layers.rmsnorm(emb_next, tp.mtp_norm_e, tcfg.norm_eps)], dim=-1)
    hm, a_mtp = tlm._run_stack(tp.mtp_blocks, cat @ tp.mtp_proj, tcfg)
    labels2 = torch.cat([labels[:, 1:], torch.zeros_like(labels[:, :1])], dim=1)
    mask2 = torch.ones(labels.shape, dtype=torch.float32)
    mask2[:, -2:] = 0.0
    l2, c2 = tlm.xent_chunked(hm, tp.lm_head, labels2, mask2, tcfg.logits_chunk)
    assert float(c2) == B * (SEQ - 2)
    term = float(0.1 * l2 / c2 + a_mtp)
    assert term > 0
    np.testing.assert_allclose(float(tl1) - float(tl0), term, rtol=1e-4)
    np.testing.assert_allclose(jl1 - jl0, term, rtol=1e-4)
    np.testing.assert_allclose(float(m1["aux"]) - float(m0["aux"]), float(a_mtp), rtol=1e-4)


def test_mla_first_step_gradients_match_jax_float32():
    """Every leaf's gradient, the MTP head's and the MLA norms' included."""
    jcfg, tcfg, jm, tm, jp, tp = both(ARCH, "float32")
    toks = np.asarray(_stream().batch(0)["tokens"])
    jg = jax.grad(lambda p: jm.loss_fn(p, {"tokens": jnp.asarray(toks)})[0])(jp)
    with tlm.trainable(tp):
        loss, _ = tm.loss_fn(tp, {"tokens": torch.tensor(toks)})
        named = tlm.leaves(tp)
        tg = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    for name, path, layer in tlm.leaf_paths(tp):
        want = f32(_at(jg, path))
        _leaf_close(tg[name], want if layer is None else want[layer], what=name)
    for name in ("mtp_proj", "mtp_norm_h", "mtp_norm_e", "mtp_blocks.0.attn.wkv_b",
                 "mtp_blocks.0.moe.shared_wd", "dense_blocks.0.attn.q_ln",
                 "moe_blocks.1.attn.kv_ln"):
        assert float(tg[name].abs().max()) > 0, name


def test_mla_three_train_steps_match_jax_float32():
    jcfg, tcfg, jm, tm, jp, tp = both(ARCH, "float32")
    jocfg = joptim.AdamWConfig(lr=joptim.warmup_cosine(LR, 2, 50))
    tocfg = optim.AdamWConfig(lr=optim.warmup_cosine(LR, 2, 50))
    jp3, _, jmets, jgrads = jax_train_run(jm, jp, jocfg, _stream(), 3)
    tstep = make_train_step(tm, tocfg)
    to = optim.init(tlm.leaves(tp), tocfg)
    before = {k: v.clone() for k, v in tlm.leaves(tp).items()}
    stream = TokenStream(vocab=tcfg.vocab, seq=SEQ, global_batch=B, seed=0)
    for s in range(3):
        out, to, m = tstep(tp, to, stream.batch(s, device="cpu"))
        assert out is tp
        for k in ("loss", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jmets[s][k]), rtol=1e-5,
                                       err_msg=f"step {s} {k}")
    assert int(to["step"]) == 3
    assert_params_within(convert.lm_params_to_jax(tp), jp3, adamw_gate(jp3, jmets, jgrads))
    assert all(not torch.equal(before[k], v) for k, v in tlm.leaves(tp).items())
    assert not any(p.requires_grad for p in tp.parameters())


def test_mla_bfloat16_train_step_keeps_the_norms_float32():
    """AdamW's clip and update take the float32 norms (``q_ln``, ``kv_ln``,
    the MTP head's) beside the bfloat16 leaves: they and their moments stay
    float32 and move."""
    _, tcfg, _, tm, _, tp = both(ARCH, "bfloat16")
    ocfg = optim.AdamWConfig(lr=optim.warmup_cosine(LR, 2, 50))
    to = optim.init(tlm.leaves(tp), ocfg)
    watch = {"moe_blocks.0.attn.q_ln": tp.moe_blocks[0]["attn"]["q_ln"],
             "dense_blocks.0.attn.kv_ln": tp.dense_blocks[0]["attn"]["kv_ln"],
             "mtp_norm_h": tp.mtp_norm_h}
    before = {k: v.detach().clone() for k, v in watch.items()}
    assert all(to["mu"][k]["m"].dtype == torch.float32 for k in watch)
    assert to["mu"]["mtp_proj"]["m"].dtype == torch.bfloat16
    step = make_train_step(tm, ocfg)
    stream = TokenStream(vocab=tcfg.vocab, seq=SEQ, global_batch=B, seed=0)
    for s in range(3):
        _, to, m = step(tp, to, stream.batch(s, device="cpu"))
        assert np.isfinite(float(m["loss"])) and float(m["aux"]) > 0
        assert np.isfinite(float(m["grad_norm"]))
    for k, v in watch.items():
        assert v.dtype == torch.float32 and not torch.equal(before[k], v), k
    assert tp.mtp_proj.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_remat_on_and_off_agree(dtype):
    """Per-block checkpointing (the MTP block's too) carries the aux
    through the tuple it returns: loss, aux and every gradient bitwise
    equal with and without it."""
    _, tcfg, _, _, _, tp = both(ARCH, dtype)
    toks = torch.tensor(np.asarray(_stream().batch(1)["tokens"]))
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        calls = []
        orig = tlm.checkpoint

        def spy(fn, *a, **kw):
            calls.append(fn.__name__)
            return orig(fn, *a, **kw)

        tlm.checkpoint = spy
        try:
            with tlm.trainable(tp):
                loss, met = tlm.loss_fn(tp, {"tokens": toks}, cfg)
                grads = torch.autograd.grad(loss, list(tlm.leaves(tp).values()))
        finally:
            tlm.checkpoint = orig
        assert calls.count("_block_apply") == (tcfg.n_layers + tcfg.mtp_depth if remat else 0)
        out.append((loss, met["aux"], grads))
    assert float(out[0][1].detach()) > 0
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    for a, b in zip(out[0][2], out[1][2]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the loop's checkpoints across packages
# ---------------------------------------------------------------------------

LOOP_SEQ = 48


def _lm():
    jcfg, tcfg, jm, tm, jp, tp = both(ARCH, "float32")
    jo = joptim.AdamWConfig(lr=joptim.warmup_cosine(LR, 2, 50))
    to = optim.AdamWConfig(lr=optim.warmup_cosine(LR, 2, 50))
    return (jm, tm, jp, tp, jo, to, _stream(LOOP_SEQ),
            TokenStream(vocab=tcfg.vocab, seq=LOOP_SEQ, global_batch=B, seed=0))


def _jax_run(jm, jp, jo, js, steps, ckpt_dir=None):
    loop = JLoopConfig(steps=steps, ckpt_every=1000, ckpt_dir=ckpt_dir and str(ckpt_dir),
                       log_every=1000, handle_signals=False, async_ckpt=False)
    return jtrain_loop(jax.jit(jmake_train_step(jm, jo)), jp, joptim.init(jp, jo), js.batch,
                       loop, **QUIET)


def _port_run(tm, tp, to, ts, steps, ckpt_dir=None, **kw):
    loop = TrainLoopConfig(steps=steps, ckpt_dir=ckpt_dir and str(ckpt_dir),
                           log_every=1000, handle_signals=False, **kw)
    return train_loop(make_train_step(tm, to), tp, optim.init(tlm.leaves(tp), to),
                      lambda s: ts.batch(s, device="cpu"), loop, **QUIET)


def test_mla_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package's loop writes step 3 of deepseek's SMOKE model (the
    three stacks and the MTP head); the port restores it and runs to step
    6: the JAX package's run straight to 6."""
    jm, tm, jp, tp, jo, to, js, ts = _lm()
    want, _, mets, grads = jax_train_run(jm, jp, jo, js, 6)
    d = tmp_path / "ck"
    _jax_run(jm, jp, jo, js, 3, d)
    assert checkpoint.latest_step(d) == 3
    logs = []
    pb, ob, rep = train_loop(
        make_train_step(tm, to), tp, optim.init(tlm.leaves(tp), to),
        lambda s: ts.batch(s, device="cpu"),
        TrainLoopConfig(steps=6, ckpt_dir=str(d), log_every=1000, handle_signals=False),
        log_fn=logs.append)
    assert "[restore] resumed from step 3" in logs and rep["final_step"] == 6
    assert int(ob["step"]) == 6
    assert_params_within(convert.lm_params_to_jax(pb), want, adamw_gate(want, mets, grads))


def test_mla_port_checkpoint_resumes_in_jax(tmp_path):
    """The port's loop writes step 3; the JAX package's loop restores it
    and runs to step 6: its own run straight to 6."""
    jm, tm, jp, tp, jo, to, js, ts = _lm()
    want, _, mets, grads = jax_train_run(jm, jp, jo, js, 6)
    d = tmp_path / "ck"
    _port_run(tm, tp, to, ts, 3, d)
    assert jcheckpoint.latest_step(d) == 3
    got, jopt, rep = _jax_run(jm, jp, jo, js, 6, d)
    assert rep["final_step"] == 6 and int(jopt["step"]) == 6
    assert_params_within(jax.tree.map(lambda a: np.asarray(a, np.float32), got), want,
                         adamw_gate(want, mets, grads))


def test_mla_train_loop_restart_is_bitwise():
    """On the CPU a restart from the loop's checkpoint is the straight run
    bit for bit: 4 steps straight against 2, a fresh model restored, 2
    more (the MTP leaves and their moments included)."""
    import tempfile

    runs = []
    for split in (None, 2):
        _, tm, _, tp, _, to, _, ts = _lm()
        with tempfile.TemporaryDirectory() as d:
            if split:
                _port_run(tm, tp, to, ts, split, d)
                _, tm, _, tp, _, to, _, ts = _lm()
            p, o, rep = _port_run(tm, tp, to, ts, 4, d)
        assert rep["final_step"] == 4
        runs.append((p, o))
    (pa, oa), (pb, ob) = runs
    assert "mtp_proj" in tlm.leaves(pa)
    for k, v in tlm.leaves(pa).items():
        assert torch.equal(v, tlm.leaves(pb)[k]), k
        assert torch.equal(oa["mu"][k]["v"], ob["mu"][k]["v"]), k


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def test_mla_serve_and_train_clis_on_the_cpu(capsys):
    r = tserve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "8",
                     "--gen", "3", "--device", "cpu"])
    assert r["generated"].shape == (2, 3)
    rep = ttrain.main(["--device", "cpu", "--arch", ARCH, "--smoke", "--steps", "3",
                       "--batch", "2", "--seq", "32"])
    assert rep["final_step"] == 3 and np.isfinite(rep["history"][0]["loss"])
    out = capsys.readouterr().out
    assert "ms/tok" in out and "first_loss=" in out


def test_mla_build_gives_the_mla_model_and_its_mtp_term():
    cfg, model, params, opt_state, step_fn, stream, extras, shard = ttrain.build(
        ARCH, smoke=True, batch=2, seq=16, lr=1e-3, device="cpu")
    assert cfg.use_mla and cfg.mtp_depth == 1 and shard == (None, None)
    assert isinstance(params.moe_blocks[0], tlm.MLAMoEBlock)
    assert "mtp_blocks.0.attn.wq_a" in opt_state["mu"]
    before = params.mtp_proj.detach().clone()
    _, _, m = step_fn(params, opt_state, stream.batch(0, extras, device="cpu"))
    assert float(m["aux"]) > 0 and np.isfinite(float(m["loss"]))
    assert not torch.equal(before, params.mtp_proj)


def test_mla_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    _, cfg = smoke(ARCH)
    model = tget_model(cfg)
    for call in (lambda: tserve.serve(ARCH, smoke=True, batch=1, prompt_len=4, gen=1),
                 lambda: model.init_params(0), lambda: model.init_cache(1, 4),
                 lambda: ttrain.build(ARCH, smoke=True, batch=1, seq=8, lr=1e-3)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
