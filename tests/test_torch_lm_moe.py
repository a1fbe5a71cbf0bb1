"""The port's MoE family (``repro_torch.models.lm`` with
``repro_torch.models.moe``, through ``get_model``) against the JAX
package's on one set of weights, on olmoe-1b-7b's SMOKE config: forward
with its aux loss, ``prefill``, ``decode_step``, ``loss_fn``, the first
step's gradients and three ``make_train_step`` steps, greedy serving,
``leaf_paths`` in the reference's tree order, the parameters carried both
ways, and train-loop checkpoints resumed across packages.  Biases and
norm weights are seeded random values (``test_torch_lm_common``).

Gates, those of the dense family's files: float32 at rtol 1e-4 / atol
1e-5 (``tests/test_torch_lm.py``), bfloat16 at twice the JAX package's
own bfloat16-vs-float32 distance, the loss, grad norm and lr at rtol 1e-5
and the gradients within 1e-5 of each leaf's largest entry, the
parameters after AdamW steps at ``test_torch_lm_common.adamw_gate``
(``tests/test_torch_train.py``); prefill(S) + decode(S) against
prefill(S + 1) at rtol = atol = 0.15 (``tests/test_arch_smoke.py:65-83``).
SMOKE's capacity factor is 8: nothing is dropped here.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_lm_common import (adamw_gate, assert_params_within, both, f32,  # noqa: E402
                                  jax_train_run, numpy_params, smoke, tokens)

from repro import checkpoint as jcheckpoint  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.data import TokenStream as JStream  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
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

ARCH = "olmoe-1b-7b"
F32_TOL = dict(rtol=1e-4, atol=1e-5)
B, S, EXTRA = 2, 40, 4
SEQ, LR = 80, 3e-3              # SEQ = 2 chunks of 32 + a remainder of 16
QUIET = dict(log_fn=lambda s: None)


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
# serving: prefill, decode, the cache, forward and its aux
# ---------------------------------------------------------------------------


def _run_jax(jm, jp, toks, S_cap, step_tok):
    logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=S_cap))(
        jp, {"tokens": jnp.asarray(toks)})
    dlogits, dcache = jax.jit(jm.decode_step)(
        jp, {"token": jnp.asarray(step_tok), "pos": jnp.asarray(toks.shape[1], jnp.int32)},
        cache)
    return [logits, cache["k"], cache["v"], dlogits, dcache["k"], dcache["v"]]


def _run_port(tm, tp, toks, S_cap, step_tok):
    logits, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=S_cap)
    out = [logits, cache["k"].clone(), cache["v"].clone()]
    dlogits, dcache = tm.decode_step(
        tp, {"token": torch.from_numpy(step_tok), "pos": toks.shape[1]}, cache)
    assert dcache is cache
    return out + [dlogits, dcache["k"], dcache["v"]]


NAMES = ("prefill logits", "prefill k", "prefill v", "decode logits", "decode k",
         "decode v")


def test_moe_lm_float32_prefill_decode_and_cache():
    jcfg, tcfg, jm, tm, jp, tp = both(ARCH, "float32")
    toks = tokens(jcfg.vocab, B, S, seed=1)
    step = tokens(jcfg.vocab, B, 1, seed=2)
    want = _run_jax(jm, jp, toks, S + EXTRA, step)
    got = _run_port(tm, tp, toks, S + EXTRA, step)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(f32(g), f32(w), err_msg=name, **F32_TOL)


def test_moe_lm_bfloat16_prefill_decode_and_cache():
    jcfg, tcfg, jm, tm, jp, tp = both(ARCH, "bfloat16")
    toks = tokens(jcfg.vocab, B, S, seed=3)
    step = tokens(jcfg.vocab, B, 1, seed=4)
    want = _run_jax(jm, jp, toks, S + EXTRA, step)
    got = _run_port(tm, tp, toks, S + EXTRA, step)
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    jp32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jp)
    want32 = _run_jax(jget_model(jcfg32), jp32, toks, S + EXTRA, step)
    for name, g, w, w32 in zip(NAMES, got, want, want32):
        assert g.shape == w.shape, name
        assert g.dtype == (torch.float32 if "logits" in name else torch.bfloat16), name
        bound = 2.0 * float(np.abs(f32(w) - f32(w32)).max())
        err = float(np.abs(f32(g) - f32(w)).max())
        assert 0.0 < bound and err <= bound, (name, err, bound)


def test_moe_forward_and_aux_match_jax_float32():
    """The final hidden states and the aux loss summed over the layers."""
    jcfg, tcfg, jm, tm, jp, tp = both(ARCH, "float32")
    toks = tokens(jcfg.vocab, B, S, seed=5)
    jh, jaux = jax.jit(lambda p, b: jlm.forward(p, b, jcfg))(jp, {"tokens": jnp.asarray(toks)})
    th, taux = tlm.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(f32(th), f32(jh), **F32_TOL)
    assert taux.dtype == torch.float32 and float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    # the layers' own aux, summed in layer order
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
    assert len(calls) == tcfg.n_layers
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


def test_moe_serve_greedy_tokens_float32():
    """The port's generate loop on the reference's weights: the reference
    loop's greedy tokens, token for token."""
    jcfg, tcfg, jm, tm, jp, tp = both(ARCH, "float32")
    toks = tokens(jcfg.vocab, B, 16, seed=6)
    want = _jax_greedy(jm, jp, toks, 8)
    got = tserve.generate(tm, tp, torch.from_numpy(toks), 8)
    np.testing.assert_array_equal(got["generated"], want)


def test_moe_prefill_then_decode_matches_full_forward():
    """tests/test_arch_smoke.py:65-83 in the port, on the port's own init."""
    _, cfg = smoke(ARCH)
    model = tget_model(cfg)
    params = model.init_params(0, device="cpu")
    Sp = 32
    toks = torch.from_numpy(tokens(cfg.vocab, 2, Sp + 1, seed=0).astype(np.int64))
    logits_pre, cache = model.prefill(params, {"tokens": toks[:, :Sp]}, cache_len=Sp + 1)
    assert logits_pre.shape == (2, cfg.vocab)
    logits_dec, _ = model.decode_step(params, {"token": toks[:, Sp:Sp + 1], "pos": Sp}, cache)
    logits_full, _ = model.prefill(params, {"tokens": toks})
    np.testing.assert_allclose(f32(logits_dec), f32(logits_full), rtol=0.15, atol=0.15)


def test_moe_decode_cache_shapes_stable():
    """tests/test_arch_smoke.py:85-100 in the port."""
    _, cfg = smoke(ARCH)
    model = tget_model(cfg)
    params = model.init_params(0, device="cpu")
    cache = model.init_cache(2, 32, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in cache.items()}
    assert set(shapes) == {"k", "v"}
    logits, new_cache = model.decode_step(
        params, {"token": torch.zeros((2, 1), dtype=torch.long), "pos": 3}, cache)
    assert logits.shape == (2, cfg.vocab) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    assert {k: tuple(v.shape) for k, v in new_cache.items()} == shapes
    assert float(new_cache["k"][:, :, 3].abs().max()) > 0
    assert float(new_cache["k"][:, :, 4:].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the parameters: layout, leaf order, conversion
# ---------------------------------------------------------------------------


def test_moe_init_matches_reference_layout():
    """Leaf names, shapes and dtypes of the port's init are the reference's
    (blocks unstacked, the router float32), and so is the count."""
    jcfg, cfg = smoke(ARCH)
    jtree = jget_model(jcfg).init_params(jax.random.key(0))
    params = tget_model(cfg).init_params(torch.Generator().manual_seed(0))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            for l in range(cfg.n_layers):
                want[".".join(["blocks", str(l)] + keys[1:])] = (leaf.shape[1:], str(leaf.dtype))
        else:
            want[".".join(keys)] = (leaf.shape, str(leaf.dtype))
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in params.named_parameters()}
    assert got == want
    assert got["blocks.0.moe.router"][1] == "float32"
    assert isinstance(params.blocks[0], tlm.MoEBlock)
    count = sum(v.numel() for v in params.parameters())
    assert count == sum(int(np.prod(l.shape)) for l in jax.tree.leaves(jtree))
    assert abs(count - cfg.param_count()) / count < 0.1
    again = tget_model(cfg).init_params(0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tlm.init_params(0, cfg, "cpu").parameters(),
                                                 again.parameters()))


def test_moe_leaf_paths_in_reference_order():
    """``leaf_paths`` lists the reference's sorted tree paths (the MoE
    leaves ``moe.router``, ``moe.wd``, ``moe.wg``, ``moe.wu`` after the
    norms), a block leaf layer by layer; with a shared expert its
    ``shared_w*`` leaves too."""
    for extra in ({}, {"n_shared_experts": 1}):
        jcfg, tcfg = smoke(ARCH, "float32")
        jcfg = dataclasses.replace(jcfg, **extra)
        tcfg = dataclasses.replace(tcfg, **extra)
        tp = convert.lm_params_from_jax(numpy_params(jcfg), tcfg, device="cpu")
        jp = jget_model(jcfg).init_params(jax.random.key(0))
        paths = [p for _, p, _ in tlm.leaf_paths(tp)]
        ref = [tuple(k.key for k in path)
               for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
        assert list(dict.fromkeys(paths)) == ref
        moe_leaves = [p[-1] for p in ref if p[:2] == ("blocks", "moe")]
        assert moe_leaves == (["router", "wd", "wg", "wu"] if not extra else
                              ["router", "shared_wd", "shared_wg", "shared_wu", "wd", "wg",
                               "wu"])
        names = list(tlm.leaves(tp))
        i = names.index("blocks.0.moe.router")
        assert names[i:i + tcfg.n_layers] == [f"blocks.{l}.moe.router"
                                              for l in range(tcfg.n_layers)]
        assert tlm.ref_ndims(tp)["blocks.0.moe.wg"] == 4


def test_moe_convert_round_trip():
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = smoke(ARCH, dtype)
        tree = numpy_params(jcfg)
        tp = convert.lm_params_from_jax(tree, tcfg, device="cpu")
        assert tp.blocks[0]["moe"]["router"].dtype == torch.float32
        assert tp.blocks[0]["moe"]["wg"].dtype == (torch.bfloat16 if dtype == "bfloat16"
                                                   else torch.float32)
        back = convert.lm_params_to_jax(tp)
        flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_b = dict((tuple(k.key for k in p), v)
                      for p, v in jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(flat_a) == len(flat_b)
        for p, v in flat_a:
            key = tuple(k.key for k in p)
            got = flat_b[key]
            assert got.dtype == np.float32 and got.shape == v.shape
            if dtype == "float32" or key[-1] in ("router", "ln1", "ln2", "final_norm"):
                np.testing.assert_array_equal(got, v)
            else:        # the bfloat16 value of each float32 entry, exactly
                np.testing.assert_array_equal(
                    got, np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32))


def test_moe_train_state_tree_has_the_reference_keys():
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
    assert str(ft["opt/mu/blocks/moe/router/m"].dtype) == "torch.float32"


# ---------------------------------------------------------------------------
# training: loss_fn with its aux, gradients, train steps, remat
# ---------------------------------------------------------------------------


def _stream(seq=SEQ, batch=B):
    return JStream(vocab=smoke(ARCH)[0].vocab, seq=seq, global_batch=batch, seed=0)


def test_moe_loss_fn_matches_jax_float32():
    jcfg, tcfg, jm, tm, jp, tp = both(ARCH, "float32")
    toks = np.asarray(_stream().batch(0)["tokens"])
    jl, jmet = jax.jit(jm.loss_fn)(jp, {"tokens": jnp.asarray(toks)})
    tl, tmet = tm.loss_fn(tp, {"tokens": torch.tensor(toks)})
    assert set(tmet) == {"loss", "aux", "tokens"}
    assert tl.grad_fn is None and float(tmet["aux"]) > 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["aux"]), float(jmet["aux"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["tokens"]), float(jmet["tokens"]))
    # the aux is in the loss
    _, h_aux = tlm.forward(tp, {"tokens": torch.tensor(toks)}, tcfg)
    assert torch.equal(h_aux, tmet["aux"])


def test_moe_first_step_gradients_match_jax_float32():
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
    assert float(tg["blocks.1.moe.router"].abs().max()) > 0


def test_moe_three_train_steps_match_jax_float32():
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


def test_moe_bfloat16_train_step_keeps_the_router_float32():
    """AdamW's clip and update take the float32 router beside the bfloat16
    leaves: the router and its moments stay float32 and move."""
    _, tcfg, _, tm, _, tp = both(ARCH, "bfloat16")
    ocfg = optim.AdamWConfig(lr=optim.warmup_cosine(LR, 2, 50))
    to = optim.init(tlm.leaves(tp), ocfg)
    router = tp.blocks[0]["moe"]["router"]
    before = router.detach().clone()
    assert to["mu"]["blocks.0.moe.router"]["m"].dtype == torch.float32
    assert to["mu"]["blocks.0.moe.wg"]["m"].dtype == torch.bfloat16
    step = make_train_step(tm, ocfg)
    stream = TokenStream(vocab=tcfg.vocab, seq=SEQ, global_batch=B, seed=0)
    for s in range(3):
        _, to, m = step(tp, to, stream.batch(s, device="cpu"))
        assert np.isfinite(float(m["loss"])) and float(m["aux"]) > 0
        assert np.isfinite(float(m["grad_norm"]))
    assert router.dtype == torch.float32 and not torch.equal(before, router)
    assert tp.blocks[0]["moe"]["wg"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_remat_on_and_off_agree(dtype):
    """Per-block checkpointing carries the aux through the tuple it
    returns: loss, aux and every gradient bitwise equal with and without
    it (the combine sums in a fixed order, so the recomputation picks and
    sums as the forward did)."""
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
        assert calls.count("_block_apply") == (tcfg.n_layers if remat else 0)
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


def test_moe_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package's loop writes step 3 of olmoe's SMOKE model; the
    port restores it (the stacked expert leaves and the float32 router)
    and runs to step 6: the JAX package's run straight to 6."""
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


def test_moe_port_checkpoint_resumes_in_jax(tmp_path):
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


def test_moe_train_loop_restart_is_bitwise():
    """On the CPU a restart from the loop's checkpoint is the straight run
    bit for bit: 4 steps straight against 2, a fresh model restored, 2
    more."""
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
    for k, v in tlm.leaves(pa).items():
        assert torch.equal(v, tlm.leaves(pb)[k]), k
        assert torch.equal(oa["mu"][k]["v"], ob["mu"][k]["v"]), k


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def test_moe_serve_and_train_clis_on_the_cpu(capsys):
    r = tserve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "8",
                     "--gen", "3", "--device", "cpu"])
    assert r["generated"].shape == (2, 3)
    rep = ttrain.main(["--device", "cpu", "--arch", ARCH, "--smoke", "--steps", "3",
                       "--batch", "2", "--seq", "32"])
    assert rep["final_step"] == 3 and np.isfinite(rep["history"][0]["loss"])
    out = capsys.readouterr().out
    assert "ms/tok" in out and "first_loss=" in out


def test_moe_build_gives_the_moe_model_and_its_aux():
    cfg, model, params, opt_state, step_fn, stream, extras, shard = ttrain.build(
        ARCH, smoke=True, batch=2, seq=16, lr=1e-3, device="cpu")
    assert cfg.family == "moe" and shard == (None, None)
    assert isinstance(params.blocks[0], tlm.MoEBlock)
    _, _, m = step_fn(params, opt_state, stream.batch(0, extras, device="cpu"))
    assert float(m["aux"]) > 0 and np.isfinite(float(m["loss"]))


def test_moe_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    _, cfg = smoke(ARCH)
    model = tget_model(cfg)
    for call in (lambda: tserve.serve(ARCH, smoke=True, batch=1, prompt_len=4, gen=1),
                 lambda: model.init_params(0), lambda: model.init_cache(1, 4),
                 lambda: ttrain.build(ARCH, smoke=True, batch=1, seq=8, lr=1e-3)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
