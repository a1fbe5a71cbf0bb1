"""The LM half's training path in the port against the JAX package's, on
the same numpy inputs and, through ``models/convert.py``, the same
weights: the schedules, ``TokenStream``, ``xent_chunked`` (value and
gradients), ``loss_fn`` and three ``make_train_step`` steps on qwen2's
SMOKE config in float32, remat, the saved tensors of the chunked loss,
and serving after training.

Gates, each stated where it is used:
* schedules: |port - JAX| <= 1e-7 (float32 values of order ``lr`` = 1);
* ``TokenStream``: bitwise;
* ``xent_chunked`` (float32): rtol 1e-5 on the value, gradients within
  1e-5 of each gradient's largest entry;
* ``loss_fn`` and the train step (float32): loss, grad norm and lr at rtol
  1e-5; the first step's gradients within 1e-5 of each leaf's largest
  entry;
  every parameter after step 3 within 1e-5 of its leaf's largest entry
  plus what that gradient gate allows the three AdamW updates to move
  (``test_torch_lm_common.adamw_gate``).  Why not 1e-5 alone: AdamW
  divides by sqrt(v) + eps, so an entry whose gradient is of the order of
  its own float32 rounding amplifies the two packages' rounding
  difference: ``tok_emb[240, 11]`` has |g| = 1.1e-7 = 11 eps at step 1
  here, the gradients differ there by 5e-10 (2e-9 of the leaf's largest
  gradient), and its update moves by 5e-7, 1.09e-5 of the leaf's largest
  entry after three steps.  An entry whose gradient stands clear of its
  rounding keeps a tolerance close to 1e-5 of its leaf;
* remat on and off, ``apply_updates_`` against ``apply_updates``: bitwise
  (the same operations on the CPU).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_lm_common import (adamw_gate, assert_params_within, both, f32,  # noqa: E402
                                  jax_train_run, numpy_params, smoke)

from repro import optim as joptim  # noqa: E402
from repro.data import TokenStream as JStream  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.data import TokenStream as TStream  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import make_train_step as tmake_train_step  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import get_model as tget_model  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

ARCH = "qwen2-1.5b"
B, SEQ, LR = 2, 80, 3e-3           # SEQ = 2 chunks of 32 + a remainder of 16


def _leaf_close(got, want, rel=1e-5, what=""):
    got, want = f32(got), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

WARMUP, TOTAL = 20, 100
STEPS = (0, 1, WARMUP - 1, WARMUP, (WARMUP + TOTAL) // 2, TOTAL, TOTAL + 5)


@pytest.mark.parametrize("name,args", [
    ("constant", (1.0,)),
    ("warmup_linear", (1.0, WARMUP, TOTAL)),
    ("warmup_linear", (1.0, WARMUP, TOTAL, 0.25)),
    ("warmup_cosine", (1.0, WARMUP, TOTAL)),
    ("warmup_cosine", (1.0, WARMUP, TOTAL, 0.0)),
])
@pytest.mark.parametrize("step_dtype", [torch.int32, torch.int64])
def test_schedules_match_jax(name, args, step_dtype):
    jf, tf = getattr(joptim, name)(*args), getattr(toptim, name)(*args)
    for s in STEPS:
        got = tf(torch.tensor(s, dtype=step_dtype))
        want = float(jf(jnp.asarray(s, jnp.int32)))
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert abs(float(got) - want) <= 1e-7, (name, s, float(got), want)


def test_schedule_feeds_adamw_lr():
    """``_lr_at`` takes a schedule's value unchanged: the step's lr is
    ``warmup_cosine`` at the step after the update counter's."""
    cfg = toptim.AdamWConfig(lr=toptim.warmup_cosine(0.5, 4, 10))
    p = {"x": torch.zeros(3)}
    s = toptim.init(p, cfg)
    for step in range(1, 4):
        p, s, m = toptim.apply_updates(p, {"x": torch.ones(3)}, s, cfg)
        assert float(m["lr"]) == float(toptim.warmup_cosine(0.5, 4, 10)(torch.tensor(step)))


# ---------------------------------------------------------------------------
# TokenStream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_token_stream_bitwise_jax(seed):
    js = JStream(vocab=1000, seq=33, global_batch=3, seed=seed)
    ts = TStream(vocab=1000, seq=33, global_batch=3, seed=seed)
    for step in (0, 1, 17):
        got = ts.batch(step, device="cpu")["tokens"]
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(js.batch(step)["tokens"]))


def test_token_stream_extras_and_default_device():
    ts = TStream(vocab=50, seq=8, global_batch=2, seed=1)
    out = ts.batch(3, {"img": "x"}, device="cpu")
    assert out["img"] == "x" and out["tokens"].shape == (2, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ts.batch(3)


# ---------------------------------------------------------------------------
# xent_chunked
# ---------------------------------------------------------------------------


def _xent_inputs(S, Bx=3, d=24, V=40, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((Bx, S, d)).astype(np.float32)
    emb = (0.3 * rng.standard_normal((V, d))).astype(np.float32)
    labels = rng.integers(0, V, size=(Bx, S)).astype(np.int32)
    mask = (rng.random((Bx, S)) < 0.8).astype(np.float32)
    return h, emb, labels, mask


@pytest.mark.parametrize("S", [48, 53])          # a multiple of the chunk, and not
def test_xent_chunked_value_and_grads_match_jax(S):
    chunk = 16
    h, emb, labels, mask = _xent_inputs(S)

    def jloss(h_, e_):
        l, c = jlm.xent_chunked(h_, e_, jnp.asarray(labels), jnp.asarray(mask), chunk)
        return l / c

    want, (jgh, jge) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(h),
                                                                  jnp.asarray(emb))
    th = torch.from_numpy(h).requires_grad_(True)
    te = torch.from_numpy(emb).requires_grad_(True)
    l, c = tlm.xent_chunked(th, te, torch.from_numpy(labels), torch.from_numpy(mask), chunk)
    got = l / c
    gh, ge = torch.autograd.grad(got, (th, te))
    assert float(c) == float(mask.sum())
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _leaf_close(gh, jgh, what="dh")
    _leaf_close(ge, jge, what="demb")


@pytest.mark.parametrize("S", [64, 70])
def test_xent_chunked_saves_no_chunk_of_logits(S):
    """No tensor kept for the backward pass holds a chunk's logits: every
    saved tensor has fewer than B x chunk x V elements (the whole chunks'
    logits are recomputed under the checkpoint; the remainder's have
    S mod chunk < chunk positions).  d < B x chunk, so the unembedding
    itself passes."""
    chunk, Bx, d, V = 16, 4, 24, 96
    h, emb, labels, mask = _xent_inputs(S, Bx=Bx, d=d, V=V)
    th = torch.from_numpy(h).requires_grad_(True)
    te = torch.from_numpy(emb).requires_grad_(True)
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        l, c = tlm.xent_chunked(th, te, torch.from_numpy(labels), torch.from_numpy(mask),
                                chunk)
        gh, ge = torch.autograd.grad(l / c, (th, te))
    assert saved and max(saved) < Bx * chunk * V, (max(saved), Bx * chunk * V)
    # the same loss without the checkpoint does save whole chunks (the
    # hook can see them), and gives the same value and gradients
    saved.clear()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        l2 = sum(tlm._xent_chunk(th[:, i:i + chunk], te, torch.from_numpy(labels[:, i:i + chunk]),
                                 torch.from_numpy(mask[:, i:i + chunk]))[0]
                 for i in range(0, S, chunk))
        gh2, ge2 = torch.autograd.grad(l2 / c, (th, te))
    assert max(saved) >= Bx * chunk * V
    torch.testing.assert_close(gh, gh2, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(ge, ge2, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# loss_fn and the train step on qwen2's SMOKE config, float32
# ---------------------------------------------------------------------------


def _stream():
    return JStream(vocab=smoke(ARCH)[0].vocab, seq=SEQ, global_batch=B, seed=0)


def test_loss_fn_matches_jax_float32():
    jcfg, tcfg, jm, tm, jp, tp = both(ARCH, "float32")
    toks = np.asarray(_stream().batch(0)["tokens"])
    (jl, jmet) = jax.jit(jm.loss_fn)(jp, {"tokens": jnp.asarray(toks)})
    tl, tmet = tm.loss_fn(tp, {"tokens": torch.tensor(toks)})
    assert set(tmet) == {"loss", "aux", "tokens"}
    assert float(tmet["aux"]) == 0.0 and float(tmet["tokens"]) == B * (SEQ - 1)
    assert tl.dtype == torch.float32 and tl.grad_fn is None    # no graph outside training
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["tokens"]), float(jmet["tokens"]))


def test_first_step_gradients_match_jax_float32():
    jcfg, tcfg, jm, tm, jp, tp = both(ARCH, "float32")
    toks = np.asarray(_stream().batch(0)["tokens"])
    jg = jax.grad(lambda p: jm.loss_fn(p, {"tokens": jnp.asarray(toks)})[0])(jp)
    with tlm.trainable(tp):
        loss, _ = tm.loss_fn(tp, {"tokens": torch.tensor(toks)})
        named = tlm.leaves(tp)
        tg = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    for name, path, layer in tlm.leaf_paths(tp):
        want = jg
        for k in path:
            want = want[k]
        want = f32(want) if layer is None else f32(want)[layer]
        _leaf_close(tg[name], want, what=name)


def test_three_train_steps_match_jax_float32():
    jcfg, tcfg, jm, tm, jp, tp = both(ARCH, "float32")
    jocfg = joptim.AdamWConfig(lr=joptim.warmup_cosine(LR, 2, 50))
    tocfg = toptim.AdamWConfig(lr=toptim.warmup_cosine(LR, 2, 50))
    jp3, _, jmets, jgrads = jax_train_run(jm, jp, jocfg, _stream(), 3)
    tstep = tmake_train_step(tm, tocfg)
    to = toptim.init(tlm.leaves(tp), tocfg)
    before = {k: v.clone() for k, v in tlm.leaves(tp).items()}
    stream = TStream(vocab=tcfg.vocab, seq=SEQ, global_batch=B, seed=0)
    for s in range(3):
        out, to, m = tstep(tp, to, stream.batch(s, device="cpu"))
        assert out is tp                                     # written in place
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jmets[s][k]), rtol=1e-5,
                                       err_msg=f"step {s} {k}")
        assert float(m["tokens"]) == B * (SEQ - 1) and float(m["aux"]) == 0.0
    assert int(to["step"]) == 3
    assert_params_within(convert.lm_params_to_jax(tp), jp3, adamw_gate(jp3, jmets, jgrads))
    # every leaf moved
    assert all(not torch.equal(before[k], v) for k, v in tlm.leaves(tp).items())
    assert not any(p.requires_grad for p in tp.parameters())


def test_global_norm_sums_leaves_in_reference_order():
    """``lm.leaves`` lists the reference's sorted tree paths, a block leaf
    layer by layer, so the grad norm sums in the reference's order."""
    _, tcfg, _, _, jp, tp = both(ARCH, "float32")
    paths = [p for _, p, _ in tlm.leaf_paths(tp)]
    ref = [tuple(k.key for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    dedup = list(dict.fromkeys(paths))
    assert dedup == ref
    names = list(tlm.leaves(tp))
    assert names[:tcfg.n_layers] == [f"blocks.{l}.attn.bk" for l in range(tcfg.n_layers)]
    assert names[-1] == "tok_emb"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_on_and_off_agree(dtype):
    """Per-block checkpointing changes what is kept for the backward pass,
    not the numbers: loss and every gradient bitwise equal."""
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
                loss, _ = tlm.loss_fn(tp, {"tokens": toks}, cfg)
                grads = torch.autograd.grad(loss, list(tlm.leaves(tp).values()))
        finally:
            tlm.checkpoint = orig
        assert calls.count("_block_apply") == (tcfg.n_layers if remat else 0)
        assert calls.count("_xent_chunk") == SEQ // tcfg.logits_chunk
        out.append((loss, grads))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_remat_only_when_gradients_are_on():
    _, tcfg, _, tm, _, tp = both(ARCH, "float32")
    toks = torch.tensor(np.asarray(_stream().batch(0)["tokens"]))
    calls = []
    orig = tlm.checkpoint
    tlm.checkpoint = lambda fn, *a, **kw: calls.append(fn) or orig(fn, *a, **kw)
    try:
        tm.loss_fn(tp, {"tokens": toks})                     # parameters frozen
        with tlm.trainable(tp), torch.no_grad():
            tm.loss_fn(tp, {"tokens": toks})
        tm.prefill(tp, {"tokens": toks})
    finally:
        tlm.checkpoint = orig
    assert calls == []


def test_bfloat16_train_step_is_finite_and_moves():
    _, tcfg, _, tm, _, tp = both(ARCH, "bfloat16")
    ocfg = toptim.AdamWConfig(lr=toptim.warmup_cosine(LR, 2, 50))
    to = toptim.init(tlm.leaves(tp), ocfg)
    assert to["mu"]["tok_emb"]["m"].dtype == torch.bfloat16
    before = tp.tok_emb.detach().clone()
    step = tmake_train_step(tm, ocfg)
    stream = TStream(vocab=tcfg.vocab, seq=SEQ, global_batch=B, seed=0)
    for s in range(3):
        _, to, m = step(tp, to, stream.batch(s, device="cpu"))
        assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert tp.tok_emb.dtype == torch.bfloat16 and not torch.equal(before, tp.tok_emb)


@pytest.mark.parametrize("chunk", [None, 7])
@pytest.mark.parametrize("mask", [None, "rows"])
def test_in_place_update_is_apply_updates(chunk, mask, monkeypatch):
    """``apply_updates_`` writes what ``apply_updates`` returns, bit for
    bit, bfloat16 leaves with a clipped gradient included, whole and in
    chunks of 7 elements (a user's decay mask sees the whole leaf)."""
    if chunk is not None:
        monkeypatch.setitem(toptim.adamw.CHUNK, "cpu", chunk)
    rng = np.random.default_rng(3)
    decay_mask = None if mask is None else (lambda p: p.shape[0] == 5)
    cfg = toptim.AdamWConfig(lr=toptim.warmup_linear(0.1, 2, 10), clip_norm=0.5,
                             decay_mask=decay_mask)
    for dt in (torch.float32, torch.bfloat16):
        p = {"w": torch.from_numpy(rng.standard_normal((5, 4)).astype(np.float32)).to(dt),
             "b": torch.from_numpy(rng.standard_normal(4).astype(np.float32))}
        s = toptim.init(p, cfg)
        p2 = {k: v.clone() for k, v in p.items()}
        s2 = toptim.init(p2, cfg)
        for _ in range(3):
            g = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32)).to(v.dtype)
                 for k, v in p.items()}
            p, s, m = toptim.apply_updates(p, g, s, cfg)
            m2 = toptim.apply_updates_(p2, g, s2, cfg)
            assert torch.equal(m["grad_norm"], m2["grad_norm"])
        for k in p:
            assert torch.equal(p[k], p2[k])
            assert torch.equal(s["mu"][k]["m"], s2["mu"][k]["m"])
            assert torch.equal(s["mu"][k]["v"], s2["mu"][k]["v"])
        assert int(s2["step"]) == 3


def test_clipped_bf16_gradient_is_scaled_in_float32():
    """The reference's ``g * scale`` promotes a bfloat16 g to float32
    before the moments see it."""
    cfg = toptim.AdamWConfig(lr=1.0, clip_norm=1e-3, weight_decay=0.0, b1=0.0)
    g = torch.tensor([3.0, 1.0 / 3.0], dtype=torch.bfloat16)
    p = {"x": torch.zeros(2, dtype=torch.bfloat16)}
    s = toptim.init(p, dataclasses.replace(cfg, state_dtype=torch.float32))
    _, s, _ = toptim.apply_updates(p, {"x": g}, s, cfg)
    gn = torch.sqrt(torch.sum(g.float() ** 2))
    want = g.float() * torch.clamp(1e-3 / (gn + 1e-9), max=1.0)
    assert torch.equal(s["mu"]["x"]["m"], want)


# ---------------------------------------------------------------------------
# serving after training; the launcher
# ---------------------------------------------------------------------------


def test_serving_records_no_graph_after_a_train_step():
    _, tcfg, _, tm, _, tp = both(ARCH, "float32")
    ocfg = toptim.AdamWConfig()
    to = toptim.init(tlm.leaves(tp), ocfg)
    toks = torch.tensor(np.asarray(_stream().batch(0)["tokens"]))
    tmake_train_step(tm, ocfg)(tp, to, {"tokens": toks})
    assert not any(p.requires_grad for p in tp.parameters())
    logits, cache = tm.prefill(tp, {"tokens": toks[:, :8]}, cache_len=12)  # no no_grad here
    assert logits.grad_fn is None and not logits.requires_grad
    assert cache["k"].grad_fn is None
    dl, _ = tm.decode_step(tp, {"token": toks[:, 8:9], "pos": 8}, cache)
    assert dl.grad_fn is None
    out = tserve.generate(tm, tp, toks[:, :8], 3)
    assert out["generated"].shape == (B, 3)


def test_trainable_restores_each_flag():
    _, _, _, _, _, tp = both(ARCH, "float32")
    tp.final_norm.requires_grad_(True)
    with tlm.trainable(tp):
        assert all(p.requires_grad for p in tp.parameters())
    assert tp.final_norm.requires_grad
    assert not tp.tok_emb.requires_grad


def test_convert_round_trip():
    jcfg, tcfg = smoke(ARCH, "float32")
    tree = numpy_params(jcfg)
    back = convert.lm_params_to_jax(convert.lm_params_from_jax(tree, tcfg, device="cpu"))
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict((tuple(k.key for k in p), v)
                  for p, v in jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for p, v in flat_a:
        got = flat_b[tuple(k.key for k in p)]
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, v)


def test_train_state_tree_has_the_reference_keys():
    """The checkpoint tree of the port's model and AdamW state has exactly
    the leaves of the reference's ``{"params", "opt"}`` (shapes and
    dtypes), so either package restores the other's."""
    jcfg, tcfg, jm, tm, jp, tp = both(ARCH, "bfloat16")
    jocfg = joptim.AdamWConfig()
    jtree = {"params": jp, "opt": joptim.init(jp, jocfg)}
    ttree = convert.train_state_to_jax(tp, toptim.init(tlm.leaves(tp), toptim.AdamWConfig()))
    keys = convert.train_state_keys(tp)

    def flat(t):
        return {"/".join(str(getattr(k, "key", k)) for k in p): v
                for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}

    fj, ft = flat(jtree), flat(ttree)
    assert set(fj) == set(ft) == set(flat(keys))
    for k, v in fj.items():
        assert tuple(ft[k].shape) == tuple(v.shape), k
        assert str(ft[k].dtype).replace("torch.", "") == str(v.dtype), k


def test_launch_train_cli_on_cpu(capsys):
    rep = ttrain.main(["--device", "cpu", "--arch", ARCH, "--smoke", "--steps", "4",
                       "--batch", "2", "--seq", "64"])
    assert rep["final_step"] == 4 and len(rep["history"]) == 1
    assert np.isfinite(rep["history"][0]["loss"])
    assert "first_loss=" in capsys.readouterr().out


def test_build_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.build(ARCH, smoke=True, batch=2, seq=16, lr=1e-3)
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--arch", ARCH, "--steps", "1"])
