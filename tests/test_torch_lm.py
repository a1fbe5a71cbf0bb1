"""The port's dense LM (``repro_torch.models.lm`` through ``get_model``)
against the JAX package's on one set of weights, for the four dense SMOKE
configs: prefill logits and cache, ``decode_step`` logits and cache, and
the greedy tokens of ``serve``.  Biases and norm weights are seeded random
values (``test_torch_lm_common.numpy_params``).

Gates: float32 (``dtype="float32"``) at rtol 1e-4 / atol 1e-5; bfloat16 at
twice the JAX package's own bfloat16-vs-float32 distance on the same
inputs, tensor by tensor.  Then the JAX test's own checks in the port
(``tests/test_arch_smoke.py:65-100``): prefill(S) + decode_step(S) against
prefill(S + 1) at rtol = atol = 0.15, and a decode step keeps the cache's
shapes."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_lm_common import DENSE, both, f32, smoke, tokens  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import get_model as tget_model  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import lm_params_from_jax  # noqa: E402

F32_TOL = dict(rtol=1e-4, atol=1e-5)
B, S, EXTRA = 2, 40, 4          # S > 32: starcoder2's smoke window (32) is live


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
    assert dcache is cache                     # written in place
    return out + [dlogits, dcache["k"], dcache["v"]]


NAMES = ("prefill logits", "prefill k", "prefill v", "decode logits", "decode k",
         "decode v")


@pytest.mark.parametrize("arch", DENSE)
def test_torch_lm_float32_prefill_decode_and_cache(arch):
    jcfg, tcfg, jm, tm, jp, tp = both(arch, "float32")
    toks = tokens(jcfg.vocab, B, S, seed=1)
    step = tokens(jcfg.vocab, B, 1, seed=2)
    want = _run_jax(jm, jp, toks, S + EXTRA, step)
    got = _run_port(tm, tp, toks, S + EXTRA, step)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(f32(g), f32(w), err_msg=name, **F32_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_torch_lm_bfloat16_prefill_decode_and_cache(arch):
    jcfg, tcfg, jm, tm, jp, tp = both(arch, "bfloat16")
    toks = tokens(jcfg.vocab, B, S, seed=3)
    step = tokens(jcfg.vocab, B, 1, seed=4)
    want = _run_jax(jm, jp, toks, S + EXTRA, step)
    got = _run_port(tm, tp, toks, S + EXTRA, step)
    # the JAX package's float32 run of the same weights (bf16 values held in f32)
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    jp32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jp)
    want32 = _run_jax(jget_model(jcfg32), jp32, toks, S + EXTRA, step)
    for name, g, w, w32 in zip(NAMES, got, want, want32):
        assert g.shape == w.shape, name
        assert g.dtype == (torch.float32 if "logits" in name else torch.bfloat16), name
        bound = 2.0 * float(np.abs(f32(w) - f32(w32)).max())
        err = float(np.abs(f32(g) - f32(w)).max())
        assert 0.0 < bound and err <= bound, (name, err, bound)


def _jax_greedy(jm, jp, toks, gen):
    """The reference's serve loop (repro/launch/serve.py:153-171) on given
    weights and prompt."""
    prefill = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=toks.shape[1] + gen))
    decode = jax.jit(jm.decode_step)
    logits, cache = prefill(jp, {"tokens": jnp.asarray(toks)})
    out, all_logits = [], []
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    for i in range(gen):
        out.append(np.asarray(tok))
        all_logits.append(f32(logits))
        logits, cache = decode(jp, {"token": tok, "pos": jnp.asarray(toks.shape[1] + i,
                                                                     jnp.int32)}, cache)
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    return np.concatenate(out, axis=1), all_logits


@pytest.mark.parametrize("arch", DENSE)
def test_torch_lm_serve_greedy_tokens_float32(arch):
    """The port's generate loop on the reference's weights: the same greedy
    tokens as the reference's loop, token for token."""
    jcfg, tcfg, jm, tm, jp, tp = both(arch, "float32")
    toks = tokens(jcfg.vocab, B, 16, seed=5)
    want, _ = _jax_greedy(jm, jp, toks, 8)
    got = tserve.generate(tm, tp, torch.from_numpy(toks), 8)
    np.testing.assert_array_equal(got["generated"], want)
    assert set(got) == {"generated", "prefill_s", "decode_s_per_token", "tokens_per_s"}


@pytest.mark.parametrize("arch", DENSE)
def test_torch_lm_serve_greedy_tokens_match_jax_serve(arch):
    """The reference's own ``serve`` (bfloat16 SMOKE, its weights from
    ``jax.random.key(seed)``, its prompt from numpy at ``seed``) against the
    port's ``generate`` on those weights and that prompt.  In bfloat16 the
    top two logits of a step often lie closer than the two packages'
    roundings (the gate: twice JAX's own bf16-vs-f32 distance), so a
    token may legitimately differ at such a tie.  Fed the reference's
    tokens, the port's logits stay within the gate at every step and its
    choice is within the gate of the reference's best; its own greedy
    tokens equal the reference's up to the first step where they differ,
    and that step is such a tie."""
    seed, batch, prompt_len, gen = 0, 2, 16, 8
    want = jserve.serve(arch, smoke=True, batch=batch, prompt_len=prompt_len, gen=gen,
                        seed=seed)["generated"]
    jcfg = JARCHS[arch].SMOKE
    jm = jget_model(jcfg)
    jp = jm.init_params(jax.random.key(seed))
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), jp)
    _, tcfg = smoke(arch)
    tm, tp = tget_model(tcfg), lm_params_from_jax(tree, tcfg, device="cpu")
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab, size=(batch, prompt_len))
    got = tserve.generate(tm, tp, torch.from_numpy(toks), gen)["generated"]
    ref_toks, ref_logits = _jax_greedy(jm, jp, toks.astype(np.int32), gen)
    np.testing.assert_array_equal(ref_toks, want)
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    jp32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jp)
    l32, _ = jget_model(jcfg32).prefill(jp32, {"tokens": jnp.asarray(toks, jnp.int32)})
    gate = 2.0 * float(np.abs(ref_logits[0] - f32(l32)).max())
    rows = np.arange(batch)
    # teacher-forced: the port's logits at each step on the reference's tokens
    logits, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                               cache_len=prompt_len + gen)
    for i in range(gen):
        mine, ref = f32(logits), ref_logits[i]
        assert float(np.abs(mine - ref).max()) <= gate, i
        assert np.all(ref[rows, mine.argmax(-1)] >= ref.max(-1) - gate), i
        logits, cache = tm.decode_step(
            tp, {"token": torch.from_numpy(want[:, i:i + 1]), "pos": prompt_len + i}, cache)
    # free-running: equal up to the first difference, which is a tie
    diff = np.nonzero(np.any(got != want, axis=0))[0]
    k = int(diff[0]) if len(diff) else gen
    np.testing.assert_array_equal(got[:, :k], want[:, :k])
    if k < gen:
        ref = ref_logits[k]
        assert np.all(ref[rows, got[:, k]] >= ref.max(-1) - gate), k


@pytest.mark.parametrize("arch", DENSE)
def test_torch_lm_prefill_then_decode_matches_full_forward(arch):
    """tests/test_arch_smoke.py:65-83 in the port, on the port's own init:
    prefill(S) + decode_step(S) logits against prefill(S + 1)'s."""
    _, cfg = smoke(arch)
    model = tget_model(cfg)
    params = model.init_params(0, device="cpu")
    Sp = 32
    toks = torch.from_numpy(tokens(cfg.vocab, 2, Sp + 1, seed=0).astype(np.int64))
    logits_pre, cache = model.prefill(params, {"tokens": toks[:, :Sp]}, cache_len=Sp + 1)
    assert logits_pre.shape == (2, cfg.vocab)
    logits_dec, _ = model.decode_step(params, {"token": toks[:, Sp:Sp + 1], "pos": Sp}, cache)
    logits_full, _ = model.prefill(params, {"tokens": toks})
    np.testing.assert_allclose(f32(logits_dec), f32(logits_full), rtol=0.15, atol=0.15)


@pytest.mark.parametrize("arch", DENSE)
def test_torch_lm_decode_cache_shapes_stable(arch):
    """tests/test_arch_smoke.py:85-100 in the port."""
    _, cfg = smoke(arch)
    model = tget_model(cfg)
    params = model.init_params(0, device="cpu")
    cache = model.init_cache(2, 32, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in cache.items()}
    logits, new_cache = model.decode_step(
        params, {"token": torch.zeros((2, 1), dtype=torch.long), "pos": 3}, cache)
    assert logits.shape == (2, cfg.vocab) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    assert {k: tuple(v.shape) for k, v in new_cache.items()} == shapes
    assert all(v.dtype == torch.bfloat16 for v in new_cache.values())
    # the step wrote position 3 of every layer and nothing else
    assert float(new_cache["k"][:, :, 3].abs().max()) > 0
    assert float(new_cache["k"][:, :, 4:].abs().max()) == 0.0


@pytest.mark.parametrize("arch", DENSE)
def test_torch_lm_init_matches_reference_layout(arch):
    """Leaf names, shapes and dtypes of the port's init are the reference's
    (blocks unstacked), and so is the number of parameters."""
    jcfg, cfg = smoke(arch)
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
    count = sum(v.numel() for v in params.parameters())
    assert count == sum(int(np.prod(l.shape)) for l in jax.tree.leaves(jtree))
    # the analytic count leaves out norms and biases (tests/test_arch_smoke.py:103-115)
    assert abs(count - cfg.param_count()) / count < 0.1
    # biases start at zero and norms at one, as in the reference
    blk = params.blocks[0]
    assert torch.equal(blk["ln1"], torch.ones(cfg.d_model))
    assert all(float(v.abs().max()) == 0.0 for k, v in blk["attn"].items() if k[0] == "b")
    # the seeded generator is the only source of randomness
    again = tget_model(cfg).init_params(0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tlm.init_params(0, cfg, "cpu").parameters(),
                                                 again.parameters()))


def test_torch_lm_serve_cli_on_the_cpu(capsys):
    r = tserve.main(["--arch", "smollm-360m", "--smoke", "--batch", "2", "--prompt-len", "8",
                     "--gen", "3", "--device", "cpu"])
    assert r["generated"].shape == (2, 3)
    assert "ms/tok" in capsys.readouterr().out


def test_torch_lm_entry_points_default_to_the_card():
    """``serve``, the model's init and cache and the converter take the
    card unless asked for the CPU, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    _, cfg = smoke("qwen2-1.5b")
    model = tget_model(cfg)
    for call in (lambda: tserve.serve("qwen2-1.5b", smoke=True, batch=1, prompt_len=4, gen=1),
                 lambda: model.init_params(0), lambda: model.init_cache(1, 4),
                 lambda: lm_params_from_jax(
                     jax.tree.map(np.asarray, jget_model(JARCHS["qwen2-1.5b"].SMOKE)
                                  .init_params(jax.random.key(0))), cfg)):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
