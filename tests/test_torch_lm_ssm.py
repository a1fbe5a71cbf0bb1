"""The port's SSM and hybrid families (``repro_torch.models.lm`` with
``repro_torch.models.ssm``, through ``get_model``) against the JAX
package's on one set of weights, on mamba2-130m's SMOKE config (2 mamba
layers, d 64, 8 SSD heads of 16, state 16, chunk 16, tied embeddings) and
zamba2-7b's (2 groups of 2 mamba layers and a tail of 1, one shared
attention + MLP block run before each group): ``prefill`` (the logits and
every cache entry: the conv windows, the SSM states, the shared block's
K/V padded to the capacity), ``decode_step``, greedy serving, forward,
``loss_fn``, the first step's gradients on every leaf (the shared block's,
summed over its invocations, included) and three ``make_train_step``
steps, remat, ``leaf_paths`` in the reference's sorted tree and
``ref_ndims`` at its ranks, the parameters carried both ways, train-loop
checkpoints resumed across packages, the short-prompt ``ValueError`` and
the launchers.  Biases, norm weights and the mamba blocks' conv biases,
``D`` and ``norm_w`` are seeded random values (``test_torch_lm_common``).

Gates, those of the other family files: float32 at rtol 1e-4 / atol 1e-5
(``tests/test_torch_lm.py``), bfloat16 at twice the JAX package's own
bfloat16-vs-float32 distance, the loss, grad norm and lr at rtol 1e-5 and
the gradients within 1e-5 of each leaf's largest entry, the parameters
after AdamW steps at ``test_torch_lm_common.adamw_gate``
(``tests/test_torch_train.py``); prefill(S) + decode(S) against
prefill(S + 1) at rtol = atol = 0.15 (``tests/test_arch_smoke.py:65-83``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_lm_common import (SSM, adamw_gate, assert_params_within, both,  # noqa: E402
                                  f32, jax_params, jax_train_run, numpy_params, smoke,
                                  tokens)

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
from repro_torch.runtime import TrainLoopConfig, train_loop  # noqa: E402

MAMBA, ZAMBA = SSM
F32_TOL = dict(rtol=1e-4, atol=1e-5)
B, S, EXTRA = 2, 40, 4          # S = 2 chunks of 16 + 8: the pad path
SEQ, LR = 80, 3e-3              # SEQ = 2 chunks of 32 + a remainder of 16
QUIET = dict(log_fn=lambda s: None)
CACHE = {MAMBA: ("conv_x", "conv_BC", "ssm"),
         ZAMBA: ("attn_k", "attn_v", "conv_x", "conv_BC", "ssm", "conv_x_tail",
                 "conv_BC_tail", "ssm_tail")}
TOPS = {MAMBA: ["blocks", "final_norm", "tok_emb"],
        ZAMBA: ["final_norm", "lm_head", "mamba_groups", "mamba_tail", "shared_attn",
                "tok_emb"]}
SSM_KEYS = ["A_log", "D", "conv_BC_b", "conv_BC_w", "conv_x_b", "conv_x_w", "dt_bias", "in_BC",
            "in_dt", "in_x", "in_z", "norm_w", "out_proj"]


def _leaf_close(got, want, rel=1e-5, what=""):
    got, want = f32(got), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _n_blocks(cfg):
    """The blocks a forward pass runs: the mamba layers, and the hybrid's
    shared block once a group."""
    if cfg.family == "ssm":
        return cfg.n_layers
    return cfg.hybrid_groups * (cfg.hybrid_group_len + 1) + cfg.hybrid_tail


# ---------------------------------------------------------------------------
# serving: prefill, decode, the caches, forward
# ---------------------------------------------------------------------------


def _run_jax(arch, jm, jp, toks, S_cap, step_tok):
    logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=S_cap))(
        jp, {"tokens": jnp.asarray(toks)})
    dlogits, dcache = jax.jit(jm.decode_step)(
        jp, {"token": jnp.asarray(step_tok), "pos": jnp.asarray(toks.shape[1], jnp.int32)},
        cache)
    return [logits] + [cache[k] for k in CACHE[arch]] + [dlogits] + [dcache[k]
                                                                   for k in CACHE[arch]]


def _run_port(arch, tm, tp, toks, S_cap, step_tok):
    logits, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=S_cap)
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


@pytest.mark.parametrize("arch", SSM)
def test_ssm_lm_float32_prefill_decode_and_cache(arch):
    jcfg, tcfg, jm, tm, jp, tp = both(arch, "float32")
    toks = tokens(jcfg.vocab, B, S, seed=1)
    step = tokens(jcfg.vocab, B, 1, seed=2)
    want = _run_jax(arch, jm, jp, toks, S + EXTRA, step)
    got = _run_port(arch, tm, tp, toks, S + EXTRA, step)
    for name, g, w in zip(_names(arch), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(f32(g), f32(w), err_msg=name, **F32_TOL)
    n = len(CACHE[arch])
    cache = dict(zip(CACHE[arch], got[n + 2:]))
    assert tuple(cache["ssm"].shape[-3:]) == (tcfg.ssm_heads, tcfg.ssm_headdim, tcfg.ssm_state)
    if arch == ZAMBA:     # the shared block's K/V: one a group, zero after the step
        assert tuple(cache["attn_k"].shape) == (tcfg.hybrid_groups, B, S + EXTRA,
                                                tcfg.n_kv_heads, tcfg.head_dim)
        assert float(cache["attn_k"][:, :, S].abs().min()) >= 0
        assert float(cache["attn_v"][:, :, S].abs().max()) > 0
        assert float(cache["attn_v"][:, :, S + 1:].abs().max()) == 0.0


@pytest.mark.parametrize("arch", SSM)
def test_ssm_lm_bfloat16_prefill_decode_and_cache(arch):
    """bfloat16 at twice the JAX package's own bfloat16-vs-float32
    distance, on the logits and every cache entry (the SSD cumulative sums
    and their exponentials in bfloat16 in both packages)."""
    jcfg, tcfg, jm, tm, jp, tp = both(arch, "bfloat16")
    toks = tokens(jcfg.vocab, B, S, seed=3)
    step = tokens(jcfg.vocab, B, 1, seed=4)
    want = _run_jax(arch, jm, jp, toks, S + EXTRA, step)
    got = _run_port(arch, tm, tp, toks, S + EXTRA, step)
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    jp32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jp)
    want32 = _run_jax(arch, jget_model(jcfg32), jp32, toks, S + EXTRA, step)
    for name, g, w, w32 in zip(_names(arch), got, want, want32):
        assert g.shape == w.shape, name
        assert g.dtype == (torch.float32 if "logits" in name else torch.bfloat16), name
        bound = 2.0 * float(np.abs(f32(w) - f32(w32)).max())
        err = float(np.abs(f32(g) - f32(w)).max())
        assert 0.0 < bound and err <= bound, (name, err, bound)


@pytest.mark.parametrize("arch", SSM)
def test_ssm_forward_matches_jax_float32(arch):
    """The final hidden states; the aux loss 0 (no MoE block)."""
    jcfg, tcfg, jm, tm, jp, tp = both(arch, "float32")
    toks = tokens(jcfg.vocab, B, S, seed=5)
    jh, jaux = jax.jit(lambda p, b: jlm.forward(p, b, jcfg))(jp, {"tokens": jnp.asarray(toks)})
    th, taux = tlm.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(f32(th), f32(jh), **F32_TOL)
    assert taux.dtype == torch.float32 and float(taux) == float(jaux) == 0.0


def test_hybrid_shared_block_runs_before_every_group():
    """zamba2's one shared block is the same module at each of its G
    invocations, each writing its own group's K/V; the mamba layers run
    group by group, then the tail."""
    _, tcfg, _, tm, _, tp = both(ZAMBA, "float32")
    order = []
    orig = tlm._block_apply

    def spy(lp, x, cfg, cache_out=None):
        order.append(lp)
        return orig(lp, x, cfg, cache_out)

    tlm._block_apply = spy
    try:
        tm.prefill(tp, {"tokens": torch.from_numpy(tokens(tcfg.vocab, B, 8, seed=6))})
    finally:
        tlm._block_apply = orig
    L = tcfg.hybrid_group_len
    want = []
    for g in range(tcfg.hybrid_groups):
        want += [tp.shared_attn] + [tp.mamba_groups[g][l] for l in range(L)]
    want += list(tp.mamba_tail)
    assert len(order) == len(want) == _n_blocks(tcfg)
    assert all(a is b for a, b in zip(order, want))


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


@pytest.mark.parametrize("arch", SSM)
def test_ssm_serve_greedy_tokens_float32(arch):
    """The port's generate loop on the reference's weights: the reference
    loop's greedy tokens, token for token."""
    jcfg, tcfg, jm, tm, jp, tp = both(arch, "float32")
    toks = tokens(jcfg.vocab, B, 16, seed=6)
    want = _jax_greedy(jm, jp, toks, 8)
    got = tserve.generate(tm, tp, torch.from_numpy(toks), 8)
    np.testing.assert_array_equal(got["generated"], want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", SSM)
def test_ssm_prefill_then_decode_matches_full_forward(arch, dtype):
    """tests/test_arch_smoke.py:65-83 in the port, on the port's own init:
    the O(1)-state step after the chunked prefill against the chunked
    prefill of one more token."""
    _, cfg = smoke(arch, dtype)
    model = tget_model(cfg)
    params = model.init_params(0, device="cpu")
    Sp = 32
    toks = torch.from_numpy(tokens(cfg.vocab, 2, Sp + 1, seed=0).astype(np.int64))
    logits_pre, cache = model.prefill(params, {"tokens": toks[:, :Sp]}, cache_len=Sp + 1)
    assert logits_pre.shape == (2, cfg.vocab)
    logits_dec, _ = model.decode_step(params, {"token": toks[:, Sp:Sp + 1], "pos": Sp}, cache)
    logits_full, _ = model.prefill(params, {"tokens": toks})
    np.testing.assert_allclose(f32(logits_dec), f32(logits_full), rtol=0.15, atol=0.15)


@pytest.mark.parametrize("arch", SSM)
def test_ssm_decode_cache_shapes_stable(arch):
    """tests/test_arch_smoke.py:85-100 in the port: the reference's cache
    layout, written in place; the SSM family's cache is the same size at
    any context."""
    _, cfg = smoke(arch)
    model = tget_model(cfg)
    params = model.init_params(0, device="cpu")
    cache = model.init_cache(2, 32, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in cache.items()}
    Kc, gn2 = cfg.ssm_conv - 1, 2 * cfg.ssm_ngroups * cfg.ssm_state
    st = (cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
    if arch == MAMBA:
        L = cfg.n_layers
        assert shapes == {"conv_x": (L, 2, Kc, cfg.d_inner), "conv_BC": (L, 2, Kc, gn2),
                          "ssm": (L, 2) + st}
        nbytes = sum(v.numel() * v.element_size() for v in cache.values())
        long = model.init_cache(2, 4096, device="cpu")
        assert sum(v.numel() * v.element_size() for v in long.values()) == nbytes
    else:
        G, L, T = cfg.hybrid_groups, cfg.hybrid_group_len, cfg.hybrid_tail
        kv = (G, 2, 32, cfg.n_kv_heads, cfg.head_dim)
        assert shapes == {"attn_k": kv, "attn_v": kv, "conv_x": (G, L, 2, Kc, cfg.d_inner),
                          "conv_BC": (G, L, 2, Kc, gn2), "ssm": (G, L, 2) + st,
                          "conv_x_tail": (T, 2, Kc, cfg.d_inner),
                          "conv_BC_tail": (T, 2, Kc, gn2), "ssm_tail": (T, 2) + st}
    assert all(v.dtype == torch.bfloat16 for v in cache.values())
    logits, new_cache = model.decode_step(
        params, {"token": torch.zeros((2, 1), dtype=torch.long), "pos": 3}, cache)
    assert logits.shape == (2, cfg.vocab) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    assert {k: tuple(v.shape) for k, v in new_cache.items()} == shapes
    for k in ("conv_x", "ssm"):
        assert float(new_cache[k].abs().max()) > 0, k
    if arch == ZAMBA:
        assert float(new_cache["attn_k"][:, :, 3].abs().max()) > 0
        assert float(new_cache["attn_k"][:, :, 4:].abs().max()) == 0.0


@pytest.mark.parametrize("arch", SSM)
def test_ssm_short_prompt_raises(arch):
    """A prompt shorter than the conv window (ssm_conv - 1 rows) has no
    prefill cache in the reference either: a clear ValueError; the
    window's own length serves."""
    _, cfg = smoke(arch, "float32")
    model = tget_model(cfg)
    params = model.init_params(0, device="cpu")
    Kc = cfg.ssm_conv - 1
    toks = torch.from_numpy(tokens(cfg.vocab, 1, Kc, seed=7).astype(np.int64))
    with pytest.raises(ValueError, match="shorter than the conv window"):
        model.prefill(params, {"tokens": toks[:, :Kc - 1]}, cache_len=8)
    logits, cache = model.prefill(params, {"tokens": toks}, cache_len=8)
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# the parameters: layout, leaf order, ranks, conversion
# ---------------------------------------------------------------------------


def _want_layout(jtree):
    """{port parameter name: (shape, dtype)} of the reference's tree: a
    stacked leaf's layers under their indices (g-major for the groups)."""
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        keys = [p.key for p in path]
        lead = {"blocks": 1, "mamba_tail": 1, "mamba_groups": 2}.get(keys[0], 0)
        for idx in np.ndindex(*leaf.shape[:lead]):
            want[".".join([keys[0]] + [str(i) for i in idx] + keys[1:])] = (
                leaf.shape[lead:], str(leaf.dtype))
    return want


@pytest.mark.parametrize("arch", SSM)
def test_ssm_init_matches_reference_layout(arch):
    """Leaf names, shapes and dtypes of the port's init are the reference's
    (the stacks unstacked, the hybrid's groups by (g, l), its shared block
    alone; A_log, D, dt_bias, norm_w and the norms float32), and so is the
    count, within 10% of ``param_count``."""
    jcfg, cfg = smoke(arch)
    jtree = jget_model(jcfg).init_params(jax.random.key(0))
    params = tget_model(cfg).init_params(torch.Generator().manual_seed(0))
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in params.named_parameters()}
    assert got == _want_layout(jtree)
    first = "blocks.0" if arch == MAMBA else "mamba_groups.1.0"
    for k in ("A_log", "D", "dt_bias", "norm_w"):
        assert got[f"{first}.ssm.{k}"][1] == "float32", k
    assert got[f"{first}.ssm.in_x"][1] == "bfloat16"
    if arch == ZAMBA:
        assert isinstance(params.shared_attn, tlm.DenseBlock)
        assert isinstance(params.mamba_groups[1][1], tlm.MambaBlock)
        assert len(params.mamba_groups) == cfg.hybrid_groups
        assert not hasattr(params, "blocks")
    else:
        assert isinstance(params.blocks[0], tlm.MambaBlock)
    count = sum(v.numel() for v in params.parameters())
    assert count == sum(int(np.prod(l.shape)) for l in jax.tree.leaves(jtree))
    assert abs(count - cfg.param_count()) / count < 0.1
    again = tget_model(cfg).init_params(0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tlm.init_params(0, cfg, "cpu").parameters(),
                                                 again.parameters()))


@pytest.mark.parametrize("arch", SSM)
def test_ssm_leaf_paths_and_ranks_follow_the_reference_tree(arch):
    """``leaf_paths`` lists the reference's sorted tree paths (the mamba
    keys upper case first), a block leaf layer by layer, g-major in the
    groups; ``ref_ndims`` gives each leaf's rank there: + 1 in ``blocks``
    and ``mamba_tail``, + 2 in ``mamba_groups``, + 0 in ``shared_attn``, so
    AdamW decays the stacked A_log, D, dt_bias, norm_w and ln1 but not the
    shared block's ln1 and ln2."""
    jcfg, tcfg = smoke(arch, "float32")
    tp = convert.lm_params_from_jax(numpy_params(jcfg), tcfg, device="cpu")
    jp = jget_model(jcfg).init_params(jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    ref = [tuple(k.key for k in path) for path, _ in flat]
    paths = [p for _, p, _ in tlm.leaf_paths(tp)]
    assert list(dict.fromkeys(paths)) == ref
    assert list(dict.fromkeys(p[0] for p in ref)) == TOPS[arch]
    stack = "blocks" if arch == MAMBA else "mamba_groups"
    assert [p[-1] for p in ref if p[:2] == (stack, "ssm")] == SSM_KEYS
    ranks = {tuple(k.key for k in path): leaf.ndim for path, leaf in flat}
    nd = tlm.ref_ndims(tp)
    for name, path, _ in tlm.leaf_paths(tp):
        assert nd[name] == ranks[path], name
    names = list(tlm.leaves(tp))
    if arch == MAMBA:
        assert nd["blocks.0.ssm.A_log"] == 2 and nd["blocks.1.ln1"] == 2
        assert nd["final_norm"] == 1
        return
    i = names.index("mamba_groups.0.0.ssm.A_log")
    assert names[i:i + 4] == [f"mamba_groups.{g}.{l}.ssm.A_log" for g in (0, 1) for l in (0, 1)]
    assert nd["mamba_groups.1.1.ssm.D"] == 3 and nd["mamba_groups.0.1.ln1"] == 3
    assert nd["mamba_tail.0.ssm.norm_w"] == 2 and nd["mamba_tail.0.ssm.in_x"] == 3
    assert nd["shared_attn.ln1"] == 1 and nd["shared_attn.ln2"] == 1
    assert nd["shared_attn.attn.wq"] == 2 and nd["shared_attn.mlp.wg"] == 2
    layer = {n: l for n, _, l in tlm.leaf_paths(tp)}
    assert layer["mamba_groups.1.0.ssm.D"] == (1, 0) and layer["shared_attn.ln1"] is None


@pytest.mark.parametrize("arch", SSM)
def test_ssm_convert_round_trip(arch):
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = smoke(arch, dtype)
        tree = numpy_params(jcfg)
        tp = convert.lm_params_from_jax(tree, tcfg, device="cpu")
        blk = tp.blocks[1] if arch == MAMBA else tp.mamba_groups[1][0]
        for name in ("A_log", "D", "dt_bias", "norm_w"):
            assert blk["ssm"][name].dtype == torch.float32
        assert blk["ssm"]["in_BC"].dtype == (torch.bfloat16 if dtype == "bfloat16"
                                             else torch.float32)
        if arch == ZAMBA:
            np.testing.assert_array_equal(f32(blk["ssm"]["D"]),
                                          tree["mamba_groups"]["ssm"]["D"][1, 0])
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


@pytest.mark.parametrize("arch", SSM)
def test_ssm_train_state_tree_has_the_reference_keys(arch):
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
    stack = "blocks" if arch == MAMBA else "mamba_groups"
    assert str(ft[f"opt/mu/{stack}/ssm/A_log/m"].dtype) == "torch.float32"
    assert str(ft[f"opt/mu/{stack}/ssm/in_z/v"].dtype) == "torch.bfloat16"


# ---------------------------------------------------------------------------
# training: loss_fn, gradients, train steps, remat
# ---------------------------------------------------------------------------


def _stream(arch, seq=SEQ, batch=B):
    return JStream(vocab=smoke(arch)[0].vocab, seq=seq, global_batch=batch, seed=0)


@pytest.mark.parametrize("arch", SSM)
def test_ssm_loss_fn_matches_jax_float32(arch):
    jcfg, tcfg, jm, tm, jp, tp = both(arch, "float32")
    toks = np.asarray(_stream(arch).batch(0)["tokens"])
    jl_, jmet = jax.jit(jm.loss_fn)(jp, {"tokens": jnp.asarray(toks)})
    tl_, tmet = tm.loss_fn(tp, {"tokens": torch.tensor(toks)})
    assert set(tmet) == {"loss", "aux", "tokens"}
    assert tl_.grad_fn is None and float(tmet["aux"]) == 0.0
    np.testing.assert_allclose(float(tl_), float(jl_), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["tokens"]), float(jmet["tokens"]))


@pytest.mark.parametrize("arch", SSM)
def test_ssm_first_step_gradients_match_jax_float32(arch):
    """Every leaf's gradient: the mamba leaves (A_log and dt_bias through
    SSD's cumulative sums and exponentials), and the hybrid's shared
    block, its gradient the sum over its G invocations."""
    jcfg, tcfg, jm, tm, jp, tp = both(arch, "float32")
    toks = np.asarray(_stream(arch).batch(0)["tokens"])
    jg = jax.grad(lambda p: jm.loss_fn(p, {"tokens": jnp.asarray(toks)})[0])(jp)
    with tlm.trainable(tp):
        loss, _ = tm.loss_fn(tp, {"tokens": torch.tensor(toks)})
        named = tlm.leaves(tp)
        tg = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    for name, path, layer in tlm.leaf_paths(tp):
        want = f32(_at(jg, path))
        _leaf_close(tg[name], want if layer is None else want[layer], what=name)
    first = "blocks.0" if arch == MAMBA else "mamba_groups.1.1"
    watch = [f"{first}.ssm.{k}" for k in ("A_log", "dt_bias", "D", "norm_w", "conv_x_w")]
    if arch == ZAMBA:
        watch += ["shared_attn.ln1", "shared_attn.attn.wq", "shared_attn.mlp.wd",
                  "mamba_tail.0.ssm.in_BC"]
    for name in watch:
        assert float(tg[name].abs().max()) > 0, name


def _jax_state(tp, to, jcfg):
    """The port's parameters and AdamW state as the reference's: (params in
    its dtypes, its AdamW state)."""
    tree = convert.train_state_to_jax(tp, to)
    opt = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree["opt"])
    return jax_params(convert.lm_params_to_jax(tp), jcfg), opt


@pytest.mark.parametrize("arch", SSM)
def test_ssm_three_train_steps_match_jax_float32(arch):
    """Three ``make_train_step`` steps, each held against the reference's
    step from the same parameters and AdamW state (the port's before it):
    its loss, aux, grad norm and lr at rtol 1e-5 and the parameters after
    it at ``adamw_gate``.  The first step is the reference's straight run's.
    A straight three-step run is not held here: the first AdamW step moves
    an entry whose gradient sits at the float32 noise of its sum by up to a
    whole lr, as ``adamw_gate`` allows, and on zamba2's SMOKE model that
    moves the later steps' gradients by up to 1e-3 of a leaf's largest
    (the third step's grad norm 4.9e-5 off the reference's own run, its
    ``lm_head`` 2.4 gates off after three steps), a distance of the
    parameters the steps were given and not of the steps."""
    jcfg, tcfg, jm, tm, jp, tp = both(arch, "float32")
    jocfg = joptim.AdamWConfig(lr=joptim.warmup_cosine(LR, 2, 50))
    tocfg = optim.AdamWConfig(lr=optim.warmup_cosine(LR, 2, 50))
    tstep = make_train_step(tm, tocfg)
    to = optim.init(tlm.leaves(tp), tocfg)
    before = {k: v.clone() for k, v in tlm.leaves(tp).items()}
    stream = TokenStream(vocab=tcfg.vocab, seq=SEQ, global_batch=B, seed=0)
    for s in range(3):
        jps, jos = (jp, None) if s == 0 else _jax_state(tp, to, jcfg)
        want, _, jmets, jgrads = jax_train_run(jm, jps, jocfg, _stream(arch), 1,
                                               opt_state=jos, start=s)
        out, to, m = tstep(tp, to, stream.batch(s, device="cpu"))
        assert out is tp and int(to["step"]) == s + 1
        for k in ("loss", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jmets[0][k]), rtol=1e-5,
                                       err_msg=f"step {s} {k}")
        assert_params_within(convert.lm_params_to_jax(tp), want, adamw_gate(want, jmets, jgrads))
    assert all(not torch.equal(before[k], v) for k, v in tlm.leaves(tp).items())
    assert not any(p.requires_grad for p in tp.parameters())


@pytest.mark.parametrize("arch", SSM)
def test_ssm_bfloat16_train_step_keeps_the_float32_leaves(arch):
    """AdamW's clip and update take the float32 leaves (A_log, D, dt_bias,
    norm_w, the norms) beside the bfloat16 ones: they and their moments
    stay float32 and move."""
    _, tcfg, _, tm, _, tp = both(arch, "bfloat16")
    ocfg = optim.AdamWConfig(lr=optim.warmup_cosine(LR, 2, 50))
    to = optim.init(tlm.leaves(tp), ocfg)
    blk = tp.blocks[0] if arch == MAMBA else tp.mamba_groups[0][1]
    prefix = "blocks.0" if arch == MAMBA else "mamba_groups.0.1"
    watch = {f"{prefix}.ssm.{k}": blk["ssm"][k] for k in ("A_log", "D", "dt_bias", "norm_w")}
    if arch == ZAMBA:
        watch["shared_attn.ln2"] = tp.shared_attn.ln2
    before = {k: v.detach().clone() for k, v in watch.items()}
    assert all(to["mu"][k]["m"].dtype == torch.float32 for k in watch)
    assert to["mu"][f"{prefix}.ssm.in_x"]["m"].dtype == torch.bfloat16
    step = make_train_step(tm, ocfg)
    stream = TokenStream(vocab=tcfg.vocab, seq=SEQ, global_batch=B, seed=0)
    for s in range(3):
        _, to, m = step(tp, to, stream.batch(s, device="cpu"))
        assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    for k, v in watch.items():
        assert v.dtype == torch.float32 and not torch.equal(before[k], v), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SSM)
def test_ssm_remat_on_and_off_agree(arch, dtype):
    """Per-block checkpointing (the shared block's at each invocation too):
    loss and every gradient bitwise equal with and without it."""
    _, tcfg, _, _, _, tp = both(arch, dtype)
    toks = torch.tensor(np.asarray(_stream(arch).batch(1)["tokens"]))
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
        assert calls.count("_block_apply") == (_n_blocks(tcfg) if remat else 0)
        out.append((loss, grads))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the loop's checkpoints across packages
# ---------------------------------------------------------------------------

LOOP_SEQ = 48


def _lm(arch):
    jcfg, tcfg, jm, tm, jp, tp = both(arch, "float32")
    jo = joptim.AdamWConfig(lr=joptim.warmup_cosine(LR, 2, 50))
    to = optim.AdamWConfig(lr=optim.warmup_cosine(LR, 2, 50))
    return (jm, tm, jp, tp, jo, to, _stream(arch, LOOP_SEQ),
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


@pytest.mark.parametrize("arch", SSM)
def test_ssm_jax_checkpoint_resumes_in_the_port(arch, tmp_path):
    """The JAX package's loop writes step 3 (the hybrid's (G, L, ...)
    groups, its tail and its shared block); the port restores it and runs
    to step 6: the JAX package's run straight to 6."""
    jm, tm, jp, tp, jo, to, js, ts = _lm(arch)
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


@pytest.mark.parametrize("arch", SSM)
def test_ssm_port_checkpoint_resumes_in_jax(arch, tmp_path):
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


def test_hybrid_train_loop_restart_is_bitwise():
    """On the CPU a restart from the loop's checkpoint is the straight run
    bit for bit: 4 steps straight against 2, a fresh model restored, 2
    more (the groups, the tail and the shared block with their moments)."""
    import tempfile

    runs = []
    for split in (None, 2):
        _, tm, _, tp, _, to, _, ts = _lm(ZAMBA)
        with tempfile.TemporaryDirectory() as d:
            if split:
                _port_run(tm, tp, to, ts, split, d)
                _, tm, _, tp, _, to, _, ts = _lm(ZAMBA)
            p, o, rep = _port_run(tm, tp, to, ts, 4, d)
        assert rep["final_step"] == 4
        runs.append((p, o))
    (pa, oa), (pb, ob) = runs
    assert "shared_attn.attn.wq" in tlm.leaves(pa)
    for k, v in tlm.leaves(pa).items():
        assert torch.equal(v, tlm.leaves(pb)[k]), k
        assert torch.equal(oa["mu"][k]["v"], ob["mu"][k]["v"]), k


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SSM)
def test_ssm_serve_and_train_clis_on_the_cpu(arch, capsys):
    r = tserve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "8",
                     "--gen", "3", "--device", "cpu"])
    assert r["generated"].shape == (2, 3)
    rep = ttrain.main(["--device", "cpu", "--arch", arch, "--smoke", "--steps", "3",
                       "--batch", "2", "--seq", "32"])
    assert rep["final_step"] == 3 and np.isfinite(rep["history"][0]["loss"])
    out = capsys.readouterr().out
    assert "ms/tok" in out and "first_loss=" in out


def test_hybrid_build_gives_the_hybrid_model():
    cfg, model, params, opt_state, step_fn, stream, extras, shard = ttrain.build(
        ZAMBA, smoke=True, batch=2, seq=16, lr=1e-3, device="cpu")
    assert cfg.family == "hybrid" and shard == (None, None)
    assert isinstance(params.shared_attn, tlm.DenseBlock)
    assert "mamba_groups.1.1.ssm.A_log" in opt_state["mu"]
    before = params.shared_attn.attn.wq.detach().clone()
    _, _, m = step_fn(params, opt_state, stream.batch(0, extras, device="cpu"))
    assert np.isfinite(float(m["loss"]))
    assert not torch.equal(before, params.shared_attn.attn.wq)


@pytest.mark.parametrize("arch", SSM)
def test_ssm_entry_points_default_to_the_card(arch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    _, cfg = smoke(arch)
    model = tget_model(cfg)
    for call in (lambda: tserve.serve(arch, smoke=True, batch=1, prompt_len=4, gen=1),
                 lambda: model.init_params(0), lambda: model.init_cache(1, 4),
                 lambda: ttrain.build(arch, smoke=True, batch=1, seq=8, lr=1e-3)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
