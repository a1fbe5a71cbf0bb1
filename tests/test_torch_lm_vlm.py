"""The port's VLM family (``repro_torch.models.lm``'s cross blocks and
self groups, through ``get_model``) against the JAX package's on one set
of weights, on llama-3.2-vision-11b's SMOKE config (2 groups of 1 gated
cross block + 2 self blocks, d 64, 4/2 heads of 16, 16 image tokens, vocab
256, untied head), the cross blocks' gates seeded random values (zero at
init): ``prefill`` (the logits and every cache entry: the self blocks'
K/V (G, cross_every, B, S, K, Dh) padded to the capacity, the image K/V
(G, B, T, K, Dh)), ``decode_step``, greedy serving with the image in the
prefill's batch, ``loss_fn``, the first step's gradients on every leaf
(the gates' and the cross attention's included) and three
``make_train_step`` steps on batches that carry the image, remat,
``leaf_paths`` in the reference's sorted tree and ``ref_ndims`` at its
ranks (a gate (G, 1): rank 2, decayed; a self-group leaf + 2), the
parameters carried both ways, train-loop checkpoints resumed across
packages, the extras ``build`` and ``serve`` draw, and the launchers.  The
cases and their gates are ``tests/test_torch_lm_extras.py``'s."""
import pytest

torch = pytest.importorskip("torch")

import test_torch_lm_extras as cases  # noqa: E402

from repro_torch.models import lm as tlm  # noqa: E402

ARCH = cases.VLM


def test_vlm_float32_prefill_decode_and_cache():
    got = cases.prefill_decode_float32(ARCH)
    assert got[3].shape[2] == cases.smoke(ARCH)[1].n_img_tokens


def test_vlm_bfloat16_prefill_decode_and_cache():
    cases.prefill_decode_bfloat16(ARCH)


def test_vlm_serve_greedy_tokens_float32():
    cases.serve_greedy_tokens_float32(ARCH)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_vlm_prefill_then_decode_matches_full_forward(dtype):
    cases.prefill_then_decode_matches_full(ARCH, dtype)


def test_vlm_decode_cache_shapes_stable():
    shapes = cases.decode_cache_shapes_stable(ARCH)
    cfg = cases.smoke(ARCH)[1]
    G, per, K, Dh = tlm.vlm_groups(cfg), cfg.cross_every, cfg.n_kv_heads, cfg.head_dim
    assert shapes == {"k": (G, per, 2, 32, K, Dh), "v": (G, per, 2, 32, K, Dh),
                      "img_k": (G, 2, cfg.n_img_tokens, K, Dh),
                      "img_v": (G, 2, cfg.n_img_tokens, K, Dh)}


def test_vlm_gates_at_zero_keep_the_image_out():
    """At init (gates 0, tanh 0) the image changes no logit; with the gates
    set it does, and each group runs its cross block before its self
    blocks."""
    _, cfg = cases.smoke(ARCH, "float32")
    model = cases.tget_model(cfg)
    params = model.init_params(0, device="cpu")
    toks = torch.from_numpy(cases.tokens(cfg.vocab, 2, 8, seed=0))
    a, b = (torch.from_numpy(cases.extras(cfg, 2, seed=s)["img"]) for s in (1, 2))
    la, _ = model.prefill(params, {"tokens": toks, "img": a})
    lb, _ = model.prefill(params, {"tokens": toks, "img": b})
    assert torch.equal(la, lb)
    _, _, params = cases.port_model(ARCH, "float32")
    order = []
    orig = tlm._block_apply

    def spy(lp, x, cfg_, cache_out=None, img=None):
        order.append(lp)
        return orig(lp, x, cfg_, cache_out, img=img)

    tlm._block_apply = spy
    try:
        la, _ = model.prefill(params, {"tokens": toks, "img": a})
    finally:
        tlm._block_apply = orig
    lb, _ = model.prefill(params, {"tokens": toks, "img": b})
    assert float((la - lb).abs().max()) > 1e-3
    want = []
    for g in range(tlm.vlm_groups(cfg)):
        want += [params.cross_blocks[g]] + list(params.self_groups[g])
    assert len(order) == len(want) == cfg.n_layers
    assert all(x is y for x, y in zip(order, want))


def test_vlm_init_matches_reference_layout():
    named = cases.init_matches_reference_layout(ARCH)
    assert isinstance(cases.tget_model(cases.smoke(ARCH)[1]).init_params(
        0, device="cpu").cross_blocks[0], tlm.CrossBlock)
    for k in ("cross_blocks.1.gate_attn", "cross_blocks.0.gate_mlp", "cross_blocks.0.ln2",
              "self_groups.1.0.ln1"):
        assert named[k].dtype == torch.float32, k
    assert tuple(named["cross_blocks.0.gate_attn"].shape) == (1,)
    assert float(named["cross_blocks.0.gate_mlp"].abs().max()) == 0.0
    assert "bq" not in dict(named) and "cross_blocks.0.mlp.wg" in named


def test_vlm_leaf_paths_and_ranks_follow_the_reference_tree():
    """A cross block's gate is (G, 1) in the reference: rank 2, decayed by
    AdamW; a self-group leaf takes its rank + 2; ``final_norm`` rank 1."""
    nd, names, layer = cases.leaf_paths_and_ranks(ARCH)
    assert nd["cross_blocks.0.gate_attn"] == 2 and nd["cross_blocks.1.gate_mlp"] == 2
    assert nd["cross_blocks.0.ln1"] == 2 and nd["cross_blocks.0.attn.wk"] == 3
    assert nd["self_groups.1.0.ln2"] == 3 and nd["self_groups.0.1.attn.wq"] == 4
    assert nd["final_norm"] == 1
    i = names.index("self_groups.0.0.attn.wq")
    assert names[i:i + 4] == [f"self_groups.{g}.{l}.attn.wq" for g in (0, 1) for l in (0, 1)]
    assert layer["self_groups.1.0.ln1"] == (1, 0) and layer["cross_blocks.1.gate_attn"] == 1


def test_vlm_convert_round_trip():
    cases.convert_round_trip(ARCH)


def test_vlm_train_state_tree_has_the_reference_keys():
    ft = cases.train_state_tree_has_the_reference_keys(ARCH)
    assert str(ft["opt/mu/cross_blocks/gate_attn/m"].dtype) == "torch.float32"
    assert tuple(ft["params/cross_blocks/gate_attn"].shape) == (2, 1)
    assert tuple(ft["params/self_groups/attn/wq"].shape)[:2] == (2, 2)


def test_vlm_loss_fn_matches_jax_float32():
    cases.loss_fn_matches_jax_float32(ARCH)


def test_vlm_first_step_gradients_match_jax_float32():
    cases.first_step_gradients_match_jax_float32(
        ARCH, ["cross_blocks.0.gate_attn", "cross_blocks.1.gate_mlp", "cross_blocks.0.attn.wk",
               "cross_blocks.1.attn.wv", "cross_blocks.0.mlp.wd", "cross_blocks.1.ln2",
               "self_groups.1.1.attn.wq", "lm_head", "tok_emb"])


def test_vlm_three_train_steps_match_jax_float32():
    cases.three_train_steps_match_jax_float32(ARCH)


def test_vlm_bfloat16_train_step_keeps_the_float32_leaves():
    cases.bfloat16_train_step_keeps_the_float32_leaves(
        ARCH, ["cross_blocks.0.gate_attn", "cross_blocks.1.gate_mlp", "cross_blocks.0.ln1",
               "self_groups.1.0.ln2", "final_norm"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_remat_on_and_off_agree(dtype):
    """Every block under ``torch.utils.checkpoint``, the cross blocks too."""
    cases.remat_on_and_off_agree(ARCH, dtype, tlm, "_block_apply",
                                 cases.smoke(ARCH)[1].n_layers)


def test_vlm_jax_checkpoint_resumes_in_the_port(tmp_path):
    cases.jax_checkpoint_resumes_in_the_port(ARCH, tmp_path)


def test_vlm_port_checkpoint_resumes_in_jax(tmp_path):
    cases.port_checkpoint_resumes_in_jax(ARCH, tmp_path)


def test_vlm_train_loop_restart_is_bitwise():
    cases.train_loop_restart_is_bitwise(ARCH)


def test_vlm_serve_and_train_clis_on_the_cpu(capsys):
    cases.serve_and_train_clis_on_the_cpu(ARCH, capsys)


def test_vlm_build_and_serve_draw_the_reference_extras():
    built = cases.build_and_serve_draw_the_reference_extras(ARCH)
    assert isinstance(built[2].cross_blocks[1], tlm.CrossBlock)
    assert "cross_blocks.1.gate_attn" in built[3]["mu"]


def test_vlm_entry_points_default_to_the_card():
    cases.entry_points_default_to_the_card(ARCH)
