"""The port's audio family (``repro_torch.models.encdec`` through
``get_model``) against the JAX package's on one set of weights, on
whisper-small's SMOKE config (2 encoder + 2 decoder layers, d 64, 4 heads
of 16, 32 frames, vocab 256, tied embeddings, LayerNorm with bias, 2-matrix
GELU MLPs): ``prefill`` (the logits and every cache entry: the decoder's
self K/V padded to the capacity, the encoder output's cross K/V),
``decode_step``, greedy serving with the frames in the prefill's batch,
``loss_fn``, the first step's gradients on every leaf and three
``make_train_step`` steps on batches that carry the frames, remat,
``leaf_paths`` in the reference's sorted tree and ``ref_ndims`` at its
ranks (each stacked LayerNorm's ``w`` and ``b`` rank 2, decayed;
``ln_enc`` / ``ln_dec`` rank 1), the parameters carried both ways,
train-loop checkpoints resumed across packages, the extras ``build`` and
``serve`` draw, and the launchers.  The cases and their gates are
``tests/test_torch_lm_extras.py``'s."""
import pytest

torch = pytest.importorskip("torch")

import test_torch_lm_extras as cases  # noqa: E402

from repro_torch.models import encdec  # noqa: E402

ARCH = cases.AUDIO


def test_audio_float32_prefill_decode_and_cache():
    got = cases.prefill_decode_float32(ARCH)
    # the cross K/V are the encoder output's: one row a frame
    assert got[3].shape[2] == cases.smoke(ARCH)[1].enc_len


def test_audio_bfloat16_prefill_decode_and_cache():
    cases.prefill_decode_bfloat16(ARCH)


def test_audio_serve_greedy_tokens_float32():
    cases.serve_greedy_tokens_float32(ARCH)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_audio_prefill_then_decode_matches_full_forward(dtype):
    cases.prefill_then_decode_matches_full(ARCH, dtype)


def test_audio_decode_cache_shapes_stable():
    shapes = cases.decode_cache_shapes_stable(ARCH)
    cfg = cases.smoke(ARCH)[1]
    L, K, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    assert shapes == {"self_k": (L, 2, 32, K, Dh), "self_v": (L, 2, 32, K, Dh),
                      "cross_k": (L, 2, cfg.enc_len, K, Dh),
                      "cross_v": (L, 2, cfg.enc_len, K, Dh)}


def test_audio_init_matches_reference_layout():
    named = cases.init_matches_reference_layout(ARCH)
    assert isinstance(named["enc_blocks.1.ln2.b"], torch.nn.Parameter)
    for k in ("enc_blocks.0.ln1.w", "dec_blocks.1.ln3.b", "ln_enc.w", "ln_dec.b"):
        assert named[k].dtype == torch.float32, k
    assert named["dec_pos"].dtype == torch.bfloat16


def test_audio_leaf_paths_and_ranks_follow_the_reference_tree():
    """Each stacked LayerNorm's ``w`` and ``b`` is (L, d) in the reference:
    rank 2, decayed by AdamW; the final ``ln_enc`` / ``ln_dec`` rank 1."""
    nd, names, layer = cases.leaf_paths_and_ranks(ARCH)
    assert nd["enc_blocks.0.ln1.w"] == 2 and nd["dec_blocks.1.ln3.b"] == 2
    assert nd["ln_enc.w"] == 1 and nd["ln_dec.b"] == 1
    assert nd["dec_blocks.0.mlp.b1"] == 2 and nd["dec_blocks.0.cross_attn.wk"] == 3
    assert nd["dec_pos"] == 2 and nd["tok_emb"] == 2
    i = names.index("dec_blocks.0.cross_attn.wk")
    assert names[i:i + 2] == ["dec_blocks.0.cross_attn.wk", "dec_blocks.1.cross_attn.wk"]
    assert layer["dec_blocks.1.ln1.w"] == 1 and layer["ln_dec.w"] is None


def test_audio_convert_round_trip():
    cases.convert_round_trip(ARCH)


def test_audio_train_state_tree_has_the_reference_keys():
    ft = cases.train_state_tree_has_the_reference_keys(ARCH)
    assert str(ft["opt/mu/enc_blocks/ln1/b/m"].dtype) == "torch.float32"
    assert str(ft["opt/mu/dec_blocks/self_attn/wq/v"].dtype) == "torch.bfloat16"


def test_audio_loss_fn_matches_jax_float32():
    cases.loss_fn_matches_jax_float32(ARCH)


def test_audio_first_step_gradients_match_jax_float32():
    cases.first_step_gradients_match_jax_float32(
        ARCH, ["enc_blocks.0.ln1.b", "enc_blocks.1.attn.wq", "dec_blocks.0.cross_attn.wk",
               "dec_blocks.1.mlp.b2", "dec_pos", "ln_enc.w", "ln_dec.b", "tok_emb"])


def test_audio_three_train_steps_match_jax_float32():
    cases.three_train_steps_match_jax_float32(ARCH)


def test_audio_bfloat16_train_step_keeps_the_float32_leaves():
    cases.bfloat16_train_step_keeps_the_float32_leaves(
        ARCH, ["enc_blocks.0.ln1.w", "dec_blocks.1.ln2.b", "ln_enc.b", "ln_dec.w"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_audio_remat_on_and_off_agree(dtype):
    """Each encoder and decoder block under ``torch.utils.checkpoint``."""
    cfg = cases.smoke(ARCH)[1]
    for fn, n in (("_enc_block", cfg.n_enc_layers), ("_dec_block", cfg.n_layers)):
        cases.remat_on_and_off_agree(ARCH, dtype, encdec, fn, n)


def test_audio_jax_checkpoint_resumes_in_the_port(tmp_path):
    cases.jax_checkpoint_resumes_in_the_port(ARCH, tmp_path)


def test_audio_port_checkpoint_resumes_in_jax(tmp_path):
    cases.port_checkpoint_resumes_in_jax(ARCH, tmp_path)


def test_audio_train_loop_restart_is_bitwise():
    cases.train_loop_restart_is_bitwise(ARCH)


def test_audio_serve_and_train_clis_on_the_cpu(capsys):
    cases.serve_and_train_clis_on_the_cpu(ARCH, capsys)


def test_audio_build_and_serve_draw_the_reference_extras():
    built = cases.build_and_serve_draw_the_reference_extras(ARCH)
    assert isinstance(built[2], encdec.EncDec)
    assert "enc_blocks.1.ln2.b" in built[3]["mu"]


def test_audio_entry_points_default_to_the_card():
    cases.entry_points_default_to_the_card(ARCH)
