"""Shared helpers for the LM half's parity tests (this file holds no tests).

One set of weights goes to both packages: the JAX package's
``init_params`` pytree as numpy, with its biases, norm weights and the
VLM's cross-block gates set to seeded random values (zeros and ones would
hide a bias, norm or gate fault),
fed to JAX as it is and to the port through
``repro_torch.models.convert.lm_params_from_jax``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.models import get_model as tget_model  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from repro_torch.models.convert import lm_params_from_jax  # noqa: E402

DENSE = ("qwen2-1.5b", "qwen2.5-3b", "smollm-360m", "starcoder2-3b")
MOE = ("olmoe-1b-7b",)
MLA = ("deepseek-v3-671b",)
SSM = ("mamba2-130m", "zamba2-7b")
# biases (``b``: a LayerNorm's) and norm weights (``w``: a LayerNorm's)
BIASES = ("bq", "bk", "bv", "b1", "b2", "conv_x_b", "conv_BC_b", "b")
# norm weights and the mamba block's skip D: ones in the reference's init
NORMS = ("ln1", "ln2", "ln3", "final_norm", "q_ln", "kv_ln", "mtp_norm_h", "mtp_norm_e",
         "norm_w", "D", "w")
# the VLM's cross-block gates: zeros in the reference's init, which would
# keep the image out of every logit and every cross-block leaf's gradient
GATES = ("gate_attn", "gate_mlp")
# leaves the reference keeps in float32 in a bfloat16 model (``b``: a
# LayerNorm's bias)
F32_LEAVES = NORMS + GATES + ("router", "A_log", "dt_bias", "b")


def f32(a):
    """JAX array (any float dtype) or torch tensor -> numpy float32."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).cpu().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def smoke(arch_id, dtype="bfloat16"):
    """The reference's SMOKE config of ``arch_id`` (at ``dtype``) and the
    port's copy of it."""
    jcfg = dataclasses.replace(JARCHS[arch_id].SMOKE, dtype=dtype)
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def numpy_params(jcfg, seed=0):
    """The JAX package's init at ``seed`` as float32 numpy, biases and norm
    weights replaced by seeded random values."""
    tree = jget_model(jcfg).init_params(jax.random.key(seed))
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), tree)
    rng = np.random.default_rng(100 + seed)

    def perturb(node, name=None):
        if isinstance(node, dict):
            return {k: perturb(v, k) for k, v in node.items()}
        if name in BIASES:
            return (0.1 * rng.standard_normal(node.shape)).astype(np.float32)
        if name in NORMS:
            return (1.0 + 0.2 * rng.standard_normal(node.shape)).astype(np.float32)
        if name in GATES:        # tanh(gate) of either sign, 0.3-0.8 in size
            size = rng.uniform(0.3, 1.1, node.shape)
            return (size * rng.choice([-1.0, 1.0], node.shape)).astype(np.float32)
        return node

    return perturb(tree)


def jax_params(tree, jcfg):
    """The numpy tree in the reference's dtypes (norms and the MoE router
    float32, the rest the model dtype)."""
    dt = jnp.bfloat16 if jcfg.dtype == "bfloat16" else jnp.float32

    def cast(node, name=None):
        if isinstance(node, dict):
            return {k: cast(v, k) for k, v in node.items()}
        return jnp.asarray(node, jnp.float32 if name in F32_LEAVES else dt)

    return cast(tree)


def both(arch_id, dtype="bfloat16", seed=0):
    """(jcfg, tcfg, JAX model, port model, JAX params, port params) on one
    set of weights."""
    jcfg, tcfg = smoke(arch_id, dtype)
    tree = numpy_params(jcfg, seed)
    return (jcfg, tcfg, jget_model(jcfg), tget_model(tcfg), jax_params(tree, jcfg),
            lm_params_from_jax(tree, tcfg, device="cpu"))


def tokens(vocab, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)).astype(np.int32)



def jax_train_run(jm, jp, jocfg, stream, steps, opt_state=None, start=0):
    """The reference's train steps taken one at a time (``jax.value_and_grad``
    of ``loss_fn``, then ``optim.apply_updates``, as its
    ``make_train_step``), from ``start``: (params, opt_state, per-step
    metrics, per-step gradients)."""
    from repro import optim as joptim

    @jax.jit
    def step(p, o, batch):
        (_, metrics), g = jax.value_and_grad(jm.loss_fn, has_aux=True)(p, batch)
        p, o, om = joptim.apply_updates(p, g, o, jocfg)
        return p, o, {**metrics, **om}, g

    o = joptim.init(jp, jocfg) if opt_state is None else opt_state
    mets, grads = [], []
    for s in range(start, start + steps):
        jp, o, m, g = step(jp, o, stream.batch(s))
        mets.append(m)
        grads.append(g)
    return jp, o, mets, grads


def adamw_gate(want, mets, grads, eps=1e-8, rel=1e-5):
    """Per-entry tolerance of a parameter tree after AdamW steps, against
    the reference's ``want``: ``rel`` of the leaf's largest entry, plus
    what the gradient gate (``rel`` of the step's largest gradient in the
    leaf) allows each step's update to move.  AdamW divides by
    sqrt(v) + eps, so a gradient error d at an entry whose gradient g is
    small moves its update by up to lr * 2 d / (|g| + eps) (at most a full
    2 lr, a sign flipped): an entry whose gradient is of the order of the
    float32 error of the sum that makes it is amplified, the others are
    not.  Returns {path: tolerance array}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        key = tuple(k.key for k in path)
        tol = np.full(leaf.shape, rel * float(np.abs(f32(leaf)).max()), np.float64)
        for m, g in zip(mets, grads):
            gl = g
            for k in key:
                gl = gl[k]
            gl = np.abs(f32(gl)).astype(np.float64)
            d = rel * gl.max()
            tol += float(m["lr"]) * np.minimum(2.0, 2.0 * d / (gl + eps))
        out[key] = tol
    return out


def assert_params_within(got_tree, want, tol):
    """Every entry of the port's parameters (``convert.lm_params_to_jax``)
    within its tolerance of the reference's ``want``."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        key = tuple(k.key for k in path)
        node = got_tree
        for k in key:
            node = node[k]
        err = np.abs(np.asarray(node, np.float64) - f32(leaf).astype(np.float64))
        worst = float((err / tol[key]).max())
        assert worst <= 1.0, ("/".join(key), float(err.max()), worst)
