"""Shared helpers for the LM half's parity tests (this file holds no tests).

One set of weights goes to both packages: the JAX package's
``init_params`` pytree as numpy, with its biases and norm weights set to
seeded random values (zeros and ones would hide a bias or norm fault),
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
BIASES = ("bq", "bk", "bv", "b1", "b2")
NORMS = ("ln1", "ln2", "final_norm")


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
        return node

    return perturb(tree)


def jax_params(tree, jcfg):
    """The numpy tree in the reference's dtypes (norms float32, the rest
    the model dtype)."""
    dt = jnp.bfloat16 if jcfg.dtype == "bfloat16" else jnp.float32

    def cast(node, name=None):
        if isinstance(node, dict):
            return {k: cast(v, k) for k, v in node.items()}
        return jnp.asarray(node, jnp.float32 if name in NORMS else dt)

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

