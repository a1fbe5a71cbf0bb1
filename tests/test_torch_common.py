"""Shared helpers for the port's parity tests (this file holds no tests).

The same numpy inputs go to the JAX package and to ``repro_torch``; the
JAX side runs as its own tests run it on the CPU (Pallas in interpret
mode), the port on CPU tensors (the kernels' plain versions).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

# six xdist workers share the box: keep each one's intra-op pool small
torch.set_num_threads(2)

CPU = "cpu"


def tt(a, dtype=None):
    """numpy (or a JAX array) -> CPU torch tensor."""
    a = np.asarray(a)
    if dtype is None:
        dtype = torch.int32 if a.dtype.kind in "iu" else torch.float32
    return torch.as_tensor(np.array(a), dtype=dtype)


def nn(t):
    """torch tensor or JAX array -> numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def uniform(rng, shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, size=shape).astype(np.float32)


def gp_data(N, p, seed, noise=0.05, lo=-1.0, hi=1.0):
    """Eq. 21 data as numpy: (X, y)."""
    rng = np.random.default_rng(seed)
    X = uniform(rng, (N, p), lo, hi)
    y = (np.sum(np.cos(X), axis=1) + noise * rng.standard_normal(N)).astype(np.float32)
    return X, y


def specs(expansion, p, *, n=5, backend="jnp", noise=0.05, num_features=32,
          seed=3, eps=0.8, rho=2.0, index_set="full", degree=None,
          block_rows=4096):
    """The same spec in both packages: (jax_spec, torch_spec)."""
    import jax.numpy as jnp
    from repro.core import fagp as jfagp
    from repro_torch.core import fagp as tfagp

    eps_np = np.full((p,), eps, np.float32)
    kw = dict(index_set=index_set, degree=degree, block_rows=block_rows,
              backend=backend, expansion=expansion)
    if expansion != "hermite":
        kw.update(num_features=num_features, seed=seed)
    js = jfagp.GPSpec.create(n, jnp.asarray(eps_np), rho, noise, **kw)
    ts = tfagp.GPSpec.create(n, eps_np, rho, noise, device=CPU, **kw)
    return js, ts
