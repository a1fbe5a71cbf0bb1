"""The port's row-sharded fit and serving (``core/distributed.py``) and its
shard-local spec plumbing (``core/shardspec.py``) on an 8-device CPU mesh
(``devices=["cpu"] * 8``), against the port's resident fit, the JAX
package's resident ``fagp.fit`` in-process, and the JAX package's own
``fit_distributed`` / ``predict_distributed`` run once in a subprocess
with ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` as
``tests/test_distributed.py`` runs them, at that test's gates."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_common import gp_data, nn, specs, tt, uniform  # noqa: E402

from repro.core import distributed as jdist  # noqa: E402
from repro.core import fagp as jfagp  # noqa: E402
from repro.core import shardspec as jshard  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import fagp as tfagp  # noqa: E402
from repro_torch.core import shardspec as tshard  # noqa: E402
from repro_torch.core.approximation import UnsupportedError  # noqa: E402
from repro_torch.launch.mesh import make_bank_mesh, make_local_mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8
# tests/test_distributed.py:51-61
U_GATE = dict(rtol=5e-3, atol=1e-4)
MEAN_GATE = dict(rtol=1e-3, atol=1e-4)
VAR_GATE = dict(rtol=5e-3, atol=1e-6)


def _data(N=512, p=2, seed=0, Q=128):
    X, y = gp_data(N, p, seed)
    return X, y, uniform(np.random.default_rng(seed + 100), (Q, p))


X, Y, XS = _data()
MESH = make_local_mesh(data=2, model=4, devices=CPU8)

JAX_DISTRIBUTED = """
    import jax, numpy as np, jax.numpy as jnp
    from repro.core import fagp, distributed as dgp
    from repro.launch.mesh import make_local_mesh

    d = dict(np.load({inp!r}))
    mesh = make_local_mesh(data=2, model=4)
    out = {{}}
    for backend in ("jnp", "pallas"):
        spec = fagp.GPSpec.create(8, eps=[0.8, 0.8], rho=2.0, noise=0.05, backend=backend)
        for tag, n in (("", 512), ("_ragged", 509)):
            st = dgp.fit_distributed(jnp.asarray(d["X"][:n]), jnp.asarray(d["y"][:n]), spec,
                                     mesh)
            mu, var = dgp.predict_distributed(jnp.asarray(d["Xs"]), st, mesh)
            out[backend + tag + "_u"] = np.asarray(st.u)
            out[backend + tag + "_mu"] = np.asarray(mu)
            out[backend + tag + "_var"] = np.asarray(var)
    np.savez({out!r}, **out)
"""


@pytest.fixture(scope="module")
def jax_distributed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_distributed")
    inp, out = str(tmp / "inputs.npz"), str(tmp / "out.npz")
    np.savez(inp, X=X, y=Y, Xs=XS)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_DISTRIBUTED.format(
        inp=inp, out=out))], capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-3000:]}"
    return dict(np.load(out))


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_fit_distributed_matches_single(backend):
    """tests/test_distributed.py::test_fit_distributed_matches_single on the
    port: the (data 2, model 4) fit's u, and its row-sharded serving,
    against the port's resident fit and the JAX package's resident fit at
    that test's gates; the distributed state is a full session."""
    js, ts = specs("hermite", 2, n=8, backend=backend)
    st = tfagp.fit(tt(X), tt(Y), ts)
    mu_ref, var_ref = tfagp.predict_mean_var(st, tt(XS))
    jst = jfagp.fit(jnp.asarray(X), jnp.asarray(Y), js)
    jmu, jvar = jfagp.predict_mean_var(jst, jnp.asarray(XS))
    dst = tdist.fit_distributed(tt(X), tt(Y), ts, MESH)
    assert dst.Phi is None and dst.b.shape == st.b.shape
    mu, var = tdist.predict_distributed(tt(XS), dst, MESH)
    for u_want, m_want, v_want in ((st.u, mu_ref, var_ref), (jst.u, jmu, jvar)):
        np.testing.assert_allclose(nn(dst.u), nn(u_want), **U_GATE)
        np.testing.assert_allclose(nn(mu), nn(m_want), **MEAN_GATE)
        np.testing.assert_allclose(nn(var), nn(v_want), **VAR_GATE)
    mu2, var2 = tfagp.predict_mean_var(dst, tt(XS))
    np.testing.assert_allclose(nn(mu2), nn(mu_ref), **MEAN_GATE)
    np.testing.assert_allclose(nn(var2), nn(var_ref), **VAR_GATE)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("N", [512, 509])
def test_matches_the_jax_fit_distributed(backend, N, jax_distributed):
    """The port's fit_distributed / predict_distributed against the JAX
    package's on the same inputs and mesh shape, N a multiple of the 8
    shards and not (three masked pad rows)."""
    tag = backend + ("" if N == 512 else "_ragged")
    _, ts = specs("hermite", 2, n=8, backend=backend)
    dst = tdist.fit_distributed(tt(X[:N]), tt(Y[:N]), ts, MESH)
    mu, var = tdist.predict_distributed(tt(XS), dst, MESH)
    np.testing.assert_allclose(nn(dst.u), jax_distributed[tag + "_u"], **U_GATE)
    np.testing.assert_allclose(nn(mu), jax_distributed[tag + "_mu"], **MEAN_GATE)
    np.testing.assert_allclose(nn(var), jax_distributed[tag + "_var"], **VAR_GATE)


@pytest.mark.parametrize("expansion", ["rff_se", "rff_matern52"])
def test_rff_fit_distributed_matches_single(expansion):
    """The schedule is expansion-generic: an RFF fit shards as the Hermite
    fit does (the spectral draws ride along with the spec)."""
    _, ts = specs(expansion, 2, num_features=32, backend="pallas")
    st = tfagp.fit(tt(X), tt(Y), ts)
    dst = tdist.fit_distributed(tt(X), tt(Y), ts, make_bank_mesh(4, devices=CPU8))
    mu, var = tdist.predict_distributed(tt(XS), dst, make_local_mesh(3, devices=CPU8))
    mu_ref, var_ref = tfagp.predict_mean_var(st, tt(XS))
    np.testing.assert_allclose(nn(mu), nn(mu_ref), **MEAN_GATE)
    np.testing.assert_allclose(nn(var), nn(var_ref), **VAR_GATE)


def test_one_shard_is_the_resident_moments():
    """On a one-device mesh the distributed fit's moments are the resident
    backend's moments hook over the shard's rows (in 16 row blocks, the
    JAX schedule's nblk), bit for bit, and a state served through
    predict_distributed on one shard equals predict_mean_var."""
    _, ts = specs("hermite", 2, n=6, backend="pallas")
    dst = tdist.fit_distributed(tt(X), tt(Y), ts, make_local_mesh(devices=["cpu"]))
    G, b = tfagp.get_backend("pallas").moments(tt(X), tt(Y), ts, tfagp._idx_tensor(ts),
                                               len(X) // 16, None)
    assert torch.equal(dst.b, b)
    mu, var = tdist.predict_distributed(tt(XS), dst, make_local_mesh(devices=["cpu"]))
    mu1, var1 = tfagp.predict_mean_var(dst, tt(XS))
    assert torch.equal(mu, mu1) and torch.equal(var, var1)


@pytest.mark.parametrize("N,M,dp", [(512, 64, 8), (10_000, 14_641, 4), (10_000, 625, 1),
                                    (3, 5, 2)])
def test_pick_nblk_is_the_jax_rule(N, M, dp):
    """The plain path's ~100 MB row blocks, as the JAX package picks them."""
    assert tdist._pick_nblk(N, M, dp) == jdist._pick_nblk(N, M, dp)


def test_removed_forms_and_refusals():
    """The removed legacy forms raise TypeError as in the JAX package; a
    state without a spec is refused; the HLO lowerings have no PyTorch
    meaning and name ROADMAP A8."""
    _, ts = specs("hermite", 2, n=6)
    with pytest.raises(TypeError, match="removed"):
        tdist.fit_distributed(tt(X), tt(Y), object(), object(), MESH)
    with pytest.raises(TypeError, match="expected mesh"):
        tdist.fit_distributed(tt(X), tt(Y), ts)
    with pytest.raises(TypeError, match="removed"):
        tdist.predict_distributed(tt(XS), (1, 2, 3), object(), object(), MESH)
    with pytest.raises(ValueError, match="self-describing"):
        tdist.predict_distributed(tt(XS), (1, 2, 3), MESH)
    for fn in (tdist.lower_fit, tdist.lower_predict):
        with pytest.raises(UnsupportedError, match="ROADMAP A8"):
            fn(None, MESH)


def test_shardspec_helpers_match_jax():
    """mesh_size / axis_size read a mesh as the JAX helpers do; spec_local
    moves every leaf (spectral draws too) and keeps the structure;
    omega_args is the draws' tuple."""
    mesh = make_bank_mesh(4, 2, devices=CPU8)

    class JMeshLike:        # the JAX helpers read only .shape
        shape = {"bank": 4, "data": 2}

    assert tshard.mesh_size(mesh) == jshard.mesh_size(JMeshLike) == 8
    assert tshard.axis_size(mesh, "data") == jshard.axis_size(JMeshLike, "data") == 2
    assert tshard.axis_size(mesh, "model") == jshard.axis_size(JMeshLike, "model") == 1
    js, ts = specs("rff_se", 2, num_features=8)
    assert len(tshard.omega_args(ts)) == len(jshard.omega_args(js)) == 1
    assert tshard.spec_local(ts, "cpu") is ts
    hs = specs("hermite", 2, n=4)[1]
    assert tshard.omega_args(hs) == ()
