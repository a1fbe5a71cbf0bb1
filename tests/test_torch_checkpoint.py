"""Port checkpoints (``repro_torch.checkpoint``): the atomic store's crash
safety (mirroring tests/test_lifecycle.py:70-118), bit-exact ``GP.save`` /
``GP.load`` round trips for every expansion with and without stored
features, versions, spec validation, and cross-loading with the JAX
package in both directions."""
import json
import os
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_common import gp_data, nn, specs, tt, uniform  # noqa: E402

from repro.checkpoint import gpstate as jgpstate  # noqa: E402
from repro.core.gp import GP as JGP  # noqa: E402
from repro.core.gp import GPSpec as JSpec  # noqa: E402
from repro_torch.checkpoint import gpstate, store  # noqa: E402
from repro_torch.core.gp import GP  # noqa: E402

EXPANSIONS = ["hermite", "rff_se", "rff_matern52"]
STATE_LEAVES = ("lam", "sqrtlam", "chol", "u", "b")
SPEC_LEAVES = ("eps", "rho", "noise", "omega")


def _dead_pid():
    """A pid guaranteed not to be running: a just-reaped child's."""
    proc = subprocess.Popen(["true"])
    proc.wait()
    return proc.pid


def _same(a, b) -> bool:
    """Bitwise equality of two leaves (tensor or JAX array), dtype and
    shape included; None equals None."""
    if a is None or b is None:
        return a is None and b is None
    a, b = nn(a), nn(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _assert_same_session(got, want, *, train: bool):
    for f in STATE_LEAVES + (("Phi", "y") if train else ()):
        assert _same(getattr(got.state, f), getattr(want.state, f)), f
    for f in SPEC_LEAVES:
        assert _same(getattr(got.spec, f), getattr(want.spec, f)), f
    for f in ("n", "index_set", "degree", "block_rows", "store_train", "backend",
              "expansion", "approximation"):
        assert getattr(got.spec, f) == getattr(want.spec, f), f


# ---------------------------------------------------------------------------
# The store: atomicity and crash safety
# ---------------------------------------------------------------------------


def test_latest_step_ignores_and_reaps_dead_writer_tmp(tmp_path):
    store.save(tmp_path, 2, {"a": np.arange(3.0)})
    stale = tmp_path / f"tmp.7.{_dead_pid()}"
    stale.mkdir()
    (stale / "arrays.npz").write_bytes(b"partial garbage")
    assert store.latest_step(tmp_path) == 2
    assert not stale.exists()


def test_live_writer_tmp_is_preserved(tmp_path):
    store.save(tmp_path, 0, {"a": np.arange(3.0)})
    mine = tmp_path / f"tmp.9.{os.getpid()}"
    mine.mkdir()
    assert store.latest_step(tmp_path) == 0
    assert mine.exists()


def test_restore_with_explicit_step_sweeps(tmp_path):
    tree = {"a": torch.arange(4.0)}
    store.save(tmp_path, 5, tree)
    stale = tmp_path / f"tmp.5.{_dead_pid()}"
    stale.mkdir()
    step, out = store.restore(tmp_path, tree, step=5, device="cpu")
    assert step == 5 and torch.equal(out["a"], tree["a"])
    assert not stale.exists()


def test_non_step_dirs_ignored(tmp_path):
    store.save(tmp_path, 1, {"a": np.zeros(2)})
    (tmp_path / "step_notanumber").mkdir()
    (tmp_path / "unrelated").mkdir()
    assert store.latest_step(tmp_path) == 1
    assert store.latest_step(tmp_path / "missing") is None
    with pytest.raises(FileNotFoundError):
        store.restore(tmp_path / "missing", {"a": 0}, device="cpu")


def test_interrupted_write_never_corrupts_previous(tmp_path):
    tree = {"a": torch.arange(6.0)}
    store.save(tmp_path, 3, tree)
    stale = tmp_path / f"tmp.3.{_dead_pid()}"
    stale.mkdir()
    (stale / "manifest.json").write_text("{corrupt")
    step, out = store.restore(tmp_path, tree, device="cpu")
    assert step == 3 and torch.equal(out["a"], tree["a"])


def test_store_layout_and_dtypes(tmp_path):
    """Nested keys sorted and joined by '/', '__' inside the npz; bfloat16
    stored as a uint16 view and restored bit-exactly."""
    tree = {"z": {"b": torch.ones(2, dtype=torch.bfloat16) / 3, "a": torch.arange(3)},
            "m": torch.tensor(0.5)}
    d = store.save(tmp_path, 0, tree, metadata={"k": 1})
    man = json.loads((d / "manifest.json").read_text())
    assert list(man["dtypes"]) == ["m", "z/a", "z/b"]
    assert man["dtypes"]["z/b"] == "bfloat16" and man["metadata"] == {"k": 1}
    with np.load(d / "arrays.npz") as z:
        assert sorted(z.files) == ["m", "z__a", "z__b"] and z["z__b"].dtype == np.uint16
    _, out = store.restore(tmp_path, tree, device="cpu")
    for got, want in ((out["z"]["b"], tree["z"]["b"]), (out["z"]["a"], tree["z"]["a"]),
                      (out["m"], tree["m"])):
        assert got.dtype == want.dtype and torch.equal(got, want)


# ---------------------------------------------------------------------------
# GP.save / GP.load
# ---------------------------------------------------------------------------


def _session(expansion, store_train, *, backend="pallas", N=60, seed=1):
    X, y = gp_data(N, 2, seed)
    _, ts = specs(expansion, 2, n=5, num_features=12, backend=backend)
    return GP.fit(tt(X), tt(y), ts.replace(store_train=store_train))


@pytest.mark.parametrize("store_train", [False, True])
@pytest.mark.parametrize("expansion", EXPANSIONS)
def test_round_trip_is_bit_exact(tmp_path, expansion, store_train):
    gp = _session(expansion, store_train)
    assert gp.save(tmp_path) == 0
    re = GP.load(tmp_path, device="cpu")
    _assert_same_session(re, gp, train=store_train)
    assert (re.state.Phi is None) == (not store_train)
    assert re.spec.device == torch.device("cpu") and re.state.chol.device.type == "cpu"
    Xs = tt(uniform(np.random.default_rng(2), (13, 2)))
    for a, b in zip(re.mean_var(Xs), gp.mean_var(Xs)):
        assert torch.equal(a, b)
    if store_train:
        for a, b in zip(re.predict(Xs, mode="paper"), gp.predict(Xs, mode="paper")):
            assert torch.equal(a, b)
    # the reloaded session keeps serving and ingesting like the original
    Xn, yn = gp_data(3, 2, 9)
    assert torch.equal(re.update(tt(Xn), tt(yn)).state.u, gp.update(tt(Xn), tt(yn)).state.u)


def test_versions_accumulate_and_are_addressable(tmp_path):
    gp0 = _session("hermite", True)
    Xn, yn = gp_data(4, 2, 5)
    gp1 = gp0.update(tt(Xn), tt(yn))
    assert gp0.save(tmp_path) == 0
    assert gp1.save(tmp_path) == 1
    assert gp0.save(tmp_path, step=7) == 7
    assert gpstate.latest_version(tmp_path) == 7
    _assert_same_session(GP.load(tmp_path, step=1, device="cpu"), gp1, train=True)
    _assert_same_session(GP.load(tmp_path, step=0, device="cpu"), gp0, train=True)
    assert GP.load(tmp_path, device="cpu").state.Phi.shape[0] == 60
    assert GP.load(tmp_path, step=1, device="cpu").state.Phi.shape[0] == 64
    with pytest.raises(FileNotFoundError, match="version 3"):
        GP.load(tmp_path, step=3, device="cpu")
    with pytest.raises(FileNotFoundError):
        GP.load(tmp_path / "empty", device="cpu")


def test_wrong_spec_restore_raises(tmp_path):
    gp = _session("rff_se", False)
    gp.save(tmp_path)
    _, ts = specs("rff_se", 2, num_features=12, backend="pallas")
    same = GP.load(tmp_path, spec=ts)                 # device from the spec
    assert same.spec.device == ts.device
    _, other_seed = specs("rff_se", 2, num_features=12, seed=4)
    with pytest.raises(ValueError, match="omega"):
        GP.load(tmp_path, spec=other_seed)
    _, hermite = specs("hermite", 2, n=5)
    with pytest.raises(ValueError, match="expansion="):
        GP.load(tmp_path, spec=hermite)
    with pytest.raises(ValueError, match="hyperparameter noise"):
        GP.load(tmp_path, spec=ts.replace(noise=torch.tensor(0.2)))
    (tmp_path / "step_0000000000" / "manifest.json").write_text(
        json.dumps({"step": 0, "dtypes": {}, "metadata": {"format": "other"}}))
    with pytest.raises(ValueError, match="not a repro.gpstate checkpoint"):
        GP.load(tmp_path, device="cpu")


@pytest.mark.parametrize("load", [
    GP.load,
    lambda d: store.restore(d, {"leaves": {"u": 0}}),
], ids=["GP.load", "store.restore"])
def test_load_defaults_to_the_card(tmp_path, load):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    _session("hermite", False).save(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        load(tmp_path)


# ---------------------------------------------------------------------------
# Cross-loading with the JAX package
# ---------------------------------------------------------------------------


def _pair(expansion, store_train, N=60):
    X, y = gp_data(N, 2, 3)
    js, ts = specs(expansion, 2, n=5, num_features=12, backend="jnp")
    js, ts = js.replace(store_train=store_train), ts.replace(store_train=store_train)
    return JGP.fit(jnp.asarray(X), jnp.asarray(y), js), GP.fit(tt(X), tt(y), ts)


@pytest.mark.parametrize("expansion,store_train",
                         [("hermite", True), ("rff_se", False), ("rff_matern52", True)])
def test_jax_checkpoint_loads_in_the_port(tmp_path, expansion, store_train):
    jg, _ = _pair(expansion, store_train)
    jg.save(tmp_path)
    gp = GP.load(tmp_path, device="cpu")
    _assert_same_session(gp, jg, train=store_train)
    # the JAX checkpoint restores into a port spec of the same structure
    _, ts = specs(expansion, 2, n=5, num_features=12)
    GP.load(tmp_path, spec=ts.replace(store_train=store_train))


def test_jax_checkpoint_with_extra_arrays_loads_in_the_port(tmp_path):
    """The JAX package may store extra arrays beside a session; the port
    restores the session and leaves them unread."""
    jg, _ = _pair("hermite", True)
    jgpstate.save_state(tmp_path, jg.state, extra={"window": jnp.arange(6.0)})
    _assert_same_session(GP.load(tmp_path, device="cpu"), jg, train=True)


@pytest.mark.parametrize("expansion,store_train",
                         [("hermite", False), ("rff_se", True), ("rff_matern52", False)])
def test_port_checkpoint_loads_in_jax(tmp_path, expansion, store_train):
    _, gp = _pair(expansion, store_train)
    gp.save(tmp_path)
    jg = JGP.load(tmp_path)
    _assert_same_session(jg, gp, train=store_train)
    if store_train:
        Xs = uniform(np.random.default_rng(1), (7, 2))
        np.testing.assert_allclose(nn(jg.predict(jnp.asarray(Xs), mode="paper")[0]),
                                   nn(gp.predict(tt(Xs), mode="paper")[0]), atol=5e-3)


def test_manifests_and_omega_hash_agree_with_jax():
    jg, gp = _pair("rff_se", True)
    assert gpstate.FORMAT == jgpstate.FORMAT and gpstate.FORMAT_VERSION == jgpstate.FORMAT_VERSION
    assert gpstate.omega_hash(gp.spec.omega) == jgpstate.omega_hash(jg.spec.omega)
    assert gpstate.spec_manifest(gp.spec) == jgpstate.spec_manifest(jg.spec)
    jh, th = _pair("hermite", False)
    assert gpstate.omega_hash(th.spec.omega) is None
    assert gpstate.spec_manifest(th.spec) == jgpstate.spec_manifest(jh.spec)


def test_old_style_jax_manifest_loads_as_fagp(tmp_path):
    """A manifest from before the approximation protocol (no
    approximation/kernel/neighbors keys) loads as an fagp session
    (tests/test_gp_api.py:316)."""
    jg, _ = _pair("hermite", False)
    jg.save(tmp_path)
    mf = tmp_path / "step_0000000000" / "manifest.json"
    m = json.loads(mf.read_text())
    for k in ("approximation", "kernel", "neighbors"):
        m["metadata"]["spec"].pop(k, None)
    mf.write_text(json.dumps(m))
    gp = GP.load(tmp_path, device="cpu")
    assert gp.spec.approximation == "fagp"
    _assert_same_session(gp, jg, train=False)
    _, ts = specs("hermite", 2, n=5)
    GP.load(tmp_path, spec=ts)


def test_vecchia_checkpoint_is_refused(tmp_path):
    """A Vecchia checkpoint of the JAX package, refused until the family
    was ported (ROADMAP A6), now loads as a working session: its leaves
    (X, y) and spec bitwise, no ``train`` sidecar.  The cross-loads both
    ways are in tests/test_torch_vecchia.py."""
    X, y = gp_data(40, 2, 1)
    jg = JGP.fit(jnp.asarray(X), jnp.asarray(y),
                 JSpec.create_vecchia([0.8, 0.8], 0.05, neighbors=8))
    jg.save(tmp_path)
    gp = GP.load(tmp_path, device="cpu")
    assert type(gp.state).__name__ == "VecchiaState"
    for f in ("X", "y"):
        assert _same(getattr(gp.state, f), getattr(jg.state, f)), f
    for f in SPEC_LEAVES:
        assert _same(getattr(gp.spec, f), getattr(jg.spec, f)), f
    for f in ("approximation", "kernel", "neighbors", "block_rows", "backend"):
        assert getattr(gp.spec, f) == getattr(jg.spec, f), f
    manifest = json.loads((tmp_path / "step_0000000000" / "manifest.json").read_text())
    assert not manifest["metadata"]["has_train"]
    assert gpstate.spec_manifest(gp.spec) == jgpstate.spec_manifest(jg.spec)
    mu, var = gp.mean_var(tt(X[:5]))
    assert torch.isfinite(mu).all() and torch.isfinite(var).all()
