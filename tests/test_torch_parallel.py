"""The port's ``parallel/`` against the JAX package's on the CPU: the
sharding rules of ``parallel/sharding.py`` entry for entry (every
architecture x serving in {False, True} x the meshes 16 x 16, 2 x 16 x 16
and 4 x 2 on the full configs' shapes, both reference switches; the
port's per-layer leaves on the SMOKE models), ``batch_shardings`` and
``cache_shardings`` on the SMOKE caches, the specs ``hints.constrain``
resolves, ``quantize`` / ``dequantize`` and the compressed all-reduce bit
for bit, and ``gpipe`` against the stages run in sequence (bitwise) and
against JAX's ``gpipe`` (one subprocess with eight host devices, as
``tests/test_distributed.py`` runs it) at the reference test's gates
(forward 2e-5, gradients 1e-4 / 1e-5).  Meshes here are the duck-typed
mesh of ``tests/test_sharding_rules.py`` (no devices) on the rules' side
and ``make_local_mesh(devices=["cpu"] * 8)`` where pieces are placed.
"""
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.parallel import compress as jcompress  # noqa: E402
from repro.parallel import hints as jhints  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.parallel import compress, hints, sharding  # noqa: E402
from repro_torch.parallel.pipeline import gpipe  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2}}


class _FakeMesh:
    """Duck-typed mesh (tests/test_sharding_rules.py:16-21): the rules
    read only ``.shape`` and the axis names."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _abstract(shape):
    return AbstractMesh(tuple(shape.values()), tuple(shape))


@functools.lru_cache(maxsize=None)
def _full_shapes(arch):
    """The reference's full-config parameter tree, shapes only."""
    cfg = JARCHS[arch].CONFIG
    model = jget_model(cfg)
    return jax.eval_shape(lambda: model.init_params(jax.random.key(0)))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flat(tree[k], prefix + (str(k),))
        return out
    return [(prefix, tree)]


def _ref_flat_specs(specs):
    return _flat(jax.tree.map(lambda s: s, specs, is_leaf=lambda x: isinstance(x, JP)))


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("serving", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_reference(arch, serving, mesh_name):
    """Entry for entry on the full config's shapes."""
    shapes = _full_shapes(arch)
    mesh = _FakeMesh(MESHES[mesh_name])
    want = _ref_flat_specs(jsharding.param_specs(shapes, JARCHS[arch].CONFIG, mesh,
                                                 serving=serving))
    got = _flat(sharding.param_specs(shapes, ARCHS[arch].CONFIG, mesh, serving=serving))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert isinstance(g, sharding.PartitionSpec)
        assert tuple(g) == tuple(w), (arch, path, g, w)
    assert any(any(a is not None for a in g) for _, g in got)


@pytest.mark.parametrize("switch", ["REPRO_SSM_TP", "REPRO_SSM_ZERO_FULL"])
@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-130m"])
def test_ssm_switches_equal_the_reference(arch, switch, monkeypatch):
    monkeypatch.setenv(switch, "1")
    for mesh_name in ("16x16", "4x2"):
        mesh = _FakeMesh(MESHES[mesh_name])
        cfg_j, cfg_t = JARCHS[arch].CONFIG, ARCHS[arch].CONFIG
        want = _ref_flat_specs(jsharding.param_specs(_full_shapes(arch), cfg_j, mesh))
        got = _flat(sharding.param_specs(_full_shapes(arch), cfg_t, mesh))
        assert [tuple(g) for _, g in got] == [tuple(w) for _, w in want], mesh_name
    # the switch moves something on the full mesh where it applies
    monkeypatch.delenv(switch)
    mesh = _FakeMesh(MESHES["16x16"])
    off = _flat(sharding.param_specs(_full_shapes(arch), ARCHS[arch].CONFIG, mesh))
    monkeypatch.setenv(switch, "1")
    on = _flat(sharding.param_specs(_full_shapes(arch), ARCHS[arch].CONFIG, mesh))
    moved = any(a != b for (_, a), (_, b) in zip(off, on))
    assert moved == (switch == "REPRO_SSM_ZERO_FULL" or arch == "zamba2-7b")


@pytest.mark.parametrize("mesh_name", ["4x2", "16x16"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_leaf_specs_are_the_references_per_layer(arch, mesh_name):
    """On the port's SMOKE model (one tensor a layer), each leaf's spec is
    the reference's for its stacked leaf without the stacked axes."""
    cfg = ARCHS[arch].SMOKE
    params = get_model(cfg).init_params(0, device="cpu")
    mesh = _FakeMesh(MESHES[mesh_name])
    jshapes = jax.eval_shape(lambda: jget_model(JARCHS[arch].SMOKE).init_params(
        jax.random.key(0)))
    want = dict(_ref_flat_specs(jsharding.param_specs(jshapes, JARCHS[arch].SMOKE, mesh)))
    got = sharding.param_specs(params, cfg, mesh)
    assert list(got) == list(tlm.leaves(params))
    for name, path, layer in tlm.leaf_paths(params):
        lead = 0 if layer is None else len(np.atleast_1d(layer))
        w = tuple(want[path])
        assert w[:lead] == (None,) * lead
        assert tuple(got[name]) == w[lead:], (name, got[name], w)


def test_opt_state_and_tree_shardings():
    cfg = ARCHS["qwen2-1.5b"].SMOKE
    params = get_model(cfg).init_params(0, device="cpu")
    mesh = make_local_mesh(4, 2, devices=CPU8)
    from repro_torch import optim

    opt = optim.init(tlm.leaves(params), optim.AdamWConfig())
    o_sh = sharding.opt_state_shardings(opt, params, cfg, mesh)
    p_sh = sharding.param_shardings(params, cfg, mesh)
    assert set(o_sh["mu"]) == set(p_sh) and tuple(o_sh["step"].spec) == ()
    for k, sh in p_sh.items():
        assert o_sh["mu"][k]["m"].spec == sh.spec == o_sh["mu"][k]["v"].spec
    t = sharding.tree_shardings({"a": 0, "b": {"c": 0}}, mesh)
    assert tuple(t["b"]["c"].spec) == ()


def _ref_specs_of(tree):
    return {p: tuple(s.spec) for p, s in _flat(tree)}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_and_batch_shardings_equal_the_reference(arch, mesh_name):
    """On the SMOKE caches (batch 32, context 32) and a batch of 32 rows."""
    B, S = 32, 32
    shape = MESHES[mesh_name]
    cache_t = get_model(ARCHS[arch].SMOKE).init_cache(B, S, device="cpu")
    cache_j = jax.eval_shape(lambda: jget_model(JARCHS[arch].SMOKE).init_cache(B, S))
    got = _ref_specs_of(sharding.cache_shardings(cache_t, ARCHS[arch].SMOKE,
                                                 _FakeMesh(shape)))
    want = _ref_specs_of(jsharding.cache_shardings(cache_j, JARCHS[arch].SMOKE,
                                                   _abstract(shape)))
    assert got == want
    batch = {"tokens": np.zeros((B, 16), np.int32), "pos": np.zeros((), np.int32),
             "odd": np.zeros((3, 4), np.float32)}
    got = _ref_specs_of(sharding.batch_shardings(batch, _FakeMesh(shape)))
    want = _ref_specs_of(jsharding.batch_shardings(batch, _abstract(shape)))
    assert got == want


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def test_partition_spec_is_a_tuple_with_jax_equality():
    P = sharding.PartitionSpec
    assert P("data", None) == ("data", None) and P("data") != P("data", None)
    assert P(("pod", "data")) == JP(("pod", "data")) and hash(P("a")) == hash(("a",))
    assert repr(P(None, "model")) == "PartitionSpec(None, 'model')"


@pytest.mark.parametrize("spec", [(), ("data",), (None, "model"), ("model", "data"),
                                  (("data", "model"),), (None, ("model", "data"))])
def test_shard_and_gather_round_trip(spec):
    mesh = make_local_mesh(4, 2, devices=CPU8)
    t = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    sh = sharding.NamedSharding(mesh, sharding.PartitionSpec(*spec))
    pieces = sh.shard(t)
    assert pieces.shape == (4, 2)
    parts = sh.parts(2)
    for cell in np.ndindex(4, 2):
        b = sh.bounds(cell, t.shape)
        assert torch.equal(pieces[cell], t[b[0][0]:b[0][1], b[1][0]:b[1][1]])
        assert pieces[cell].shape == (8 // parts[0], 16 // parts[1])
    # cells holding one slice on one device share a tensor; none aliases t
    assert len({id(p) for p in pieces.flat}) == int(np.prod(parts))
    assert all(p.data_ptr() != t.data_ptr() for p in pieces.flat)
    assert torch.equal(sh.gather(pieces, "cpu"), t)
    placed = sharding.Sharded(t, sh)
    placed.assign_(t * 2)
    assert torch.equal(placed.gather("cpu"), t * 2)


def test_shard_refuses_what_does_not_divide():
    mesh = make_local_mesh(4, 2, devices=CPU8)
    with pytest.raises(ValueError, match="does not divide"):
        sharding.NamedSharding(mesh, sharding.PartitionSpec("data")).shard(torch.zeros(6))
    with pytest.raises(ValueError, match="not an axis"):
        sharding.NamedSharding(mesh, sharding.PartitionSpec("pod"))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "whisper-small"])
def test_placed_model_materializes_bitwise(arch):
    cfg = ARCHS[arch].SMOKE
    params = get_model(cfg).init_params(0, device="cpu")
    mesh = make_local_mesh(2, 2, devices=["cpu"] * 4)
    placed = sharding.place(params, sharding.param_shardings(params, cfg, mesh))
    assert isinstance(placed, sharding.ShardedParams) and placed.cfg == cfg
    assert all(p.device.type == "meta" for p in placed.skeleton.parameters())
    full = placed.materialize("cpu")
    for (k, a), b in zip(tlm.leaves(params).items(), tlm.leaves(full).values()):
        assert torch.equal(a, b) and not b.requires_grad, k
    if cfg.family == "moe":
        kept = placed.materialize("cpu", keep=lambda n: n.endswith("moe.wg"))
        moe0 = kept.blocks[0]["moe"]
        assert isinstance(moe0, dict) and isinstance(moe0["wg"], sharding.Sharded)
        assert torch.equal(moe0["wu"], params.blocks[0].moe.wu)


def test_production_mesh_shapes_and_count():
    """(16, 16) over (data, model), (2, 16, 16) with a pod axis, built
    through the grid that names the count it wants; devices may repeat."""
    m = make_production_mesh(devices=["cpu"] * 256)
    assert m.shape == {"data": 16, "model": 16} and m.devices.shape == (16, 16)
    m2 = make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert m2.axis_names == ("pod", "data", "model") and m2.size == 512
    with pytest.raises(ValueError, match="wants 512 devices; only 256 devices given"):
        make_production_mesh(multi_pod=True, devices=["cpu"] * 256)


# ---------------------------------------------------------------------------
# hints
# ---------------------------------------------------------------------------


HINT_CASES = [((8, 64, 32), ("dp", "model", None)), ((8, 64, 32), ("dp", None, None)),
              ((6, 64, 32), ("dp", "model", None)), ((8, 3, 1, 16), ("dp", None, None, None)),
              ((8, 4, 1, 64), ("dp", None, None, "model")), ((64, 48), ("dpm", None)),
              ((8, 32, 24), ("dp", None, "model")), ((2, 1, 8), ("dp", "model", None))]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_constrain_resolves_the_references_spec(mesh_name, monkeypatch):
    shape = MESHES[mesh_name]
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(tuple(s.spec)) or x)
    for dims, logical in HINT_CASES:
        with jhints.activate(_abstract(shape)):
            jhints.constrain(np.zeros(dims, np.float32), logical)
        mesh = _FakeMesh(shape)
        got = hints.constrained_spec(mesh, dims, logical)
        assert tuple(got) == seen[-1], (dims, logical)
        x = torch.zeros(dims)
        with hints.activate(mesh):
            assert hints.constrain(x, logical) is x       # no copy, no other value
    assert hints.active_mesh() is None


def test_scopes_nest_and_restore():
    mesh = _FakeMesh(MESHES["4x2"])
    assert not hints.sp_enabled() and hints.active_mesh() is None
    with hints.activate(mesh), hints.sp_scope(True):
        assert hints.sp_enabled() and hints.active_mesh() is mesh
        with hints.sp_scope(False), hints.activate(None):
            assert not hints.sp_enabled() and hints.active_mesh() is None
        assert hints.dp_axes(mesh) == ("data",) and hints.resolve(mesh, "dp") == ("data",)
    assert hints.resolve(_FakeMesh(MESHES["2x16x16"]), "dpm") == ("pod", "data", "model")
    assert not hints.sp_enabled() and hints.active_mesh() is None


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,scale,seed", [(1000, 1.0, 0), (256, 1e-3, 1), (7, 1e3, 2),
                                          (64 * 33, 1e-4, 3), (513, 10.0, 4)])
def test_quantize_is_bitwise_the_references(n, scale, seed):
    x = (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)
    x[::17] = 0.0
    q, s = compress.quantize(torch.from_numpy(x))
    jq, js = jcompress.quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    deq = compress.dequantize(q, s, (n,))
    assert np.array_equal(deq.numpy(), np.asarray(jcompress.dequantize(jq, js, (n,))))
    # the reference test's bound: per block |error| <= blockmax / 127 * 0.51
    pad = (-n) % compress.BLOCK
    blocks = np.pad(x, (0, pad)).reshape(-1, compress.BLOCK)
    err = np.pad(x - deq.numpy(), (0, pad)).reshape(-1, compress.BLOCK)
    assert np.all(np.abs(err) <= np.abs(blocks).max(1, keepdims=True) / 127.0 * 0.51 + 1e-9)


def test_quantize_zero_is_exact():
    q, s = compress.quantize(torch.zeros(64))
    assert float(compress.dequantize(q, s, (64,)).abs().max()) == 0.0


def test_compressed_allreduce_is_the_mean_of_dequantized_members():
    """Two members along 'data': every member gets (deq_0 + deq_1) / 2 of
    the reference's quantization, bitwise equal across members; each keeps
    v - deq; a second round carries the residual in."""
    mesh = make_local_mesh(2, 2, devices=["cpu"] * 4)
    rng = np.random.default_rng(0)
    g = [{"w": rng.standard_normal((40, 33)).astype(np.float32),
          "b": {"c": (rng.standard_normal(300) * 1e-3).astype(np.float32)}} for _ in range(2)]
    tg = [{"w": torch.from_numpy(m["w"]), "b": {"c": torch.from_numpy(m["b"]["c"])}}
          for m in g]
    states = [compress.CompressionState.init(t) for t in tg]
    res = [{"w": np.zeros((40, 33), np.float32), "b": {"c": np.zeros(300, np.float32)}}
           for _ in range(2)]
    for _ in range(2):
        out, states = compress.compress_allreduce(tg, states, mesh, axis="data")
        for path in (("w",), ("b", "c")):
            def at(tree):
                for k in path:
                    tree = tree[k]
                return tree
            deq = []
            for i in range(2):
                v = jnp.asarray(at(g[i])) + jnp.asarray(at(res[i]))
                jq, js = jcompress.quantize(v)
                d = jcompress.dequantize(jq, js, v.shape)
                deq.append(d)
                r = at(res[i])
                r[...] = np.asarray(v - d)
                assert np.array_equal(at(states[i].residual).numpy(), r)
            want = np.asarray((deq[0] + deq[1]) / 2)
            assert np.array_equal(at(out[0]).numpy(), want)
            assert torch.equal(at(out[0]), at(out[1]))
    with pytest.raises(ValueError, match="2 members"):
        compress.compress_allreduce(tg[:1], states[:1], mesh, axis="data")


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


S_, M_, MB, D = 4, 8, 4, 32


def _pipe_data():
    rng = np.random.default_rng(0)
    W = (rng.standard_normal((S_, D, D)) / np.sqrt(D)).astype(np.float32)
    b = (rng.standard_normal((S_, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((M_, MB, D)).astype(np.float32)
    return W, b, x


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


@pytest.fixture(scope="module")
def jax_gpipe(tmp_path_factory):
    """JAX's gpipe (forward, and the gradient of sum(y^2) in W and b) on
    the same data over a (2, 4) mesh of eight host devices, in one
    subprocess (the device count is fixed at jax's first start)."""
    out = tmp_path_factory.mktemp("gpipe") / "jax.npz"
    body = f"""
        import numpy as np, jax, jax.numpy as jnp
        from repro.parallel.pipeline import gpipe
        from repro.launch.mesh import make_local_mesh
        S, M, mb, d = {S_}, {M_}, {MB}, {D}
        rng = np.random.default_rng(0)
        W = jnp.asarray((rng.standard_normal((S, d, d)) / np.sqrt(d)).astype(np.float32))
        b = jnp.asarray((rng.standard_normal((S, d)) * 0.1).astype(np.float32))
        x = jnp.asarray(rng.standard_normal((M, mb, d)).astype(np.float32))
        stage = lambda p, x: jnp.tanh(x @ p["w"] + p["b"])
        mesh = make_local_mesh(data=2, model=4)
        with jax.set_mesh(mesh):
            y = gpipe(stage, {{"w": W, "b": b}}, x, mesh, axis="model")
            gw, gb = jax.grad(lambda W, b: jnp.sum(
                gpipe(stage, {{"w": W, "b": b}}, x, mesh, axis="model") ** 2), (0, 1))(W, b)
        np.savez({str(out)!r}, y=np.asarray(y), gw=np.asarray(gw), gb=np.asarray(gb))
    """
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(body)], capture_output=True,
                       text=True, timeout=420, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(out))


def _pipe_run(pipelined: bool):
    W, b, x = _pipe_data()
    tw = torch.from_numpy(W).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    xt = torch.from_numpy(x)
    if pipelined:
        mesh = make_local_mesh(2, 4, devices=CPU8)
        y = gpipe(_stage, {"w": tw, "b": tb}, xt, mesh, axis="model")
    else:
        ys = []
        for m in range(M_):
            h = xt[m]
            for s in range(S_):
                h = _stage({"w": tw[s], "b": tb[s]}, h)
            ys.append(h)
        y = torch.stack(ys)
    gw, gb = torch.autograd.grad(torch.sum(y ** 2), (tw, tb))
    return y.detach(), gw, gb


def test_gpipe_equals_the_stages_in_sequence_bitwise():
    y, gw, gb = _pipe_run(True)
    y0, gw0, gb0 = _pipe_run(False)
    assert y.shape == (M_, MB, D)
    assert torch.equal(y, y0) and torch.equal(gw, gw0) and torch.equal(gb, gb0)


def test_gpipe_matches_jax_gpipe(jax_gpipe):
    y, gw, gb = _pipe_run(True)
    np.testing.assert_allclose(y.numpy(), jax_gpipe["y"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(gw.numpy(), jax_gpipe["gw"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gb.numpy(), jax_gpipe["gb"], rtol=1e-4, atol=1e-5)


def test_gpipe_schedule_hands_off_to_each_stages_device():
    """Stage s runs on the device of cell s along the axis; a list of
    per-stage parameters works as the stacked form does."""
    W, b, x = _pipe_data()
    calls = []

    def stage(p, h):
        calls.append(p["i"])
        return torch.tanh(h @ p["w"] + p["b"])

    mesh = make_local_mesh(1, 4, devices=["cpu"] * 4)
    params = [{"w": torch.from_numpy(W[s]), "b": torch.from_numpy(b[s]), "i": s}
              for s in range(S_)]
    y = gpipe(stage, params, torch.from_numpy(x), mesh, axis="model")
    assert len(calls) == S_ * M_
    # step t runs stages 0..S-1 on microbatch t - s where it exists
    want = [s for t in range(M_ + S_ - 1) for s in range(S_) if 0 <= t - s < M_]
    assert calls == want and torch.equal(y, _pipe_run(True)[0])
