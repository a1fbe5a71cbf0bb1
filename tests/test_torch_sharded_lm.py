"""The LM half's sharded paths on the port's single controller: the cases of
``tests/test_distributed.py`` (its train-step, decode, serve-mode MoE and
elastic-resume classes) on the port's meshes, ``make_local_mesh(devices=
["cpu"] * 8)``, at that file's gates, plus what the single controller
adds:

* the sharded train step (``build(mesh=)``'s step: each dp cell gathers
  the leaves, runs its rows, the gradients summed into the pieces in cell
  order, AdamW a piece at a time) against the unsharded one on the SMOKE
  models of smollm-360m, olmoe-1b-7b and mamba2-130m (loss within 5e-2,
  every leaf rtol 5e-2 / atol 5e-3), and in float32 at 1e-5;
* the decode step with a cache placed by ``cache_shardings`` (2e-2), and
  the sharded prefill's cache;
* ``moe_apply_sharded`` in serve mode against ``moe_apply`` (2e-5); where
  the split changes which tokens a capacity keeps (capacity factor 1.0,
  both branches), against JAX's own ``moe_apply_sharded`` run in one
  subprocess with eight host devices (2e-5), and on a pod mesh against
  the dp shards routed apart;
* elastic resume: 10 unsharded steps checkpointed, resumed to 20 on a
  (4, 2) mesh through ``train_loop(shardings=)``;
* the sequence-parallel pins change no value: forward, loss and the
  absorbed MLA decode under an active mesh are bitwise those without.
"""
import copy
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import checkpoint, optim  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_local_mesh  # noqa: E402
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,  # noqa: E402
                                      make_train_step)
from repro_torch.models import convert, get_model  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.parallel import hints, sharding  # noqa: E402
from repro_torch.runtime import TrainLoopConfig, train_loop  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8
QUIET = dict(log_fn=lambda s: None)


def _mesh(data=4, model=2):
    return make_local_mesh(data, model, devices=["cpu"] * (data * model))


def _setup(arch, dtype=None):
    cfg = ARCHS[arch].SMOKE
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = get_model(cfg)
    params = model.init_params(0, device="cpu")
    ocfg = optim.AdamWConfig(lr=1e-3)
    opt = optim.init(tlm.leaves(params), ocfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, size=(8, 64)))}
    return cfg, model, params, ocfg, opt, batch


def _placed(cfg, params, opt, mesh):
    p_sh = sharding.param_shardings(params, cfg, mesh)
    o_sh = sharding.opt_state_shardings(opt, params, cfg, mesh)
    return sharding.place(params, p_sh), sharding.place(opt, o_sh), (p_sh, o_sh)


def _leaves_close(a, b, rtol, atol):
    for (k, x), y in zip(tlm.leaves(a).items(), tlm.leaves(b).values()):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# tests/test_distributed.py::TestDistributedTrainStep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm-360m", "olmoe-1b-7b", "mamba2-130m"])
def test_sharded_train_step_matches_single_device(arch):
    cfg, model, params, ocfg, opt, batch = _setup(arch)
    step = make_train_step(model, ocfg)
    pd, od, _ = _placed(cfg, copy.deepcopy(params), copy.deepcopy(opt), _mesh())
    p1, o1, m1 = step(params, opt, batch)
    p2, o2, m2 = step(pd, od, batch)
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    assert abs(l1 - l2) < 5e-2 * max(1.0, abs(l1)), (l1, l2)
    assert set(m2) == set(m1) and float(m2["tokens"]) == float(m1["tokens"])
    assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) < 1e-2 * float(m1["grad_norm"])
    assert p2 is pd and int(o2["step"].gather("cpu")) == 1
    # every leaf (the reference test spot-checks the first) at its gates
    _leaves_close(p1, p2.materialize("cpu"), rtol=5e-2, atol=5e-3)


def test_sharded_train_step_float32_is_tight():
    """In float32 the sums are the only difference: the loss, the grad
    norm, every leaf and AdamW's moments within 1e-5 of the unsharded
    step's, over two steps."""
    cfg, model, params, ocfg, opt, batch = _setup("smollm-360m", "float32")
    step = make_train_step(model, ocfg)
    pd, od, _ = _placed(cfg, copy.deepcopy(params), copy.deepcopy(opt), _mesh())
    for _ in range(2):
        _, _, m1 = step(params, opt, batch)
        _, _, m2 = step(pd, od, batch)
        assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
        assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) < 1e-5
    _leaves_close(params, pd.materialize("cpu"), rtol=1e-5, atol=1e-5)
    mu = sharding.gather_tree(od, "cpu")["mu"]
    for k, s in opt["mu"].items():
        np.testing.assert_allclose(mu[k]["v"].numpy(), s["v"].numpy(), rtol=1e-4,
                                   atol=1e-10, err_msg=k)


def test_build_with_a_mesh_places_the_state():
    mesh = _mesh(2, 2)
    cfg, model, params, opt, step, stream, extras, (p_sh, o_sh) = ttrain.build(
        "olmoe-1b-7b", smoke=True, batch=4, seq=16, lr=1e-3, mesh=mesh, device="cpu")
    assert isinstance(params, sharding.ShardedParams) and params.mesh is mesh
    assert set(p_sh) == set(params.leaves) and set(o_sh) == {"mu", "step"}
    assert tuple(params.leaves["blocks.0.moe.wg"].spec) == ("model", None, None)
    assert all(isinstance(v["m"], sharding.Sharded) for v in opt["mu"].values())
    before = params.leaves["tok_emb"].gather("cpu")
    _, _, m = step(params, opt, stream.batch(0, extras, device="cpu"))
    assert torch.isfinite(m["loss"]) and float(m["aux"]) > 0
    assert not torch.equal(before, params.leaves["tok_emb"].gather("cpu"))


# ---------------------------------------------------------------------------
# tests/test_distributed.py::TestDistributedTrainStep::test_decode_step_sharded_cache
# ---------------------------------------------------------------------------


def test_decode_step_sharded_cache():
    cfg = ARCHS["qwen2-1.5b"].SMOKE
    model = get_model(cfg)
    params = model.init_params(0, device="cpu")
    B, S = 8, 32
    cache = model.init_cache(B, S, device="cpu")
    batch = {"token": torch.zeros((B, 1), dtype=torch.int32), "pos": 3}
    ref, ref_cache = model.decode_step(params, batch, {k: v.clone() for k, v in cache.items()})
    mesh = _mesh()
    pd = sharding.place(params, sharding.param_shardings(params, cfg, mesh))
    c_sh = sharding.cache_shardings(cache, cfg, mesh)
    cd = sharding.place(cache, c_sh)
    out, cd2 = make_decode_step(model)(pd, batch, cd)
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(), rtol=2e-2, atol=2e-2)
    assert cd2 is cd and all(tuple(cd[k].spec) == tuple(c_sh[k].spec) for k in cd)
    for k in ref_cache:
        assert torch.equal(cd[k].gather("cpu"), ref_cache[k]), k
    # the cache's pieces hold the batch over 'data' and the kv heads over 'model'
    assert tuple(c_sh["k"].spec) == (None, "data", None, "model", None)
    assert cd["k"].piece((1, 1)).shape == (cfg.n_layers, B // 4, S, cfg.n_kv_heads // 2,
                                           cfg.head_dim)


def test_sharded_prefill_places_its_cache():
    """olmoe under a (2, 2) mesh: the prefill (the gather-at-use branch of
    the MoE layers) and four decode steps (serve mode) against the
    unsharded ones; nothing drops at SMOKE's capacity factor."""
    cfg = ARCHS["olmoe-1b-7b"].SMOKE
    model = get_model(cfg)
    params = model.init_params(0, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, size=(4, 48)))
    mesh = _mesh(2, 2)
    pd = sharding.place(params, sharding.param_shardings(params, cfg, mesh, serving=True))
    with torch.no_grad():
        lg, c = model.prefill(params, {"tokens": tok}, cache_len=52)
        lg_s, c_s = make_prefill_step(model, cache_len=52)(pd, {"tokens": tok})
        assert all(isinstance(v, sharding.Sharded) for v in c_s.values())
        np.testing.assert_allclose(lg_s.float().numpy(), lg.float().numpy(), rtol=2e-2,
                                   atol=2e-2)
        for i in range(4):
            t = torch.argmax(lg, -1)[:, None]
            lg, c = model.decode_step(params, {"token": t, "pos": 48 + i}, c)
            lg_s, c_s = make_decode_step(model)(pd, {"token": t, "pos": 48 + i}, c_s)
            np.testing.assert_allclose(lg_s.float().numpy(), lg.float().numpy(), rtol=2e-2,
                                       atol=2e-2)
    for k in c:
        np.testing.assert_allclose(c_s[k].gather("cpu").float().numpy(), c[k].float().numpy(),
                                   rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# tests/test_distributed.py::TestServeModeMoE, and the capacity-bound branches
# ---------------------------------------------------------------------------


def _moe_cfg(cf=8.0):
    return ModelConfig(arch_id="t", family="moe", n_layers=1, d_model=64, n_heads=4,
                       n_kv_heads=4, d_ff=32, vocab=64, n_experts=8, top_k=2, d_expert=32,
                       n_shared_experts=1, capacity_factor=cf, fsdp=True)


def test_serve_mode_matches_dense():
    """Tiny T (decode): sharded weights and token slicing equal the dense
    path (modulo float32 reduction order)."""
    cfg = _moe_cfg()
    p = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 64)).astype(np.float32))
    y_ref, aux_ref = tmoe.moe_apply(p, x, cfg)
    with hints.activate(_mesh(2, 4)):
        assert (16 // 2 * 2 * cfg.top_k) // cfg.n_experts <= 64      # serve mode on
        y, aux = tmoe.moe_apply_sharded(p, x, cfg)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-6)


# (mesh shape, T): serve mode on a (pod, data, model) mesh, where a pod's
# gathered tokens are half of them ((T_g k) // E = 8); the gather branch on
# (data, model) ((T_g k) // E = 256)
MOE_CASES = {"serve": ((2, 2, 2), 64), "gather": ((2, 4), 1024)}


def _case_mesh(shape):
    names = ("pod", "data", "model")[-len(shape):]
    grid = np.empty(int(np.prod(shape)), dtype=object)
    grid[:] = [torch.device("cpu")] * grid.size
    return Mesh(grid.reshape(shape), names)


@pytest.fixture(scope="module")
def jax_moe(tmp_path_factory):
    """JAX's moe_apply_sharded at capacity factor 1.0 (drops) on meshes of
    eight host devices, both branches, and its weights."""
    out = tmp_path_factory.mktemp("moe") / "jax.npz"
    body = f"""
        import numpy as np, jax, jax.numpy as jnp
        from repro.models import moe as M
        from repro.models.config import ModelConfig
        from repro.parallel import hints
        cfg = ModelConfig(arch_id="t", family="moe", n_layers=1, d_model=64, n_heads=4,
                          n_kv_heads=4, d_ff=32, vocab=64, n_experts=8, top_k=2, d_expert=32,
                          n_shared_experts=1, capacity_factor=1.0, fsdp=True)
        p = M.moe_init(jax.random.key(0), cfg, jnp.float32)
        res = {{"p_" + k: np.asarray(v) for k, v in p.items()}}
        auto = jax.sharding.AxisType.Auto
        for name, (shape, T) in {MOE_CASES!r}.items():
            names = ("pod", "data", "model")[-len(shape):]
            mesh = jax.make_mesh(shape, names, axis_types=(auto,) * len(shape))
            x = jnp.asarray(np.random.default_rng(T).standard_normal((T, 64)).astype(np.float32))
            with hints.activate(mesh), jax.set_mesh(mesh):
                y, aux = jax.jit(lambda p, x: M.moe_apply_sharded(p, x, cfg))(p, x)
            y0, _ = M.moe_apply(p, x, cfg)
            res[name + "_x"], res[name + "_y"] = np.asarray(x), np.asarray(y)
            res[name + "_aux"], res[name + "_dense"] = np.asarray(aux), np.asarray(y0)
        np.savez({str(out)!r}, **res)
    """
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(body)], capture_output=True,
                       text=True, timeout=420, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("branch", sorted(MOE_CASES))
def test_capacity_bound_branches_match_jax_sharded(jax_moe, branch):
    """At capacity factor 1.0 the split decides which assignments a
    capacity keeps (per dp shard, or over the pod's gathered tokens in
    serve mode): the port keeps the reference's, not the dense path's."""
    cfg = _moe_cfg(1.0)
    p = {k[2:]: torch.from_numpy(v) for k, v in jax_moe.items() if k.startswith("p_")}
    x = torch.from_numpy(jax_moe[branch + "_x"])
    with hints.activate(_case_mesh(MOE_CASES[branch][0])):
        y, aux = tmoe.moe_apply_sharded(p, x, cfg)
    np.testing.assert_allclose(y.numpy(), jax_moe[branch + "_y"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(aux), float(jax_moe[branch + "_aux"]), rtol=1e-5)
    # the split matters here: the dense path keeps other tokens
    assert np.abs(jax_moe[branch + "_y"] - jax_moe[branch + "_dense"]).max() > 1e-3


def test_pod_mesh_routes_each_dp_shard_apart():
    """On a (2, 2, 2) pod mesh in the gather branch each of the 4 dp shards
    routes its own rows at capacity(T / 4): the dense path on each slice."""
    cfg = _moe_cfg(1.0)
    p = tmoe.moe_init(torch.Generator().manual_seed(1), cfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1024, 64))
                         .astype(np.float32))
    with hints.activate(_case_mesh((2, 2, 2))):
        y, aux = tmoe.moe_apply_sharded(p, x, cfg)
    parts = [tmoe.moe_apply(p, x[r * 256:(r + 1) * 256], cfg) for r in range(4)]
    np.testing.assert_allclose(y.numpy(), torch.cat([q[0] for q in parts]).numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(aux), float(torch.stack([q[1] for q in parts]).mean()),
                               rtol=1e-6)


def test_moe_dispatch_takes_the_sharded_path_only_where_it_applies():
    cfg = _moe_cfg()
    p = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.zeros((6, 64))
    calls = []
    real = tmoe.moe_apply_sharded
    try:
        tmoe.moe_apply_sharded = lambda *a: calls.append(1) or real(*a)
        tmoe.moe_dispatch(p, x, cfg)                       # no mesh
        with hints.activate(_mesh(4, 2)):
            tmoe.moe_dispatch(p, x, cfg)                   # 6 % 4 != 0
            tmoe.moe_dispatch(p, torch.zeros((8, 64)), cfg)
        with hints.activate(make_local_mesh(1, 3, devices=["cpu"] * 3)):
            tmoe.moe_dispatch(p, x, cfg)                   # 8 % 3 != 0
    finally:
        tmoe.moe_apply_sharded = real
    assert calls == [1]
    with pytest.raises(ValueError, match="under a mesh"):
        tmoe.moe_apply_sharded(p, x, cfg)


# ---------------------------------------------------------------------------
# tests/test_distributed.py::TestElasticScaling
# ---------------------------------------------------------------------------


def _loop_run(steps, ckpt, mesh=None):
    cfg = ARCHS["smollm-360m"].SMOKE
    model = get_model(cfg)
    params = model.init_params(0, device="cpu")
    ocfg = optim.AdamWConfig(lr=1e-3)
    opt = optim.init(tlm.leaves(params), ocfg)
    stream = TokenStream(vocab=cfg.vocab, seq=32, global_batch=8, seed=0)
    sh = None
    if mesh is not None:
        params, opt, sh = _placed(cfg, params, opt, mesh)
    loop = TrainLoopConfig(steps=steps, ckpt_every=10, log_every=100, ckpt_dir=ckpt,
                           handle_signals=False, async_ckpt=False)
    return train_loop(make_train_step(model, ocfg), params, opt,
                      lambda s: stream.batch(s, device="cpu"), loop, shardings=sh, **QUIET)


def test_resume_on_bigger_mesh(tmp_path):
    """10 steps on one device, checkpointed; the same run resumed on a
    (4, 2) mesh to step 20: restored into the mesh's pieces, trained and
    checkpointed from them, within the train-step gates of 20 straight
    unsharded steps."""
    ck = str(tmp_path / "ck")
    _, _, rep1 = _loop_run(10, ck)
    assert rep1["final_step"] == 10
    p, o, rep2 = _loop_run(20, ck, mesh=_mesh())
    assert rep2["final_step"] == 20 and np.isfinite(rep2["history"][-1]["loss"])
    assert isinstance(p, sharding.ShardedParams) and int(o["step"].gather("cpu")) == 20
    straight, _, rep = _loop_run(20, None)
    assert abs(rep["history"][-1]["loss"] - rep2["history"][-1]["loss"]) < 5e-2
    _leaves_close(straight, p.materialize("cpu"), rtol=5e-2, atol=5e-3)
    # the step-20 checkpoint, written from the pieces, is the reference's tree
    fresh = get_model(ARCHS["smollm-360m"].SMOKE).init_params(1, device="cpu")
    fo = optim.init(tlm.leaves(fresh), optim.AdamWConfig())
    _, tree = checkpoint.restore(ck, convert.train_state_keys(fresh), step=20, device="cpu")
    convert.load_train_state(fresh, fo, tree)
    _leaves_close(fresh, p.materialize("cpu"), rtol=0, atol=0)


def test_restore_with_shardings_places_an_unsharded_model(tmp_path):
    """A model given unplaced with ``shardings`` comes back placed."""
    ck = str(tmp_path / "ck")
    p10, _, _ = _loop_run(10, ck)
    cfg = ARCHS["smollm-360m"].SMOKE
    model = get_model(cfg)
    params = model.init_params(5, device="cpu")
    ocfg = optim.AdamWConfig(lr=1e-3)
    opt = optim.init(tlm.leaves(params), ocfg)
    mesh = _mesh(2, 2)
    sh = (sharding.param_shardings(params, cfg, mesh),
          sharding.opt_state_shardings(opt, params, cfg, mesh))
    p, o, rep = train_loop(make_train_step(model, ocfg), params, opt, None,
                           TrainLoopConfig(steps=10, ckpt_dir=ck, handle_signals=False),
                           shardings=sh, **QUIET)
    assert rep["final_step"] == 10 and isinstance(p, sharding.ShardedParams)
    _leaves_close(p10, p.materialize("cpu"), rtol=0, atol=0)
    assert int(o["step"].gather("cpu")) == 10


# ---------------------------------------------------------------------------
# the pins change no value
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "smollm-360m", "mamba2-130m", "zamba2-7b",
                                  "whisper-small"])
def test_pins_change_no_value(arch):
    """Under an active (4, 2) mesh the loss (the sp_scope pins) and the
    prefill are bitwise those without one."""
    cfg = dataclasses.replace(ARCHS[arch].SMOKE, sp_residual=True)
    model = get_model(cfg)
    params = model.init_params(0, device="cpu")
    ttrain_extras = ttrain.build(arch, smoke=True, batch=8, seq=32, lr=1e-3,
                                 device="cpu")[6]
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, size=(8, 32)))
    batch = {"tokens": tok, **ttrain_extras}

    def run():
        with torch.no_grad():
            loss, _ = model.loss_fn(params, batch)
            logits, cache = model.prefill(params, batch, cache_len=33)
        return [loss, logits] + [cache[k] for k in sorted(cache)]

    plain = run()
    with hints.activate(_mesh()):
        meshed = run()
    assert all(torch.equal(a, b) for a, b in zip(plain, meshed))


def test_mla_decode_pins_change_no_value():
    cfg = ARCHS["deepseek-v3-671b"].SMOKE
    p = tmla.mla_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 1, cfg.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    cache = torch.zeros((8, 16, cfg.kv_lora_rank + cfg.qk_rope_dim), dtype=torch.bfloat16)
    a, c = tmla.mla_decode(p, x, cfg, cache.clone(), 3)
    with hints.activate(_mesh()), hints.sp_scope(True):
        b, d = tmla.mla_decode(p, x, cfg, cache.clone(), 3)
    assert torch.equal(a, b) and torch.equal(c, d)
