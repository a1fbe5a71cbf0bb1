"""The port's public surface against the JAX package's: ``nlml``'s
signature (``block_rows=`` and the removed ``idx`` / ``n_max`` arguments),
the signatures of ``GP.optimize`` and the lane engine, the names
``repro_torch.core`` exports, and the refusals of what is not ported yet,
each naming its current ROADMAP.md item."""
import ast
import dataclasses
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_common import gp_data, specs, tt  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core import fagp as jfagp  # noqa: E402
from repro.core import mercer as jmercer  # noqa: E402
from repro.core.gp import GP as JGP  # noqa: E402
from repro.core.gp import GPSpec as JSpec  # noqa: E402
from repro.optim import gp_hyperopt as jgh  # noqa: E402
from repro_torch.bank import BankRouter, GPBank  # noqa: E402
from repro_torch.core import distributed as t_dist  # noqa: E402
from repro_torch.core import fagp as tfagp  # noqa: E402
from repro_torch.core.approximation import UnsupportedError  # noqa: E402
from repro_torch.core.gp import GP  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import serve_gp as t_serve  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch import runtime as t_runtime  # noqa: E402
from repro_torch.obs import MetricsRegistry, Tracer, serving_watchdog  # noqa: E402
from repro_torch.optim import gp_hyperopt as tgh  # noqa: E402

ROADMAP = Path(__file__).resolve().parents[1] / "ROADMAP.md"


def _nlml_tol(want):
    # tests/test_torch_fagp.py:119 (tests/test_expansions.py:187) gate
    return 1e-2 * max(1.0, abs(want))


# ---------------------------------------------------------------------------
# nlml(X, y, spec, idx=None, n_max=None, block_rows=None, *, mask=None)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("expansion", ["hermite", "rff_se"])
@pytest.mark.parametrize("block_rows", [16, 50])
def test_nlml_block_rows_matches_jax(backend, expansion, block_rows):
    X, y = gp_data(130, 2, 4)
    js, ts = specs(expansion, 2, n=6, num_features=24, backend=backend)
    want = float(jfagp.nlml(jnp.asarray(X), jnp.asarray(y), js, block_rows=block_rows))
    got = float(tfagp.nlml(tt(X), tt(y), ts, block_rows=block_rows))
    assert abs(got - want) < _nlml_tol(want)
    # block_rows overrides the spec's block size, exactly
    same = float(tfagp.nlml(tt(X), tt(y), ts.replace(block_rows=block_rows)))
    assert got == same


def test_nlml_block_rows_changes_the_block_scan():
    """On the plain backend the row blocks are the moments' summation
    order, so the override is live: the scan runs in the blocks asked for,
    and the value stays within the nlml gate."""
    X, y = gp_data(300, 2, 6)
    _, ts = specs("hermite", 2, n=6)
    calls = []
    orig = tfagp._block_scan_moments

    def spy(X, y, feats_fn, M, block_rows, *a, **kw):
        calls.append(block_rows)
        return orig(X, y, feats_fn, M, block_rows, *a, **kw)

    try:
        tfagp._block_scan_moments = spy
        a = float(tfagp.nlml(tt(X), tt(y), ts, block_rows=32))
        b = float(tfagp.nlml(tt(X), tt(y), ts))
    finally:
        tfagp._block_scan_moments = orig
    assert calls == [32, 300]
    assert abs(a - b) < _nlml_tol(b)


@pytest.mark.parametrize("call", [
    "positional_block_rows", "keyword_mask", "positional_none_shims",
    "idx", "n_max", "params_not_a_spec",
])
def test_nlml_calls_accepted_or_refused_as_in_jax(call):
    X, y = gp_data(60, 2, 2)
    js, ts = specs("hermite", 2, n=5)
    mask = (np.arange(60) % 4 != 1).astype(np.float32)
    forms = {
        "positional_block_rows": (lambda nl, X, y, s, m: nl(X, y, s, None, None, 16)),
        "keyword_mask": (lambda nl, X, y, s, m: nl(X, y, s, block_rows=8, mask=m)),
        "positional_none_shims": (lambda nl, X, y, s, m: nl(X, y, s, None, None)),
        "idx": (lambda nl, X, y, s, m: nl(X, y, s, np.zeros((4, 2), np.int32))),
        "n_max": (lambda nl, X, y, s, m: nl(X, y, s, None, 5)),
        "params_not_a_spec": (lambda nl, X, y, s, m: nl(X, y, (0.8, 2.0, 0.05))),
    }
    fn = forms[call]
    try:
        want = float(fn(jfagp.nlml, jnp.asarray(X), jnp.asarray(y), js, jnp.asarray(mask)))
    except TypeError as e:
        with pytest.raises(TypeError, match="was removed") as got:
            fn(tfagp.nlml, tt(X), tt(y), ts, tt(mask))
        assert str(got.value) == str(e)
        return
    got = float(fn(tfagp.nlml, tt(X), tt(y), ts, tt(mask)))
    assert abs(got - want) < _nlml_tol(want)


def test_nlml_mask_stays_keyword_only():
    X, y = gp_data(20, 2, 0)
    _, ts = specs("hermite", 2, n=4)
    with pytest.raises(TypeError):
        tfagp.nlml(tt(X), tt(y), ts, None, None, None, torch.ones(20))


@pytest.mark.parametrize("name", ["GP.optimize", "optimize_fleet", "optimize_restarts"])
def test_optimize_signatures_match_jax(name):
    """The port's optimizers take the JAX package's arguments, in order,
    of the same kinds and defaults (``metrics`` and ``tracer`` included)."""
    mine, ref = {"GP.optimize": (GP.optimize, JGP.optimize),
                 "optimize_fleet": (tgh.optimize_fleet, jgh.optimize_fleet),
                 "optimize_restarts": (tgh.optimize_restarts, jgh.optimize_restarts)}[name]
    params = [[(p.name, p.kind, p.default) for p in inspect.signature(f).parameters.values()]
              for f in (mine, ref)]
    assert params[0] == params[1]


# names of the reference's core the port leaves out: the legacy config (the
# Vecchia family's vecchia and VecchiaState are exported since ROADMAP A6)
NOT_PORTED = {"FAGPConfig"}


def test_core_exports_the_references_names():
    """``repro_torch.core`` exports every name ``repro/core/__init__.py``
    imports, ``vecchia`` and ``VecchiaState`` among them, less the legacy
    ``FAGPConfig``; and the two eigenvalue
    helpers it gained agree with the reference's at rtol 1e-6."""
    tree = ast.parse(Path(jcore.__file__).read_text())
    ref_names = {a.asname or a.name for node in tree.body
                 if isinstance(node, ast.ImportFrom) for a in node.names}
    assert set(tcore.__all__) == ref_names - NOT_PORTED
    assert all(hasattr(tcore, n) for n in tcore.__all__)
    eps, rho = np.float32(0.7), np.float32(1.6)
    np.testing.assert_allclose(
        tcore.eigenvalues_1d(9, tt(eps), tt(rho)).numpy(),
        np.asarray(jmercer.eigenvalues_1d(9, jnp.float32(eps), jnp.float32(rho))), rtol=1e-6)
    idx = jmercer.total_degree(5, 3)
    e3, r3 = np.array([0.5, 0.9, 1.3], np.float32), np.array([1.5, 2.0, 2.5], np.float32)
    want = jmercer.eigenvalues_nd(jnp.asarray(idx), jmercer.SEKernelParams.create(
        jnp.asarray(e3), jnp.asarray(r3), 0.1))
    np.testing.assert_allclose(tcore.eigenvalues_nd(tt(idx), tt(e3), tt(r3)).numpy(),
                               np.asarray(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# Refusals name their ROADMAP.md item
# ---------------------------------------------------------------------------


def _bank():
    Xb = np.zeros((2, 16, 2), np.float32)
    yb = np.zeros((2, 16), np.float32)
    for s in range(2):
        Xb[s], yb[s] = gp_data(16, 2, s)
    _, ts = specs("hermite", 2, n=4)
    return GPBank.fit(tt(Xb), tt(yb), ts), ts


def _vecchia_load(tmp_path):
    """A JAX Vecchia checkpoint loads as a session that serves."""
    X, y = gp_data(40, 2, 1)
    JGP.fit(jnp.asarray(X), jnp.asarray(y),
            JSpec.create_vecchia([0.8, 0.8], 0.05, neighbors=8)).save(tmp_path)
    gp = GP.load(tmp_path, device="cpu")
    mu, var = gp.mean_var(tt(X[:4]))
    return gp.spec.approximation == "vecchia" and bool(torch.isfinite(mu).all()
                                                         and torch.isfinite(var).all())


def _fleet(**option):
    t_serve.serve_fleet(**{"engine": "sync", "device": "cpu", "tenants": 2, "n_train": 16,
                           "p": 2, "n": 4, "rounds": 1, "queries_per_round": 8,
                           "observations_per_round": 4, **option})


# (refusal, ROADMAP item, a word of that item's heading)
def _lm_model(arch):
    return t_models.get_model(t_configs.ARCHS[arch].SMOKE)


REFUSALS = {
    # the HLO lowerings wait for the LM half's dry run (ROADMAP A8.8)
    "lower_fit": (lambda tp: t_dist.lower_fit(None, t_mesh.make_local_mesh(devices=["cpu"])),
                  "A8", "LM"),
    "lower_predict": (lambda tp: t_dist.lower_predict(
        None, t_mesh.make_local_mesh(devices=["cpu"])), "A8", "LM"),
}


def _mesh(data=2, model=2):
    return t_mesh.make_local_mesh(data, model, devices=["cpu"] * (data * model))


def _moe_sharded():
    """The expert-parallel MoE path runs under a mesh and equals the dense
    path where nothing drops."""
    from repro_torch.models import moe as t_moe
    from repro_torch.parallel import hints

    cfg = t_configs.ARCHS["olmoe-1b-7b"].SMOKE
    p = t_moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, cfg.d_model))
                         .astype(np.float32))
    with hints.activate(_mesh()):
        y, aux = t_moe.moe_apply_sharded(p, x, cfg)
    return bool(torch.allclose(y, t_moe.moe_apply(p, x, cfg)[0], rtol=1e-5, atol=1e-6)
                and torch.isfinite(aux))


def _build_on_mesh():
    """``build(mesh=)`` places the state; its step trains the pieces."""
    from repro_torch.parallel import sharding

    cfg, model, params, opt, step, stream, extras, sh = t_train.build(
        "qwen2-1.5b", smoke=True, batch=2, seq=8, lr=1e-3, mesh=_mesh(), device="cpu")
    before = params.leaves["tok_emb"].gather("cpu")
    _, _, m = step(params, opt, stream.batch(0, extras, device="cpu"))
    return (isinstance(params, sharding.ShardedParams) and sh[0] == params.shardings()
            and bool(torch.isfinite(m["loss"]))
            and not torch.equal(before, params.leaves["tok_emb"].gather("cpu")))


def _elastic_restore(tmp_path):
    """An unsharded run's checkpoint restores into a mesh's pieces through
    ``train_loop(shardings=)``."""
    from repro_torch.models import lm as t_lm

    def run(mesh):
        cfg, model, params, opt, step, stream, extras, sh = t_train.build(
            "qwen2-1.5b", smoke=True, batch=2, seq=8, lr=1e-3, mesh=mesh, device="cpu",
            seed=int(mesh is not None))
        return t_runtime.train_loop(
            step, params, opt, lambda s: stream.batch(s, extras, device="cpu"),
            t_runtime.TrainLoopConfig(steps=1, ckpt_dir=str(tmp_path), handle_signals=False,
                                      async_ckpt=False),
            shardings=None if mesh is None else sh, log_fn=lambda s: None)

    p1, _, _ = run(None)
    p2, _, rep = run(_mesh())
    return rep["final_step"] == 1 and all(
        torch.equal(a, b) for a, b in zip(t_lm.leaves(p1).values(),
                                          t_lm.leaves(p2.materialize("cpu")).values()))


def _opt_bank():
    bank, _ = _bank()
    Xb = np.zeros((2, 16, 2), np.float32)
    yb = np.zeros((2, 16), np.float32)
    for s in range(2):
        Xb[s], yb[s] = gp_data(16, 2, s)
    return bank.optimize(tt(Xb), tt(yb), restarts=1, steps=2)


def _router_after_ingest():
    router = BankRouter(_bank()[0], ingest_chunk=4)
    for i in range(5):
        router.observe(1, np.full(2, 0.1 * i, np.float32), 0.5)
    router.ingest()
    return router


def _donated_router_kills_its_donor():
    bank = _bank()[0]
    router = BankRouter(bank, ingest_chunk=4, donate_updates=True)
    router.observe(1, np.full(2, 0.1, np.float32), 0.5)
    router.ingest()
    with pytest.raises(RuntimeError, match="donated"):
        bank.mean_var([1], torch.zeros(1, 2))
    return isinstance(router.bank, GPBank)


def _optimize_fleet_telemetry():
    reg, tracer = MetricsRegistry(), Tracer()
    tgh.optimize_fleet(tt(gp_data(16, 2, 0)[0][None]), tt(gp_data(16, 2, 0)[1][None]),
                       _bank()[1], restarts=1, steps=2, metrics=reg, tracer=tracer)
    return (reg.snapshot()["counters"]["hyperopt_rounds_total"] == 2
            and {e["name"] for e in tracer.events()} == {"hyperopt_progress"})


def _router_flush_span():
    tracer = Tracer()
    router = BankRouter(_bank()[0], tracer=tracer)
    router.submit(0, np.zeros(2, np.float32))
    router.flush()
    return [e["name"] for e in tracer.events()] == ["flush"]


def _sharded_fleet_matches_unsharded():
    flat = _fleet_out(rounds=2)
    out = _fleet_out(rounds=2, shards=2)
    return out["shard_occupancy"] == [1, 1] and all(
        abs(h["rmse"] - g["rmse"]) < 1e-5 for h, g in zip(out["rounds"], flat["rounds"]))


# the calls ROADMAP A2, A3, A4, A5, A6 and A8's training, MoE, MLA, SSM, audio
# and VLM and parallel/ parts refused until they were ported, and what each
# now returns
PORTED = {
    "GPBank.downdate": lambda tp: _bank()[0].downdate(
        [0], tt(gp_data(16, 2, 0)[0][None, :2]), tt(gp_data(16, 2, 0)[1][None, :2]))[1].tolist()
    == [True],
    "GPBank.refit_window": lambda tp: isinstance(_bank()[0].refit_window(
        [0], tt(gp_data(8, 2, 0)[0][None]), tt(gp_data(8, 2, 0)[1][None])), GPBank),
    "GPBank.optimize": lambda tp: _opt_bank().hypers is not None,
    "GPBank(hypers)": lambda tp: GPBank(stack=_opt_bank().stack, active=np.ones(2, bool),
                                        slots={0: 0, 1: 1}, hypers=_opt_bank().hypers).hypers
    is not None,
    "BankRouter.stale_tenants": lambda tp: _router_after_ingest().stale_tenants(4) == [1],
    "BankRouter.reoptimize": lambda tp: BankRouter(_bank()[0]).reoptimize(
        [], torch.zeros(0, 4, 2), torch.zeros(0, 4)) is None,
    "serve_fleet(reopt_every)": lambda tp: _fleet_out(
        reopt_every=1, observations_per_round=16, reopt_min_rows=4)["bank"].hypers is not None,
    "serve_fleet(window)": lambda tp: "cold tier" in _value_error(lambda: _fleet(window=4)),
    # ROADMAP A4
    "serve_fleet(engine=pipelined)": lambda tp: _fleet_out(
        engine="pipelined")["latency"]["overall"]["completed"] == 8,
    "serve_fleet(cold_dir)": lambda tp: _fleet_out(
        engine="pipelined", cold_dir=str(tp), capacity=1)["lifecycle"]["cold_saves"] >= 1,
    "serve_fleet(cold_dir, window)": lambda tp: _fleet_out(
        engine="pipelined", cold_dir=str(tp), window=8, reopt_every=1, reopt_min_rows=1,
        reopt_steps=1, reopt_restarts=1, observations_per_round=8)["rounds"][0]["aged_rows"] > 0,
    "serve_fleet(metrics)": lambda tp: _fleet_out(
        engine="pipelined", metrics=MetricsRegistry())["latency"]["registry"]["counters"][
        "serve_admitted_total"] == 8,
    "optimize_fleet(metrics)": lambda tp: _optimize_fleet_telemetry(),
    "optimize_fleet(tracer)": lambda tp: _optimize_fleet_telemetry(),
    "serve_fleet(watchdog)": lambda tp: _fleet_out(
        engine="pipelined", watchdog=serving_watchdog(mode="count"))["engine"] == "pipelined",
    "BankRouter(tracer)": lambda tp: _router_flush_span(),
    "BankRouter(donate_updates)": lambda tp: _donated_router_kills_its_donor(),
    "GPBank update with donate": lambda tp: isinstance(_bank()[0]._update_at_slots(
        torch.tensor([0]), torch.zeros(1, 2, 2), torch.zeros(1, 2), donate=True), GPBank),
    # ROADMAP A6
    "GP.load(vecchia)": _vecchia_load,
    # ROADMAP A5: a resident bank has nothing to rebalance, as in JAX
    "BankRouter.rebalance": lambda tp: BankRouter(_bank()[0]).rebalance() == 0,
    "serve_fleet(shards)": lambda tp: _sharded_fleet_matches_unsharded(),
    # ROADMAP A8, the LM half's training part
    "loss_fn": lambda tp: _lm_loss()[0],
    "make_train_step": lambda tp: _lm_loss()[1],
    # ROADMAP A8, the LM half's MoE part
    "get_model(moe)": lambda tp: _moe_model(),
    # ROADMAP A8, the LM half's MLA and MTP part
    "get_model(mla)": lambda tp: _mla_model(),
    # ROADMAP A8, the LM half's SSM and hybrid part
    "get_model(ssm)": lambda tp: _ssm_model("mamba2-130m"),
    "get_model(hybrid)": lambda tp: _ssm_model("zamba2-7b"),
    # ROADMAP A8, the LM half's audio and VLM part
    "get_model(audio)": lambda tp: _extras_model("whisper-small"),
    "get_model(vlm)": lambda tp: _extras_model("llama-3.2-vision-11b"),
    # ROADMAP A8.7, parallel/ and the production mesh
    "make_production_mesh": lambda tp: t_mesh.make_production_mesh(
        devices=["cpu"] * 256).shape == {"data": 16, "model": 16},
    "train_loop(shardings)": _elastic_restore,
    "launch.train.build(mesh)": lambda tp: _build_on_mesh(),
    "moe_apply_sharded": lambda tp: _moe_sharded(),
}


def _extras_model(arch):
    """whisper's or llama-3.2-vision's SMOKE model serves (its self and
    cross K/V, or its self and image K/V) and trains on the extras that
    ``launch.train.build`` draws."""
    from repro_torch.models import lm as t_lm

    cfg, model, params, opt, step, stream, extras, _ = t_train.build(
        arch, smoke=True, batch=2, seq=8, lr=1e-3, device="cpu")
    logits, cache = model.prefill(params, {"tokens": torch.zeros((2, 8), dtype=torch.int32),
                                           **extras}, cache_len=9)
    before = {k: v.clone() for k, v in t_lm.leaves(params).items()}
    _, _, m = step(params, opt, stream.batch(0, extras, device="cpu"))
    want = ({"self_k", "self_v", "cross_k", "cross_v"} if cfg.family == "audio"
            else {"k", "v", "img_k", "img_v"})
    return (set(extras) == ({"frames"} if cfg.family == "audio" else {"img"})
            and bool(torch.isfinite(logits).all()) and set(cache) == want
            and bool(torch.isfinite(m["loss"]))
            and any(not torch.equal(before[k], v) for k, v in t_lm.leaves(params).items()))


def _ssm_model(arch):
    """mamba2's or zamba2's SMOKE model serves (its O(1) state cache; the
    hybrid's shared block's K/V) and trains."""
    from repro_torch import optim as t_optim
    from repro_torch.models import lm as t_lm

    model = _lm_model(arch)
    params = model.init_params(0, device="cpu")
    logits, cache = model.prefill(params, {"tokens": torch.zeros((2, 8), dtype=torch.int32)},
                                  cache_len=9)
    ocfg = t_optim.AdamWConfig()
    before = params.final_norm.clone()
    _, _, m = t_steps.make_train_step(model, ocfg)(
        params, t_optim.init(t_lm.leaves(params), ocfg),
        {"tokens": torch.ones((2, 8), dtype=torch.int32)})
    want = {"conv_x", "conv_BC", "ssm"}
    if model.cfg.family == "hybrid":
        want |= {"attn_k", "attn_v", "conv_x_tail", "conv_BC_tail", "ssm_tail"}
    return (model.cfg.family in ("ssm", "hybrid") and bool(torch.isfinite(logits).all())
            and set(cache) == want and bool(torch.isfinite(m["loss"]))
            and not torch.equal(before, params.final_norm))


def _mla_model():
    """deepseek-v3's SMOKE model serves (its two latent caches) and trains,
    its MTP term in the loss."""
    from repro_torch import optim as t_optim
    from repro_torch.models import lm as t_lm

    model = _lm_model("deepseek-v3-671b")
    params = model.init_params(0, device="cpu")
    logits, cache = model.prefill(params, {"tokens": torch.zeros((2, 8), dtype=torch.int32)},
                                  cache_len=9)
    batch = {"tokens": torch.ones((2, 8), dtype=torch.int32)}
    loss, metrics = model.loss_fn(params, batch)
    no_mtp = t_lm.loss_fn(params, batch, dataclasses.replace(model.cfg, mtp_depth=0))[0]
    ocfg = t_optim.AdamWConfig()
    before = params.mtp_proj.clone()
    t_steps.make_train_step(model, ocfg)(params, t_optim.init(t_lm.leaves(params), ocfg),
                                         batch)
    return (model.cfg.use_mla and bool(torch.isfinite(logits).all())
            and set(cache) == {"latent_dense", "latent_moe"} and float(metrics["aux"]) > 0
            and float(loss) != float(no_mtp) and not torch.equal(before, params.mtp_proj))


def _moe_model():
    """olmoe's SMOKE model serves and trains, its aux loss in the loss."""
    model = _lm_model("olmoe-1b-7b")
    params = model.init_params(0, device="cpu")
    logits, cache = model.prefill(params, {"tokens": torch.zeros((2, 8), dtype=torch.int32)},
                                  cache_len=9)
    _, metrics = model.loss_fn(params, {"tokens": torch.ones((2, 8), dtype=torch.int32)})
    return (model.cfg.family == "moe" and bool(torch.isfinite(logits).all())
            and set(cache) == {"k", "v"} and float(metrics["aux"]) > 0)


def _lm_loss():
    """(a finite SMOKE loss with its reference keys, a train step that
    moves the parameters in place)."""
    from repro_torch import optim as t_optim
    from repro_torch.models import lm as t_lm

    model = _lm_model("qwen2-1.5b")
    params = model.init_params(0, device="cpu")
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32)}
    loss, metrics = model.loss_fn(params, batch)
    ocfg = t_optim.AdamWConfig()
    before = params.tok_emb.clone()
    out, _, m = t_steps.make_train_step(model, ocfg)(
        params, t_optim.init(t_lm.leaves(params), ocfg), batch)
    return (bool(torch.isfinite(loss)) and set(metrics) == {"loss", "aux", "tokens"},
            out is params and not torch.equal(before, params.tok_emb)
            and set(m) == {"loss", "aux", "tokens", "grad_norm", "lr"})


def _fleet_out(**option):
    return t_serve.serve_fleet(**{"engine": "sync", "device": "cpu", "tenants": 2,
                                  "n_train": 16, "p": 2, "n": 4, "rounds": 1,
                                  "queries_per_round": 8, "observations_per_round": 4,
                                  **option})


def _value_error(call) -> str:
    with pytest.raises(ValueError) as e:
        call()
    return str(e.value)


@pytest.mark.parametrize("name", sorted(PORTED))
def test_formerly_refused_call_works(name, tmp_path):
    """Each call that named ROADMAP A2, A3, A4, A5, A6 or A8's training, MoE,
    MLA, SSM, audio and VLM or parallel/ part in its refusal now runs (the
    window without a cold tier raises the JAX package's ValueError)."""
    assert PORTED[name](tmp_path)


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusal_names_its_roadmap_item(name, tmp_path):
    call, item, word = REFUSALS[name]
    with pytest.raises(UnsupportedError) as e:
        call(tmp_path)
    msg = str(e.value)
    assert e.value.layer == "port" and "does not support" in msg
    assert re.search(rf"ROADMAP(\.md)? {item}\b", msg), msg
    # no other item letter is named
    assert set(re.findall(r"\bA\d\b", msg)) <= {item, "A1"}, msg
    heading = re.search(rf"^\d+\. \*\*{item}: (.*)$", ROADMAP.read_text(), re.M)
    assert heading and word.lower() in heading.group(1).lower(), (item, word)


def test_no_refusal_names_a5():
    """Multi-device (ROADMAP A5) is ported: no refusal in the port names it."""
    src = Path(t_dist.__file__).resolve().parents[1]
    hits = [f"{f.name}:{i}" for f in sorted(src.rglob("*.py"))
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if "_not_ported(" in line and "A5" in line]
    assert hits == []


@pytest.mark.cuda
def test_bank_mesh_wants_as_many_cards_as_shards():
    """A mesh over the visible cards never falls back: one shard more than
    there are cards raises, naming the count."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n = torch.cuda.device_count()
    assert t_mesh.make_bank_mesh(n).shape == {"bank": n, "data": 1}
    with pytest.raises(ValueError, match=rf"wants {n + 1} devices; only {n} CUDA"):
        t_mesh.make_bank_mesh(n + 1)
    with pytest.raises(ValueError, match=rf"wants {n + 1} devices"):
        t_serve.serve_fleet(shards=n + 1, device="cuda", tenants=2, n_train=8, p=2, n=4,
                            rounds=1, queries_per_round=4, observations_per_round=2)


# ---------------------------------------------------------------------------
# import hygiene: the port and chip_smoke.py import nothing of JAX or of the
# JAX package
# ---------------------------------------------------------------------------

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)\b(?!_))", re.M)


def test_port_imports_without_jax():
    """Every module of repro_torch imports in a process where ``jax`` cannot
    be imported at all."""
    code = (
        "import pkgutil, importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert not [k for k, m in sys.modules.items()\n"
        "            if m is not None and (k == 'repro' or k.startswith(('repro.', 'jax')))]\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 60     # every module was walked


def test_port_sources_name_no_jax_import():
    files = sorted(PORT.rglob("*.py")) + [PORT.parents[1] / "chip_smoke.py"]
    hits = [f"{f.relative_to(PORT.parents[1])}:{m.group(0).strip()}" for f in files
            for m in FORBIDDEN.finditer(f.read_text())]
    assert hits == []
    # the pattern has teeth
    assert FORBIDDEN.search("from repro.models import lm") and FORBIDDEN.search("import jax")
    assert not FORBIDDEN.search("from repro_torch.models import lm")
