"""The port's training runtime: ``runtime.train_loop``, the checkpoint
store's ``AsyncCheckpointer`` and AdamW, as ``tests/test_runtime.py``
holds the JAX package's, on the same tiny problem in torch; then the LM
train loop, and checkpoints that either package's loop resumes.

Gates: a restart is exact at the reference test's rtol 1e-6 / atol 1e-7
(``tests/test_runtime.py:111-112``); a run resumed across packages
matches the JAX package's straight run at the gate of
``tests/test_torch_train.py``'s train steps: 1e-5 of each leaf's largest
entry plus what the gradient gate allows the AdamW updates to move
(``test_torch_lm_common.adamw_gate``, over the six steps of the straight
run).
"""
import os
import signal
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_lm_common import (adamw_gate, assert_params_within, both,  # noqa: E402
                                  jax_train_run)

from repro import checkpoint as jcheckpoint  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.data import TokenStream as JStream  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.runtime import TrainLoopConfig as JLoopConfig  # noqa: E402
from repro.runtime import train_loop as jtrain_loop  # noqa: E402
from repro_torch import checkpoint, optim  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.runtime import TrainLoopConfig, train_loop  # noqa: E402

QUIET = dict(log_fn=lambda s: None)


def _tiny_problem(seed=0):
    """2-layer MLP regression on a fixed function (the reference test's),
    weights from numpy at ``seed``."""
    rng = np.random.default_rng(seed)
    params = {
        "w1": torch.from_numpy((rng.standard_normal((8, 32)) * 0.3).astype(np.float32)),
        "w2": torch.from_numpy((rng.standard_normal((32, 1)) * 0.3).astype(np.float32)),
        "b": torch.zeros((1,)),
    }
    ocfg = optim.AdamWConfig(lr=1e-2, weight_decay=0.0)

    def batch_fn(step):
        r = np.random.default_rng(step)
        x = r.standard_normal((16, 8)).astype(np.float32)
        y = np.sin(x.sum(axis=1, keepdims=True)).astype(np.float32)
        return {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}

    def loss_fn(p, b):
        h = torch.tanh(b["x"] @ p["w1"])
        pred = h @ p["w2"] + p["b"]
        l = torch.mean((pred - b["y"]) ** 2)
        return l, {"loss": l}

    def step_fn(p, o, b):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        l, m = loss_fn(leaves, b)
        g = dict(zip(leaves, torch.autograd.grad(l, list(leaves.values()))))
        p, o, om = optim.apply_updates(p, g, o, ocfg)
        return p, o, {**{k: v.detach() for k, v in m.items()}, **om}

    return params, optim.init(params, ocfg), step_fn, batch_fn


# ---------------------------------------------------------------------------
# the checkpoint store
# ---------------------------------------------------------------------------


class TestCheckpoint:
    def test_roundtrip_bf16_and_nested(self, tmp_path):
        tree = {
            "a": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4),
            "nested": {"b": torch.ones((2, 2)), "step": torch.tensor(7, dtype=torch.int32)},
        }
        checkpoint.save(tmp_path, 3, tree)
        step, out = checkpoint.restore(tmp_path, tree, device="cpu")
        assert step == 3
        assert out["a"].dtype == torch.bfloat16 and torch.equal(out["a"], tree["a"])
        assert torch.equal(out["nested"]["b"], tree["nested"]["b"])
        assert int(out["nested"]["step"]) == 7

    def test_latest_and_atomicity(self, tmp_path):
        tree = {"w": torch.zeros((4,))}
        checkpoint.save(tmp_path, 1, tree)
        checkpoint.save(tmp_path, 5, tree)
        assert checkpoint.latest_step(tmp_path) == 5
        (tmp_path / "tmp.9.123").mkdir()           # a stale staging dir
        assert checkpoint.latest_step(tmp_path) == 5

    def test_async_checkpointer(self, tmp_path):
        c = checkpoint.AsyncCheckpointer(tmp_path)
        c.save(10, {"w": torch.ones((128, 128))})
        c.wait()
        step, out = checkpoint.restore(tmp_path, {"w": 0}, device="cpu")
        assert step == 10 and float(out["w"][0, 0]) == 1.0

    def test_async_copy_is_taken_before_save_returns(self, tmp_path):
        """The train step updates its tensors in place right after ``save``
        returns; the checkpoint holds the values at the call."""
        w = torch.ones((256, 256))
        c = checkpoint.AsyncCheckpointer(tmp_path)
        c.save(1, {"w": w, "host": np.ones(3)})
        w.mul_(3.0)
        c.wait()
        _, out = checkpoint.restore(tmp_path, {"w": 0, "host": 0}, device="cpu")
        assert torch.equal(out["w"], torch.ones((256, 256)))
        assert out["host"].tolist() == [1.0, 1.0, 1.0]

    def test_async_failure_raises_exactly_once_and_is_counted(self, tmp_path):
        reg = obs_metrics.MetricsRegistry()
        prev = obs_metrics.set_default(reg)
        try:
            blocker = tmp_path / "not_a_dir"
            blocker.write_text("x")
            c = checkpoint.AsyncCheckpointer(blocker)       # mkdir under a file fails
            c.save(2, {"w": torch.zeros(3)})
            c._thread.join()
            # counted when the worker fails, before any wait()
            assert reg.snapshot()["counters"]["checkpoint_async_failures_total"] == 1
            with pytest.raises(OSError) as e:
                c.wait()
            assert any("async checkpoint of step 2 failed" in n
                       for n in getattr(e.value, "__notes__", []))
            c.wait()                                         # raised once only
            # save() waits first: a failure is never skipped by the next save
            c.save(3, {"w": torch.zeros(3)})
            with pytest.raises(OSError):
                c.save(4, {"w": torch.zeros(3)})     # raised step 3's; wrote nothing
            c.wait()
            assert reg.snapshot()["counters"]["checkpoint_async_failures_total"] == 2
        finally:
            obs_metrics.set_default(prev)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


class TestTrainLoop:
    def test_loss_decreases(self):
        params, opt, step_fn, batch_fn = _tiny_problem()
        cfg = TrainLoopConfig(steps=300, ckpt_every=1000, ckpt_dir=None, log_every=50,
                              handle_signals=False)
        _, _, rep = train_loop(step_fn, params, opt, batch_fn, cfg, **QUIET)
        assert rep["history"][-1]["loss"] < rep["history"][0]["loss"] * 0.8
        assert len(rep["history"]) == 6 and rep["final_step"] == 300
        assert rep["median_step_s"] > 0 and not rep["preempted"]

    @pytest.mark.parametrize("async_ckpt", [False, True])
    def test_restart_is_exact(self, tmp_path, async_ckpt):
        """60 steps straight against 30 + a fresh start that restores step
        30 and runs 30 more: the same parameters."""
        params, opt, step_fn, batch_fn = _tiny_problem()
        cfg_a = TrainLoopConfig(steps=60, ckpt_every=1000, ckpt_dir=None, log_every=100,
                                handle_signals=False)
        pa, _, _ = train_loop(step_fn, params, opt, batch_fn, cfg_a, **QUIET)

        d = tmp_path / "ck"
        cfg_b1 = TrainLoopConfig(steps=30, ckpt_every=10, ckpt_dir=str(d), log_every=100,
                                 handle_signals=False, async_ckpt=async_ckpt)
        train_loop(step_fn, params, opt, batch_fn, cfg_b1, **QUIET)
        assert checkpoint.latest_step(d) == 30
        cfg_b2 = TrainLoopConfig(steps=60, ckpt_every=1000, ckpt_dir=str(d), log_every=100,
                                 handle_signals=False, async_ckpt=async_ckpt)
        logs = []
        pb, ob, rep = train_loop(step_fn, params, opt, batch_fn, cfg_b2, log_fn=logs.append)
        assert rep["final_step"] == 60 and "[restore] resumed from step 30" in logs
        assert int(ob["step"]) == 60
        for k in pa:
            np.testing.assert_allclose(pa[k].numpy(), pb[k].numpy(), rtol=1e-6, atol=1e-7)

    def test_preemption_checkpoints_and_exits(self, tmp_path):
        params, opt, step_fn, batch_fn = _tiny_problem()
        d = tmp_path / "ck"
        cfg = TrainLoopConfig(steps=10_000, ckpt_every=10_000, ckpt_dir=str(d),
                              log_every=10_000, handle_signals=True, async_ckpt=False)
        t = threading.Timer(1.0, lambda: os.kill(os.getpid(), signal.SIGTERM))
        t.start()
        old = signal.getsignal(signal.SIGTERM)
        _, _, rep = train_loop(step_fn, params, opt, batch_fn, cfg, **QUIET)
        t.join()
        assert rep["preempted"]
        assert rep["final_step"] < 10_000
        assert checkpoint.latest_step(d) == rep["final_step"]
        assert signal.getsignal(signal.SIGTERM) is old          # handler restored

    def test_stragglers_are_counted(self):
        params, opt, step_fn, batch_fn = _tiny_problem()
        import time

        def slow(p, o, b, n=[0]):
            n[0] += 1
            if n[0] == 9:
                time.sleep(0.3)
            return step_fn(p, o, b)

        cfg = TrainLoopConfig(steps=10, ckpt_dir=None, handle_signals=False)
        logs = []
        _, _, rep = train_loop(slow, params, opt, batch_fn, cfg, log_fn=logs.append)
        assert rep["stragglers"] >= 1 and any(s.startswith("[straggler] step 8") for s in logs)

    def test_shardings_name_a8(self, tmp_path):
        """``shardings=`` is ported (ROADMAP A8.7): a checkpoint of the
        unplaced tree restores into the mesh's pieces, bitwise."""
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.parallel import sharding

        params, opt, step_fn, batch_fn = _tiny_problem()
        cfg = TrainLoopConfig(steps=3, ckpt_dir=str(tmp_path), ckpt_every=3,
                              handle_signals=False, async_ckpt=False)
        p3, o3, _ = train_loop(step_fn, params, opt, batch_fn, cfg, **QUIET)
        mesh = make_local_mesh(2, 2, devices=["cpu"] * 4)
        P = sharding.PartitionSpec
        p_sh = {"w1": sharding.NamedSharding(mesh, P(None, "model")),
                "w2": sharding.NamedSharding(mesh, P("data")),
                "b": sharding.NamedSharding(mesh, P())}
        o_sh = sharding.tree_shardings(o3, mesh)
        fresh, fo, _, _ = _tiny_problem(seed=1)
        p, o, rep = train_loop(step_fn, fresh, fo, batch_fn, cfg, shardings=(p_sh, o_sh),
                               **QUIET)
        assert rep["final_step"] == 3
        for k, v in p3.items():
            assert isinstance(p[k], sharding.Sharded) and p[k].spec == p_sh[k].spec
            assert torch.equal(p[k].gather("cpu"), v), k
        assert torch.equal(o["mu"]["w1"]["m"].gather("cpu"), o3["mu"]["w1"]["m"])


class TestOptim:
    def test_adamw_converges_quadratic(self):
        p = {"x": torch.tensor([5.0, -3.0])}
        cfg = optim.AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=None)
        s = optim.init(p, cfg)
        for _ in range(500):
            g = {"x": 2.0 * (p["x"] - 1.0)}
            p, s, _ = optim.apply_updates(p, g, s, cfg)
        np.testing.assert_allclose(p["x"].numpy(), [1.0, 1.0], atol=2e-2)

    def test_clip_norm_bounds_update(self):
        p = {"x": torch.zeros((4,))}
        cfg = optim.AdamWConfig(lr=1.0, clip_norm=1e-3, weight_decay=0.0)
        s = optim.init(p, cfg)
        _, _, m = optim.apply_updates(p, {"x": torch.full((4,), 1e6)}, s, cfg)
        assert float(m["grad_norm"]) > 1e5                  # reported before the clip
        p2 = {"x": torch.zeros((4,))}
        m2 = optim.apply_updates_(p2, {"x": torch.full((4,), 1e6)}, optim.init(p2, cfg), cfg)
        assert float(m2["grad_norm"]) > 1e5 and float(p2["x"].abs().max()) <= 1.0 + 1e-6

    def test_bf16_state_dtype(self):
        p = {"x": torch.zeros((4,), dtype=torch.bfloat16)}
        cfg = optim.AdamWConfig(lr=1e-3, state_dtype=torch.bfloat16)
        s = optim.init(p, cfg)
        assert s["mu"]["x"]["m"].dtype == torch.bfloat16
        optim.apply_updates_(p, {"x": torch.ones(4, dtype=torch.bfloat16)}, s, cfg)
        assert s["mu"]["x"]["v"].dtype == torch.bfloat16 and p["x"].dtype == torch.bfloat16

    def test_data_stream_deterministic(self):
        s1 = TokenStream(vocab=100, seq=16, global_batch=4, seed=1)
        s2 = TokenStream(vocab=100, seq=16, global_batch=4, seed=1)
        assert torch.equal(s1.batch(7, device="cpu")["tokens"],
                           s2.batch(7, device="cpu")["tokens"])
        assert not torch.equal(s1.batch(7, device="cpu")["tokens"],
                               s1.batch(8, device="cpu")["tokens"])


# ---------------------------------------------------------------------------
# the LM's loop and its checkpoints, across packages
# ---------------------------------------------------------------------------

ARCH = "qwen2-1.5b"
B, SEQ, LR = 2, 48, 3e-3


def _lm(dtype="float32"):
    """(jcfg, tcfg, JAX model, port model, JAX params, port params) on one
    set of weights; the AdamW configs of both; the two token streams."""
    jcfg, tcfg, jm, tm, jp, tp = both(ARCH, dtype)
    jo = joptim.AdamWConfig(lr=joptim.warmup_cosine(LR, 2, 50))
    to = optim.AdamWConfig(lr=optim.warmup_cosine(LR, 2, 50))
    return (jcfg, tcfg, jm, tm, jp, tp, jo, to,
            JStream(vocab=jcfg.vocab, seq=SEQ, global_batch=B, seed=0),
            TokenStream(vocab=tcfg.vocab, seq=SEQ, global_batch=B, seed=0))


def _jax_run(jm, jp, jo, js, steps, ckpt_dir=None):
    loop = JLoopConfig(steps=steps, ckpt_every=1000, ckpt_dir=ckpt_dir and str(ckpt_dir),
                       log_every=1000, handle_signals=False, async_ckpt=False)
    p, o, rep = jtrain_loop(jax.jit(jmake_train_step(jm, jo)), jp, joptim.init(jp, jo),
                            js.batch, loop, **QUIET)
    return p, o, rep


def _port_run(tm, tp, to, ts, steps, ckpt_dir=None, **kw):
    loop = TrainLoopConfig(steps=steps, ckpt_dir=ckpt_dir and str(ckpt_dir),
                           log_every=1000, handle_signals=False, **kw)
    return train_loop(make_train_step(tm, to), tp, optim.init(tlm.leaves(tp), to),
                      lambda s: ts.batch(s, device="cpu"), loop, **QUIET)


def test_lm_train_loop_restart_is_exact(tmp_path):
    """The LM's loop: 6 steps straight against 3 (async writes at steps 1
    and 2, the last one synchronous) and a fresh model that restores step 3
    in place and runs 3 more: the same parameters and AdamW state."""
    *_, tm, _, tp, _, to, _, ts = _lm()
    *_, tp2, _, _, _, _ = _lm()
    *_, tp3, _, _, _, _ = _lm()
    pa, oa, _ = _port_run(tm, tp, to, ts, 6)
    d = tmp_path / "ck"
    _port_run(tm, tp2, to, ts, 3, d, ckpt_every=1)
    assert checkpoint.latest_step(d) == 3 and checkpoint.latest_step(d) is not None
    pb, ob, rep = _port_run(tm, tp3, to, ts, 6, d)
    assert pb is tp3 and rep["final_step"] == 6 and int(ob["step"]) == 6
    for (ka, va), (kb, vb) in zip(tlm.leaves(pa).items(), tlm.leaves(pb).items()):
        np.testing.assert_allclose(va.detach().numpy(), vb.detach().numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=ka)
        for m in ("m", "v"):
            np.testing.assert_allclose(oa["mu"][ka][m].numpy(), ob["mu"][kb][m].numpy(),
                                       rtol=1e-6, atol=1e-7)


def test_lm_async_checkpoint_holds_its_step(tmp_path):
    """An async write at step 2 overlaps step 3, which updates the model in
    place: the step-2 checkpoint holds step 2's parameters, bitwise those
    of a 2-step run."""
    *_, tm, _, tp, _, to, _, ts = _lm()
    *_, tp2, _, _, _, _ = _lm()
    d = tmp_path / "ck"
    _port_run(tm, tp, to, ts, 3, d, ckpt_every=2)
    p2, o2, _ = _port_run(tm, tp2, to, ts, 2)
    _, tree = checkpoint.restore(d, convert.train_state_keys(tp), step=2, device="cpu")
    want = convert.train_state_to_jax(p2, o2)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = tree
        for k in path:
            node = node[k.key]
        assert torch.equal(node, leaf), [k.key for k in path]


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package's loop writes step 3 of the SMOKE model; the port
    restores it and runs to step 6; the result is the JAX package's run
    straight to 6."""
    _, _, jm, tm, jp, tp, jo, to, js, ts = _lm()
    want, _, mets, grads = jax_train_run(jm, jp, jo, js, 6)
    d = tmp_path / "ck"
    _jax_run(jm, jp, jo, js, 3, d)
    assert checkpoint.latest_step(d) == 3
    logs = []
    pb, ob, rep = train_loop(
        make_train_step(tm, to), tp, optim.init(tlm.leaves(tp), to),
        lambda s: ts.batch(s, device="cpu"),
        TrainLoopConfig(steps=6, ckpt_dir=str(d), log_every=1000, handle_signals=False),
        log_fn=logs.append)
    assert "[restore] resumed from step 3" in logs and rep["final_step"] == 6
    assert int(ob["step"]) == 6
    assert_params_within(convert.lm_params_to_jax(pb), want, adamw_gate(want, mets, grads))


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """The port's loop writes step 3; the JAX package's loop restores it
    and runs to step 6; the result is the JAX package's run straight to
    6."""
    _, _, jm, tm, jp, tp, jo, to, js, ts = _lm()
    want, _, mets, grads = jax_train_run(jm, jp, jo, js, 6)
    d = tmp_path / "ck"
    _port_run(tm, tp, to, ts, 3, d)
    assert jcheckpoint.latest_step(d) == 3
    got, jopt, rep = _jax_run(jm, jp, jo, js, 6, d)
    assert rep["final_step"] == 6 and int(jopt["step"]) == 6
    assert_params_within(jax.tree.map(lambda a: np.asarray(a, np.float32), got), want,
                         adamw_gate(want, mets, grads))


def test_bf16_checkpoint_round_trip(tmp_path):
    """A bfloat16 model (its norms float32) and its moments come back
    bitwise, in their dtypes, through the reference's tree."""
    *_, tm, _, tp, _, to, _, ts = _lm("bfloat16")
    *_, tp2, _, _, _, _ = _lm("bfloat16")
    p, o, _ = _port_run(tm, tp, to, ts, 2, tmp_path / "ck")
    o2 = optim.init(tlm.leaves(tp2), to)
    _, tree = checkpoint.restore(tmp_path / "ck", convert.train_state_keys(tp2), device="cpu")
    convert.load_train_state(tp2, o2, tree)
    for (k, a), b in zip(tlm.leaves(p).items(), tlm.leaves(tp2).values()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
        assert o2["mu"][k]["v"].dtype == a.dtype and torch.equal(o["mu"][k]["v"],
                                                                 o2["mu"][k]["v"])
    assert tp2.tok_emb.dtype == torch.bfloat16 and int(o2["step"]) == 2


def test_build_refuses_a_mesh_naming_a8():
    """``build(mesh=)`` is ported (ROADMAP A8.7): it returns the state
    placed on the mesh and the reference's (param, opt-state) shardings,
    its pieces holding the weights it draws without a mesh."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import sharding

    mesh = make_local_mesh(2, 2, devices=["cpu"] * 4)
    *_, p, o, _, _, _, sh = ttrain.build(ARCH, smoke=True, batch=2, seq=16, lr=1e-3,
                                         mesh=mesh, device="cpu")
    *_, p0, _, _, _, _, sh0 = ttrain.build(ARCH, smoke=True, batch=2, seq=16, lr=1e-3,
                                           device="cpu")
    assert sh0 == (None, None) and isinstance(p, sharding.ShardedParams)
    assert sh[0] == p.shardings() and set(sh[1]) == {"mu", "step"}
    full = p.materialize("cpu")
    assert all(torch.equal(a, b) for a, b in zip(tlm.leaves(full).values(),
                                                 tlm.leaves(p0).values()))
    assert int(o["step"].gather("cpu")) == 0
