"""Fault-tolerant training loop.

Counterpart of ``repro/runtime/loop.py``, with its behaviours:

* **checkpoint/restart**: resumes from the latest checkpoint (batches are
  a pure function of the step, so a resumed run repeats the straight one);
* **preemption**: SIGTERM/SIGINT set a flag; the loop finishes the step,
  writes a checkpoint and exits cleanly;
* **async checkpointing**: a write overlaps the next steps, except on the
  last step and at preemption;
* **stragglers**: a step slower than ``straggler_factor`` times the
  running median of the last 50 is counted and logged.

``params`` is a nested dict of tensors or a model (``repro_torch.models.lm
.LM`` or ``repro_torch.models.encdec.EncDec``, stepped in place by
``launch.steps.make_train_step``); a model's
checkpoint is the reference's tree (``models.convert.train_state_to_jax``),
so either package resumes the other's run from the same directory.  A step
ends with a read of its loss, which waits for the device (the reference's
``block_until_ready``).

Under a mesh ``params`` is a ``parallel.sharding.ShardedParams`` (or a
dict of ``Sharded`` leaves) and ``opt_state`` a dict of ``Sharded``
leaves; a checkpoint gathers them to the host and holds the same tree.
``shardings=(param_shardings, opt_state_shardings)`` restores a
checkpoint, written on any mesh or on none, into the CURRENT mesh's
pieces: elastic restore (an unsharded model and state given with
``shardings`` come back placed).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import checkpoint
from ..models import convert
from ..parallel.sharding import ShardedParams, gather_tree, place

__all__ = ["TrainLoopConfig", "train_loop"]


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    straggler_factor: float = 1.5
    handle_signals: bool = True
    async_ckpt: bool = True


def _device(tree) -> torch.device:
    if isinstance(tree, dict):
        for v in tree.values():
            d = _device(v)
            if d is not None:
                return d
        return None
    return tree.device if isinstance(tree, torch.Tensor) else None


def _state(params, opt_state) -> dict:
    """The checkpoint's tree, ``{"params", "opt"}`` (placed leaves gathered
    to the host)."""
    if isinstance(params, ShardedParams):
        params = params.materialize("cpu")
        opt_state = gather_tree(opt_state, "cpu")
    if isinstance(params, torch.nn.Module):          # an LM or an EncDec
        return convert.train_state_to_jax(params, opt_state)
    return {"params": gather_tree(params, "cpu"), "opt": gather_tree(opt_state, "cpu")}


def _shardings_of(tree):
    if isinstance(tree, dict):
        return {k: _shardings_of(v) for k, v in tree.items()}
    return tree.sharding


def _restore(ckpt_dir, params, opt_state, shardings=None):
    """(step, params, opt_state) from the latest checkpoint; a model (an LM
    or an EncDec) and its AdamW state are written in place.  With
    ``shardings`` every leaf comes back placed on the current mesh (a
    ``ShardedParams`` and its state, given without, on their own
    shardings)."""
    if isinstance(params, ShardedParams):
        shardings = shardings or (params.shardings(), _shardings_of(opt_state))
        # host tensors for the file's values to land in
        params, opt_state = params.empty("cpu"), _empty_like(opt_state)
    if isinstance(params, torch.nn.Module):
        step, tree = checkpoint.restore(ckpt_dir, convert.train_state_keys(params),
                                        device="cpu")
        convert.load_train_state(params, opt_state, tree)
        if shardings is not None:
            params, opt_state = place(params, shardings[0]), place(opt_state, shardings[1])
        return step, params, opt_state
    step, tree = checkpoint.restore(
        ckpt_dir, {"params": params, "opt": opt_state}, device=_device(params) or "cpu",
        shardings=None if shardings is None else {"params": shardings[0],
                                                  "opt": shardings[1]})
    return step, tree["params"], tree["opt"]


def _empty_like(tree):
    if isinstance(tree, dict):
        return {k: _empty_like(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype)


def train_loop(
    train_step: Callable,          # (params, opt_state, batch) -> (params, opt_state, metrics)
    params: Any,
    opt_state: Any,
    batch_fn: Callable[[int], Any],
    cfg: TrainLoopConfig,
    *,
    shardings: tuple | None = None,
    log_fn: Callable[[str], None] = print,
):
    start_step = 0
    ckpt = None
    if cfg.ckpt_dir:
        ckpt = checkpoint.AsyncCheckpointer(cfg.ckpt_dir)
        if checkpoint.latest_step(cfg.ckpt_dir) is not None:
            start_step, params, opt_state = _restore(cfg.ckpt_dir, params, opt_state,
                                                     shardings)
            log_fn(f"[restore] resumed from step {start_step}")

    preempted = {"flag": False}
    old_handlers = {}
    if cfg.handle_signals:
        def _handler(signum, frame):
            preempted["flag"] = True
            log_fn(f"[preempt] signal {signum}: checkpoint at end of step")

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, _handler)
            except ValueError:  # not the main thread
                pass

    step_times: list[float] = []
    stragglers = 0
    history = []
    step = start_step
    try:
        while step < cfg.steps:
            t0 = time.perf_counter()
            batch = batch_fn(step)
            params, opt_state, metrics = train_step(params, opt_state, batch)
            loss = float(metrics["loss"])            # waits for the device
            dt = time.perf_counter() - t0
            step_times.append(dt)
            med = float(np.median(step_times[-50:]))
            if len(step_times) > 5 and dt > cfg.straggler_factor * med:
                stragglers += 1
                log_fn(f"[straggler] step {step}: {dt:.3f}s vs median {med:.3f}s")
            step += 1
            if step % cfg.log_every == 0 or step == cfg.steps:
                history.append(
                    {"step": step, "loss": loss,
                     "grad_norm": float(metrics.get("grad_norm", np.nan)),
                     "sec_per_step": dt}
                )
                log_fn(f"[step {step}] loss={history[-1]['loss']:.4f} "
                       f"gnorm={history[-1]['grad_norm']:.3f} {dt:.3f}s/step")
            want_ckpt = ckpt and (
                step % cfg.ckpt_every == 0 or step == cfg.steps or preempted["flag"]
            )
            if want_ckpt:
                state = _state(params, opt_state)
                if cfg.async_ckpt and not preempted["flag"] and step != cfg.steps:
                    ckpt.save(step, state)
                else:
                    ckpt.wait()
                    checkpoint.save(cfg.ckpt_dir, step, state)
                del state
            if preempted["flag"]:
                log_fn(f"[preempt] exiting cleanly at step {step}")
                break
    finally:
        if ckpt:
            ckpt.wait()
        for sig, h in old_handlers.items():
            signal.signal(sig, h)

    return params, opt_state, {
        "history": history,
        "final_step": step,
        "stragglers": stragglers,
        "preempted": preempted["flag"],
        "median_step_s": float(np.median(step_times)) if step_times else None,
    }
