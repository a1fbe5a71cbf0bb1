"""GPipe-style pipeline parallelism: the port of
``repro/parallel/pipeline.py``.

The layer stack is split into S = ``mesh.shape[axis]`` stages, stage s
resident on the device of cell s along ``axis`` (weights never move); M
microbatches stream through a schedule of T = M + S - 1 steps, at step t
stage s working on microbatch t - s when it exists, and each stage hands
its activation to the next with one ``.to(device)``, the counterpart of
the reference's one ``collective_permute``.  The fill and drain bubbles
are the classic GPipe schedule's: a stage idles S - 1 of the T steps.

The reference runs the schedule as one ``shard_map`` program with a
``lax.scan`` over the steps; on the port's single controller the host
thread runs the steps in order and, within a step, the stages in order.
Every stage call is the one a sequential run makes on the same
microbatch, so the forward equals the stages applied in sequence bit for
bit, and it is differentiable through autograd, as the reference's is
through the transpose of ``ppermute``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

__all__ = ["gpipe"]


def _stage(stage_params, s: int):
    """Stage s's parameters: element s of a sequence, or the slice [s] of
    a tensor (or a dict of tensors) stacked with the stage axis first, as
    the reference takes them."""
    if isinstance(stage_params, dict):
        return {k: _stage(v, s) for k, v in stage_params.items()}
    return stage_params[s]


def _to(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(v, device) for v in obj)
    if isinstance(obj, nn.Module):
        return obj.to(device)
    return obj


def gpipe(stage_fn: Callable, stage_params: Any, x_microbatches: torch.Tensor, mesh,
          axis: str = "model") -> torch.Tensor:
    """Run ``x_microbatches`` (M, mb, ...) through S pipeline stages,
    ``stage_fn(stage_params_s, x (mb, ...)) -> (mb, ...)``.  Returns (M,
    mb, ...) on the last stage's device."""
    S = mesh.shape[axis]
    M = x_microbatches.shape[0]
    T = M + S - 1                          # the schedule's length, bubbles included
    ax = mesh.axis_names.index(axis)
    devices = [mesh.devices[tuple(s if i == ax else 0 for i in range(mesh.devices.ndim))]
               for s in range(S)]
    params = [_to(_stage(stage_params, s), devices[s]) for s in range(S)]
    carry = [None] * S                     # carry[s]: stage s's input at this step
    outs = [None] * M
    for t in range(T):
        nxt = [None] * S
        for s in range(S):
            m = t - s
            if not 0 <= m < M:
                continue
            x_in = x_microbatches[m].to(devices[0]) if s == 0 else carry[s]
            y = stage_fn(params[s], x_in)
            if s == S - 1:
                outs[m] = y
            else:
                nxt[s + 1] = y.to(devices[s + 1])
        carry = nxt
    return torch.stack(outs)
