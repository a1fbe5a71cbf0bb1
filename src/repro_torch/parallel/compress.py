"""Error-feedback int8 gradient compression for the cross-pod all-reduce:
the port of ``repro/parallel/compress.py``.

The payload is compressed 4x (float32 -> int8 + a float32 scale a block of
256) with error feedback: each member carries its quantization error into
its next step, so the error stays bounded instead of compounding.

    states = [CompressionState.init(g) for g in grads]       # one a member
    grads, states = compress_allreduce(grads, states, mesh, axis="pod")

The reference runs ``compress_allreduce`` inside ``shard_map``, one member
a shard, its ``psum`` summing the members' dequantized values.  On the
port's single controller the call takes every member's gradient tree
(one a cell along ``axis``, in cell order) and their states: each member
quantizes ``g + r`` and keeps ``v - deq`` as its residual, and every
member gets the mean of the dequantized values, summed in cell order on
the first member's device, so the result is bitwise equal across
members.  ``torch.round`` rounds half to even as ``jnp.round`` does and
the float32 divisions round correctly on both sides, so the int8 blocks
and the scales are the reference's, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["BLOCK", "CompressionState", "quantize", "dequantize", "compress_allreduce"]

BLOCK = 256


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


@dataclasses.dataclass
class CompressionState:
    """One member's error-feedback residuals, a tree like its gradients
    (float32)."""

    residual: Any

    @staticmethod
    def init(grads_like) -> "CompressionState":
        return CompressionState(residual=_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like))


def _pad_flat(x: torch.Tensor):
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.shape[0]) % BLOCK
    return F.pad(flat, (0, pad)), pad


def quantize(x: torch.Tensor):
    """float32 -> (int8 blocks (n, 256), float32 scales (n, 1)): blockwise
    symmetric, the scale a block's max |x| / 127 (at least 1e-12)."""
    flat, _ = _pad_flat(x)
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = int(np.prod(shape)) if len(shape) else 1
    return flat[:n].reshape(shape)


def compress_allreduce(grads: Sequence, states: Sequence[CompressionState], mesh,
                       axis="pod"):
    """Quantize each member's (grad + residual), average the dequantized
    values over the members, update the residuals.  ``grads`` holds one
    tree (a tensor or a nested dict of them) per cell along ``axis`` of
    ``mesh`` (a name or a tuple of names), in cell order, and ``states``
    their :class:`CompressionState`.  Returns (one averaged tree per
    member, each leaf in its gradient's dtype on its gradient's device;
    the new states)."""
    names = axis if isinstance(axis, tuple) else (axis,)
    n = int(np.prod([mesh.shape[a] for a in names]))
    if len(grads) != n or len(states) != n:
        raise ValueError(f"{axis!r} has {n} members; got {len(grads)} gradient trees and "
                         f"{len(states)} states")

    def one(*leaves):
        gs, rs = leaves[:n], leaves[n:]
        deqs, new_r = [], []
        for g, r in zip(gs, rs):
            v = g.to(torch.float32) + r
            q, s = quantize(v)
            deq = dequantize(q, s, g.shape)
            new_r.append(v - deq)                    # error feedback
            deqs.append(deq)
        home = deqs[0].device
        total = deqs[0]
        for deq in deqs[1:]:
            total = total + deq.to(home)
        avg = total / n
        return [avg.to(device=g.device, dtype=g.dtype, copy=True) for g in gs], new_r

    out = _map(one, *grads, *(s.residual for s in states))

    # _map's leaves are (averages, residuals) pairs: member i's of each
    def pick(tree, i, k):
        if isinstance(tree, dict):
            return {key: pick(v, i, k) for key, v in tree.items()}
        return tree[k][i]

    new_grads = [pick(out, i, 0) for i in range(n)]
    new_states = [CompressionState(residual=pick(out, i, 1)) for i in range(n)]
    return new_grads, new_states
