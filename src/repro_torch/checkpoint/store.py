"""Atomic, versioned checkpoint store for nested dicts of tensors.

Counterpart of ``repro/checkpoint/store.py``, with the same on-disk
layout, so a checkpoint written by either package restores in the other:

* ``<dir>/step_<10 digits>/{arrays.npz, manifest.json}``;
* a leaf's key is its path of dict keys joined by ``/`` (keys sorted, as
  ``jax.tree_util`` orders a dict), written into the npz with ``/``
  replaced by ``__``;
* the manifest holds ``{"step", "dtypes", "metadata"}``, ``dtypes``
  mapping each key to its dtype's name; a bfloat16 leaf is stored as a
  uint16 view (numpy has no bfloat16);
* writes go to ``<dir>/tmp.<step>.<pid>`` and are renamed into place with
  ``os.replace``, so a crash mid-write never corrupts a committed step; a
  dead writer's staging directory is ignored and reaped (and counted) by
  the next :func:`latest_step` / :func:`restore`;
* :class:`AsyncCheckpointer` overlaps the write with the next train steps.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..obs import metrics as obs_metrics

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer"]

_SEP = "/"
_STEP_RE = re.compile(r"^step_(\d+)$")
_TMP_RE = re.compile(r"^tmp\.(\d+)\.(\d+)$")


def _sweep_stale_tmp(ckpt_dir: Path) -> None:
    """Remove ``tmp.<step>.<pid>`` staging directories whose writer died
    mid-write.  Our own pid is skipped, and another pid's directory is
    removed only when that process is verifiably gone.  Every reaped
    directory counts into ``checkpoint_stale_tmp_reaped_total`` on the
    process-default metrics registry (``repro_torch.obs``)."""
    reaped = 0
    for p in ckpt_dir.iterdir():
        m = _TMP_RE.match(p.name)
        if m is None or not p.is_dir():
            continue
        pid = int(m.group(2))
        if pid == os.getpid():
            continue
        try:
            os.kill(pid, 0)          # signal 0: existence probe only
        except ProcessLookupError:
            shutil.rmtree(p, ignore_errors=True)
            reaped += 1
        except PermissionError:
            pass                     # alive under another user
    if reaped:
        obs_metrics.get_default().counter(
            "checkpoint_stale_tmp_reaped_total",
            "dead writers' staging dirs reaped",
        ).inc(reaped)


def _flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} of a nested dict, keys sorted; None leaves dropped
    (as ``jax.tree_util`` drops them)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{_SEP}"))
        return out
    if tree is None:
        return {}
    return {prefix[:-len(_SEP)]: tree}


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        *parents, last = key.split(_SEP)
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def _to_numpy(leaf) -> tuple:
    """(array to store, dtype name) for a tensor, array or scalar leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: Union[str, Path], step: int, tree: Any, *,
         metadata: Optional[dict] = None) -> Path:
    """Atomic checkpoint write: ``<dir>/step_<n>/{arrays.npz, manifest.json}``."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"tmp.{step}.{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    arrays, dtypes = {}, {}
    for key, leaf in _flatten(tree).items():
        arrays[key.replace(_SEP, "__")], dtypes[key] = _to_numpy(leaf)
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(
        json.dumps({"step": step, "dtypes": dtypes, "metadata": metadata or {}})
    )
    final = ckpt_dir / f"step_{step:010d}"
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: Union[str, Path]) -> Optional[int]:
    """Highest committed step in ``ckpt_dir`` (None when there is none).
    Only renamed ``step_<n>`` directories count; dead writers' staging
    directories are reaped on the way."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    _sweep_stale_tmp(ckpt_dir)
    steps = [
        int(m.group(1))
        for p in ckpt_dir.iterdir()
        if p.is_dir() and (m := _STEP_RE.match(p.name)) is not None
    ]
    return max(steps) if steps else None


def restore(ckpt_dir: Union[str, Path], like: Any, *, step: Optional[int] = None,
            device=None, host: tuple = (), shardings: Any = None) -> tuple:
    """Restore the leaves named by the nested dict ``like`` (its leaves are
    placeholders: shapes come from the file).  Returns ``(step, tree)``
    with every leaf a tensor on ``device`` (default ``"cuda"``; raises
    without a card), except the subtrees whose top-level keys ``host``
    names, which stay CPU tensors.  ``shardings``, a nested dict of
    ``parallel.sharding.NamedSharding`` matching ``like``, places each leaf
    on the CURRENT mesh instead (a ``Sharded``, its pieces on their cells'
    devices): elastic restore, whatever mesh (or none) wrote the file."""
    dev = torch.device("cpu") if shardings is not None else resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)          # also reaps dead-writer tmp dirs
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    elif ckpt_dir.exists():
        _sweep_stale_tmp(ckpt_dir)
    d = ckpt_dir / f"step_{step:010d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat = {}
    with np.load(d / "arrays.npz") as z:
        for key in _flatten(like):
            arr = z[key.replace(_SEP, "__")]
            if manifest["dtypes"][key] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            flat[key] = t if key.split(_SEP, 1)[0] in host else t.to(dev)
    if shardings is not None:
        from ..parallel.sharding import place

        sh = _flatten(shardings)
        flat = {key: place(t, sh[key]) for key, t in flat.items()}
    return manifest["step"], _unflatten(flat)


def _host_copy(tree):
    """Every tensor leaf of a nested dict as a fresh host copy (a CPU
    tensor is copied too: the train step updates its parameters in place),
    every array leaf as a copy; the copies have finished on return."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


class AsyncCheckpointer:
    """Overlap checkpoint serialization with training (one write in
    flight).

    ``save`` waits for the write before it, copies the tree to host memory
    on the calling thread (finished before it returns, so a train step
    that then updates the tensors in place cannot tear the checkpoint) and
    writes it with :func:`save` on a worker thread."""

    def __init__(self, ckpt_dir: Union[str, Path]):
        self.ckpt_dir = Path(ckpt_dir)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        """Block until the in-flight write (if any) finishes.  A worker
        that failed raises its original exception here, exactly once (a
        later ``wait`` is clean); ``save`` calls ``wait`` first, so a
        failure is never skipped by scheduling the next checkpoint."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, *, metadata: Optional[dict] = None) -> None:
        self.wait()
        host_tree = _host_copy(tree)

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, metadata=metadata)
            except BaseException as e:  # surfaced on the next wait()
                e.add_note(f"async checkpoint of step {step} failed")
                # counted when it fails, not at the next wait()
                obs_metrics.get_default().counter(
                    "checkpoint_async_failures_total",
                    "async checkpoint worker failures",
                ).inc()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
