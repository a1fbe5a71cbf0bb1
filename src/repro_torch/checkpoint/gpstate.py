"""Versioned, spec-validated (de)serialization of fitted GP sessions.

Counterpart of ``repro/checkpoint/gpstate.py``, writing the same format
(``FORMAT``/``FORMAT_VERSION``, manifest keys, leaf names and the omega
sha256), so a session saved by either package loads in the other with
bitwise-equal leaves.  A fitted session (an
:class:`~repro_torch.core.fagp.FAGPState` or a
:class:`~repro_torch.core.vecchia.VecchiaState`) is written through the
atomic store (:mod:`repro_torch.checkpoint.store`) with a manifest
carrying the spec's structure (approximation family, expansion,
truncation, a sha256 of any RFF spectral draws, the Vecchia kernel and
neighbour count), so a restore into an incompatible spec raises like
``with_spec`` does.

Layout per version: ``<dir>/step_<version>/{arrays.npz, manifest.json}``
with the tree ``{"leaves": {...}, "hypers": {eps, rho, noise}, "omega"?,
"train": {Phi, y}?, "extra": {...}?}``, the leaves each family's own
(FAGP: lam, sqrtlam, chol, u, b; Vecchia: X, y).
``save_state`` auto-increments the version; ``extra`` arrays (the cold
tier's sliding-window buffers) ride beside the session and come back from
:func:`load_state` as numpy arrays.  The manifest records no device:
:func:`load_state` places the session on the device it is given.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Optional, Union

import numpy as np

from ..core import fagp
from ..core.approximation import get_approximation
from ..core.fagp import FAGPState, GPSpec
from ..device import resolve_device
from . import store

__all__ = ["save_state", "load_state", "latest_version", "spec_manifest",
           "omega_hash", "FORMAT", "FORMAT_VERSION"]

FORMAT = "repro.gpstate"
FORMAT_VERSION = 1

# manifest keys added with the approximation protocol; manifests written
# before it lack them and load with these defaults (an "fagp" checkpoint)
_SPEC_MANIFEST_DEFAULTS = {"approximation": "fagp", "kernel": None, "neighbors": None}


def omega_hash(omega) -> Optional[str]:
    """sha256 over the RFF spectral draws (shape + float32 payload); None
    for deterministic expansions."""
    if omega is None:
        return None
    if hasattr(omega, "detach"):
        omega = omega.detach().cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(omega, np.float32))
    h = hashlib.sha256()
    h.update(repr(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def spec_manifest(spec: GPSpec) -> dict:
    """The JSON-safe structure of a spec: everything but the
    hyperparameter tensors (those are leaves in the npz)."""
    return {
        "approximation": spec.approximation,
        "expansion": spec.expansion,
        "n": int(spec.n),
        "index_set": spec.index_set,
        "degree": None if spec.degree is None else int(spec.degree),
        "block_rows": int(spec.block_rows),
        "store_train": bool(spec.store_train),
        "backend": spec.backend,
        "omega_sha256": omega_hash(spec.omega),
        "kernel": spec.kernel,
        "neighbors": None if spec.neighbors is None else int(spec.neighbors),
    }


def _check_compatible(meta: dict, spec: GPSpec) -> None:
    """Raise unless the checkpoint's structural manifest matches ``spec``:
    the serialized mirror of the ``with_spec`` check."""
    ms = meta["spec"]
    for f in fagp._STRUCTURAL_FIELDS:
        have = ms.get(f, _SPEC_MANIFEST_DEFAULTS[f]) if f in _SPEC_MANIFEST_DEFAULTS else ms[f]
        want = getattr(spec, f)
        if have != want:
            raise ValueError(
                f"load_state: checkpoint/spec mismatch: checkpoint was saved "
                f"with {f}={have!r} but the target spec has {f}={want!r}; "
                f"structural choices are frozen into the factorization — "
                f"refit instead of restoring"
            )
    if ms["omega_sha256"] != omega_hash(spec.omega):
        raise ValueError(
            f"load_state: checkpoint/spec mismatch: the RFF spectral draws "
            f"(omega) differ from the target spec's; the base frequencies "
            f"are structural — refit under the target draws"
        )


def save_state(
    ckpt_dir: Union[str, Path],
    state: FAGPState,
    *,
    step: Optional[int] = None,
    extra: Optional[dict] = None,
) -> int:
    """Serialize one fitted session; returns the version written.
    ``step=None`` auto-increments past the directory's latest version.
    ``extra`` is an optional dict of arrays stored beside the state and
    returned verbatim by :func:`load_state`."""
    spec = state.spec
    ap = get_approximation(spec.approximation)
    if step is None:
        last = store.latest_step(ckpt_dir)
        step = 0 if last is None else last + 1
    tree = {
        "leaves": ap.ckpt_leaves(state),
        "hypers": {"eps": spec.eps, "rho": spec.rho, "noise": spec.noise},
    }
    if spec.omega is not None:
        tree["omega"] = spec.omega
    has_train = getattr(state, "Phi", None) is not None and state.y is not None
    if has_train:
        tree["train"] = {"Phi": state.Phi, "y": state.y}
    extra = dict(extra or {})
    if extra:
        tree["extra"] = extra
    meta = {
        "format": FORMAT,
        "format_version": FORMAT_VERSION,
        "spec": spec_manifest(spec),
        "p": int(spec.p),
        "has_train": bool(has_train),
        "extra_keys": sorted(extra),
        **ap.ckpt_meta(state),
    }
    store.save(ckpt_dir, step, tree, metadata=meta)
    return step


def _read_manifest(ckpt_dir: Path, step: int) -> dict:
    d = ckpt_dir / f"step_{step:010d}"
    if not d.is_dir():
        raise FileNotFoundError(f"no checkpoint version {step} under {ckpt_dir}")
    return json.loads((d / "manifest.json").read_text())


def load_state(
    ckpt_dir: Union[str, Path],
    *,
    step: Optional[int] = None,
    like_spec: Optional[GPSpec] = None,
    require_hypers_match: bool = False,
    device=None,
) -> tuple:
    """Restore one session onto ``device`` (default ``"cuda"``; raises
    without a card); returns ``(version, state, extra)``, ``extra`` the
    dict of numpy arrays saved beside the state (empty when none).

    The spec is rebuilt from the manifest and the saved hyperparameter
    leaves, omega included: a bit-exact round trip.  ``like_spec``
    validates the checkpoint's structure (omega included) against a target
    spec before any array loads; ``require_hypers_match=True`` also
    requires the saved eps/rho/noise to equal the target's (``GP.load``
    and homogeneous-bank admission; a heterogeneous bank leaves it off)."""
    dev = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = store.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    meta = _read_manifest(ckpt_dir, step)["metadata"]
    if meta.get("format") != FORMAT:
        raise ValueError(
            f"{ckpt_dir} step {step} is not a {FORMAT} checkpoint "
            f"(format={meta.get('format')!r})"
        )
    ms = meta["spec"]
    if like_spec is not None:
        _check_compatible(meta, like_spec)
    ap = get_approximation(ms.get("approximation", _SPEC_MANIFEST_DEFAULTS["approximation"]))

    # a like-tree with the manifest's structure; shapes come from the npz
    like: dict = {
        "leaves": {f: 0 for f in ap.ckpt_leaf_names()},
        "hypers": {"eps": 0, "rho": 0, "noise": 0},
    }
    if ms["omega_sha256"] is not None:
        like["omega"] = 0
    if meta["has_train"]:
        like["train"] = {"Phi": 0, "y": 0}
    extra_keys = meta.get("extra_keys", [])
    if extra_keys:
        like["extra"] = {k: 0 for k in extra_keys}
    _, tree = store.restore(ckpt_dir, like, step=step, device=dev,
                            host=("extra",))

    hypers = tree["hypers"]
    spec = GPSpec(
        eps=hypers["eps"], rho=hypers["rho"], noise=hypers["noise"], n=ms["n"],
        index_set=ms["index_set"], degree=ms["degree"],
        block_rows=ms["block_rows"], store_train=ms["store_train"],
        backend=ms["backend"], expansion=ms["expansion"],
        omega=tree.get("omega"), approximation=ap.name,
        kernel=ms.get("kernel", _SPEC_MANIFEST_DEFAULTS["kernel"]),
        neighbors=ms.get("neighbors", _SPEC_MANIFEST_DEFAULTS["neighbors"]),
    )
    if like_spec is not None and require_hypers_match:
        for f in fagp._HYPER_FIELDS:
            if not fagp._leaf_equal(getattr(spec, f), getattr(like_spec, f)):
                raise ValueError(
                    f"load_state: checkpoint hyperparameter {f} differs "
                    f"from the target spec's; the target shares one "
                    f"feature map and eigenvalue scaling — refit the "
                    f"session under it"
                )
    state = ap.ckpt_rebuild(spec, tree["leaves"], tree.get("train"))
    extra = {k: v.numpy() for k, v in tree.get("extra", {}).items()}
    return step, state, extra


def latest_version(ckpt_dir: Union[str, Path]) -> Optional[int]:
    """The newest saved version under ``ckpt_dir`` (None when empty)."""
    return store.latest_step(ckpt_dir)
