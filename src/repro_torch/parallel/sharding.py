"""Logical-axis sharding rules and placement on a single-controller mesh:
the port of ``repro/parallel/sharding.py``.

The rules are the reference's, name for name (``_leaf_spec``'s table and
its fallbacks, ``REPRO_SSM_TP`` and ``REPRO_SSM_ZERO_FULL`` under the same
names):

* TP over the 'model' mesh axis for head/ff/expert/vocab axes, applied
  only where the axis divides by design (heads % model == 0 ...); else that
  tensor is replicated over 'model' and relies on FSDP;
* FSDP over 'data' (``cfg.fsdp``) on the d_model-like axis;
* a stacked leaf's leading layer axes are never sharded;
* an axis the shape cannot divide is dropped (odd vocabularies fall back
  to replicated embeddings).

Cache rules (decode): batch -> ('pod', 'data') when divisible; kv-heads ->
'model' when divisible, else the sequence axis -> 'model', else
replicated.

The port keeps A5's single controller (``launch/mesh.py``): a mesh is a
named grid of ``torch.device``, a device may repeat, and the host thread
runs every cell's work in cell order.  So a :class:`PartitionSpec` is a
tuple with JAX's equality (a spec shorter than the tensor leaves its
trailing axes unsharded), and a :class:`NamedSharding` places a tensor by
hand: :meth:`NamedSharding.shard` splits it along its spec and puts each
piece on its cell's device (cells that hold the same slice on the same
device share one tensor), :meth:`NamedSharding.gather` rebuilds the whole
tensor on a device.  :func:`place` is ``jax.device_put`` with shardings: a
tensor becomes a :class:`Sharded` (its pieces), a nested dict a dict of
them, a model (``models.lm.LM`` or ``models.encdec.EncDec``) a
:class:`ShardedParams`, whose :meth:`ShardedParams.materialize` gathers
the leaves onto a device at use.

``param_specs`` and the shardings built on it take either a nested dict
of leaves keyed as the reference's tree (anything with ``.shape``; a block
leaf stacked (L, ...) as there) or a model, whose block leaves are one
layer each: the spec of such a leaf is the reference's without the
leading None of its stacked axes.
"""
from __future__ import annotations

import copy
import dataclasses
import os
from typing import TYPE_CHECKING, Any, Callable

import numpy as np
import torch
from torch import nn

if TYPE_CHECKING:
    from ..models.config import ModelConfig

__all__ = [
    "PartitionSpec", "NamedSharding", "Sharded", "ShardedParams", "place", "gather_tree",
    "param_specs", "param_shardings", "opt_state_shardings", "cache_shardings",
    "batch_shardings", "tree_shardings",
]


def _canonical(entry):
    # JAX's: a list is a tuple, a tuple of one name that name, () None
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s counterpart: one entry a leading
    tensor axis, each a mesh axis name, a tuple of names (the axis split
    over their product, the first name major) or None; the axes past the
    spec's length are unsharded.  Entries are canonical as JAX keeps them
    (a one-name tuple is the name), and equality and hashing are the
    tuple's, as JAX's are."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_canonical(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def __reduce__(self):
        return (PartitionSpec, tuple(self))


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A mesh (``launch.mesh.Mesh``) and a :class:`PartitionSpec`: where
    each piece of a tensor lives."""

    mesh: Any
    spec: PartitionSpec

    def __post_init__(self):
        if not isinstance(self.spec, PartitionSpec):
            object.__setattr__(self, "spec", PartitionSpec(*self.spec))
        for entry in self.spec:
            for name in _names(entry):
                if name not in self.mesh.axis_names:
                    raise ValueError(f"{self.spec!r} names {name!r}, not an axis of the "
                                     f"mesh {self.mesh.axis_names!r}")

    def parts(self, ndim: int) -> tuple:
        """The number of pieces along each of ``ndim`` tensor axes."""
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return tuple(int(np.prod([self.mesh.shape[n] for n in _names(e)])) for e in spec)

    def bounds(self, cell: tuple, shape) -> tuple:
        """The slice of a tensor of ``shape`` that ``cell`` (an index into
        the mesh's device grid) holds: one (start, stop) an axis."""
        if len(self.spec) > len(shape):
            raise ValueError(f"{self.spec!r} has more entries than the shape {tuple(shape)}")
        out = []
        for i, n in enumerate(shape):
            entry = self.spec[i] if i < len(self.spec) else None
            pos, size = 0, 1
            for name in _names(entry):
                ax = self.mesh.axis_names.index(name)
                pos = pos * self.mesh.devices.shape[ax] + cell[ax]
                size *= self.mesh.devices.shape[ax]
            if n % size:
                raise ValueError(f"axis {i} of {tuple(shape)} (size {n}) does not divide "
                                 f"into {size} pieces ({self.spec!r})")
            step = n // size
            out.append((pos * step, (pos + 1) * step))
        return tuple(out)

    def cells(self):
        return list(np.ndindex(*self.mesh.devices.shape))

    @torch.no_grad()
    def shard(self, t: torch.Tensor) -> np.ndarray:
        """``t``'s pieces, a grid of the mesh's shape (dtype object): each
        a fresh contiguous copy of the cell's slice on the cell's device;
        cells holding the same slice on the same device share one."""
        grid = np.empty(self.mesh.devices.shape, dtype=object)
        made = {}
        for cell in self.cells():
            dev = self.mesh.devices[cell]
            b = self.bounds(cell, t.shape)
            key = (str(dev), b)
            if key not in made:
                made[key] = t[tuple(slice(*x) for x in b)].to(
                    device=dev, copy=True, memory_format=torch.contiguous_format)
            grid[cell] = made[key]
        return grid

    @torch.no_grad()
    def gather(self, pieces: np.ndarray, device) -> torch.Tensor:
        """The whole tensor on ``device`` from its pieces (each slice
        copied once, in cell order)."""
        first = pieces.flat[0]
        shape = tuple(s * p for s, p in zip(first.shape, self.parts(first.ndim)))
        out = torch.empty(shape, dtype=first.dtype, device=device)
        done = set()
        for cell in self.cells():
            b = self.bounds(cell, shape)
            if b not in done:
                out[tuple(slice(*x) for x in b)].copy_(pieces[cell])
                done.add(b)
        return out


class Sharded:
    """A tensor placed on a mesh: its :class:`NamedSharding`, global shape
    and dtype, and ``pieces`` (a grid of the mesh's shape, see
    :meth:`NamedSharding.shard`)."""

    __slots__ = ("sharding", "shape", "dtype", "pieces")

    def __init__(self, t: torch.Tensor, sharding: NamedSharding):
        self.sharding = sharding
        self.shape = tuple(t.shape)
        self.dtype = t.dtype
        self.pieces = sharding.shard(t)

    @property
    def mesh(self):
        return self.sharding.mesh

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    def piece(self, cell: tuple) -> torch.Tensor:
        return self.pieces[cell]

    def unique(self) -> list:
        """[(bounds, piece)] of every distinct piece tensor, in cell order
        (a slice held on several devices appears once per device)."""
        seen, out = set(), []
        for cell in self.sharding.cells():
            t = self.pieces[cell]
            if id(t) not in seen:
                seen.add(id(t))
                out.append((self.sharding.bounds(cell, self.shape), t))
        return out

    def gather(self, device) -> torch.Tensor:
        return self.sharding.gather(self.pieces, device)

    @torch.no_grad()
    def assign_(self, t: torch.Tensor) -> "Sharded":
        """Write the whole tensor ``t`` into the pieces, in place."""
        if tuple(t.shape) != self.shape:
            raise ValueError(f"cannot write {tuple(t.shape)} into a {self.shape} tensor")
        for b, piece in self.unique():
            piece.copy_(t[tuple(slice(*x) for x in b)])
        return self

    @property
    def nbytes(self) -> int:
        """Bytes the pieces hold, every device's copy counted."""
        return sum(p.numel() * p.element_size() for _, p in self.unique())



def _param_owner(model: nn.Module, name: str):
    """(the module that holds parameter ``name``, its attribute)."""
    prefix, _, attr = name.rpartition(".")
    return (model.get_submodule(prefix) if prefix else model), attr


class ShardedParams:
    """A model's parameters (``models.lm.LM`` or ``models.encdec.EncDec``)
    as pieces on a mesh: ``leaves`` maps each name of
    ``models.lm.leaves(model)`` to its :class:`Sharded`, ``skeleton`` is the
    model with every parameter on the ``meta`` device (its structure, no
    storage).  :meth:`materialize` gathers the leaves onto one device at
    use; the sharded steps of ``launch/steps.py`` drive it."""

    def __init__(self, model: nn.Module, shardings: dict):
        from ..models import lm

        named = lm.leaves(model)
        missing = set(named) - set(shardings)
        if missing:
            raise KeyError(f"no sharding for {sorted(missing)[:4]}")
        memo = {id(p): nn.Parameter(torch.empty_like(p, device="meta"), requires_grad=False)
                for p in model.parameters()}
        self.skeleton = copy.deepcopy(model, memo)
        self.leaves = {name: Sharded(t.detach(), shardings[name]) for name, t in named.items()}
        self.ndims = lm.ref_ndims(model)

    @property
    def cfg(self) -> ModelConfig:
        return self.skeleton.cfg

    @property
    def mesh(self):
        return next(iter(self.leaves.values())).mesh

    @property
    def device(self) -> torch.device:
        """The device a whole-batch call under the mesh runs on: the
        mesh's first cell's."""
        return self.mesh.devices.flat[0]

    def shardings(self) -> dict:
        return {k: v.sharding for k, v in self.leaves.items()}

    @property
    def nbytes(self) -> int:
        return sum(v.nbytes for v in self.leaves.values())

    def empty(self, device) -> nn.Module:
        """The model on ``device`` with uninitialized storage (a restore
        writes every leaf)."""
        return copy.deepcopy(self.skeleton).to_empty(device=device)

    def materialize(self, device, *, keep: Callable[[str], bool] = lambda name: False,
                    requires_grad: bool = False) -> nn.Module:
        """The model on ``device``, every leaf gathered there (a fresh
        parameter, ``requires_grad`` as asked), except the leaves ``keep``
        names: those stay :class:`Sharded`, in a plain dict where their
        parameter dict was."""
        m = copy.deepcopy(self.skeleton)
        kept = {}
        for name, sh in self.leaves.items():
            owner, attr = _param_owner(m, name)
            if keep(name):
                kept.setdefault(name.rpartition(".")[0], {})[attr] = sh
                continue
            owner._parameters[attr] = nn.Parameter(sh.gather(device),
                                                   requires_grad=requires_grad)
        for prefix, leaves in kept.items():
            parent, attr = _param_owner(m, prefix)
            pdict = parent._modules.pop(attr)
            object.__setattr__(parent, attr, {**dict(pdict.items()), **leaves})
        return m


def place(tree, shardings):
    """``jax.device_put(tree, shardings)``: a tensor and a
    :class:`NamedSharding` give a :class:`Sharded`; a nested dict and a
    dict of shardings of the same keys, the dict of the placed leaves; a
    model and ``param_shardings(model, ...)``, a :class:`ShardedParams`."""
    if isinstance(tree, nn.Module):
        return ShardedParams(tree, shardings)
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        tree = tree.gather(tree.pieces.flat[0].device)
    return Sharded(tree, shardings)


def gather_tree(tree, device):
    """Every :class:`Sharded` leaf of a nested dict gathered onto
    ``device`` (other leaves as they are)."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, device) for k, v in tree.items()}
    return tree.gather(device) if isinstance(tree, Sharded) else tree


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------


def _axsize(mesh, name: str) -> int:
    return mesh.shape[name]


def _div(n: int, k: int) -> bool:
    return n % k == 0


def _leaf_spec(path_names, shape, cfg: ModelConfig, mesh, serving: bool = False):
    """The reference's ``_leaf_spec``: the base spec of one parameter's
    trailing axes from its name (and its parent's), leading stack axes
    None, every axis the shape cannot divide dropped.  ``serving=True``
    places SSM weights tensor-parallel."""
    name = path_names[-1]
    parent = path_names[-2] if len(path_names) > 1 else ""
    msize = _axsize(mesh, "model")
    F = "data" if cfg.fsdp else None  # fsdp axis

    H, K = cfg.n_heads, cfg.n_kv_heads
    heads_tp = _div(H, msize) and _div(K, msize)
    # sequence-sharded SSM activations with replicated (FSDP-only) mamba
    # weights: tensor-parallel SSM weights only when serving, when
    # sequence parallelism is off, or under REPRO_SSM_TP=1
    ssm_tp = bool(
        (serving or not cfg.ssm_seq_parallel
         or os.environ.get("REPRO_SSM_TP") == "1")
        and cfg.ssm_heads
        and _div(cfg.ssm_heads, msize)
        and _div(cfg.d_inner, msize)
    )
    ff_tp = _div(cfg.d_ff, msize) if cfg.d_ff else False
    Mh = "model" if heads_tp else None
    Ms = "model" if ssm_tp else None
    Ms_dt = Ms  # dt/A/D are per-head vectors; sharded iff heads are
    Mf = "model" if ff_tp else None
    # REPRO_SSM_ZERO_FULL=1 folds 'model' into the FSDP axis of the
    # model-replicated SSM weights (ZeRO over the full mesh)
    ssm_zero_full = (
        os.environ.get("REPRO_SSM_ZERO_FULL") == "1"
        and cfg.ssm_seq_parallel and not ssm_tp and cfg.fsdp
    )
    Fs = ("data", "model") if ssm_zero_full else F    # input-dim axis
    Fs2 = ("data", "model") if ssm_zero_full else F   # output-dim axis (out_proj)

    table = {
        # embeddings / head
        "tok_emb": ("model", F),
        "lm_head": ("model", F),
        "dec_pos": (None, None),
        # attention
        "wq": (F, Mh), "wk": (F, Mh), "wv": (F, Mh),
        "bq": (Mh,), "bk": (Mh,), "bv": (Mh,),
        "wo": (Mh, F),
        # MLA
        "wq_a": (F, None), "wq_b": (None, Mh),
        "wkv_a": (F, None), "wkv_b": (None, Mh),
        "q_ln": (None,), "kv_ln": (None,),
        # dense MLP (parent 'mlp') vs expert MLP (parent 'moe', E leading)
        "wg": ("model", F, None) if parent == "moe" else (F, Mf),
        "wu": ("model", F, None) if parent == "moe" else (F, Mf),
        "wd": ("model", None, F) if parent == "moe" else (Mf, F),
        "w1": (F, Mf), "b1": (Mf,), "w2": (Mf, F), "b2": (None,),
        "router": (None, None),
        "shared_wg": (F, Mf or None), "shared_wu": (F, Mf or None),
        "shared_wd": (Mf or None, F),
        # mamba (the B/C projections stay replicated: 2gn channels, and every
        # head shard needs all of them)
        "in_z": (Fs, Ms), "in_x": (Fs, Ms), "in_BC": (Fs, None), "in_dt": (Fs, Ms_dt),
        "conv_x_w": (None, Ms), "conv_x_b": (Ms,),
        "conv_BC_w": (None, None), "conv_BC_b": (None,),
        "A_log": (Ms_dt,), "D": (Ms_dt,), "dt_bias": (Ms_dt,),
        "norm_w": (Ms,), "out_proj": (Ms, Fs2),
        # norms / gates / mtp
        "ln1": (None,), "ln2": (None,), "ln3": (None,),
        "final_norm": (None,), "w": (None,), "b": (None,),
        "gate_attn": (None,), "gate_mlp": (None,),
        "mtp_proj": (F, None), "mtp_norm_h": (None,), "mtp_norm_e": (None,),
    }
    if name not in table:
        raise KeyError(f"no sharding rule for param {'/'.join(path_names)}")
    base = table[name]
    # shared experts: ff width = n_shared * d_expert; check divisibility
    if name.startswith("shared_w"):
        fs = cfg.n_shared_experts * cfg.d_expert
        if not _div(fs, msize):
            base = tuple(None if a == "model" else a for a in base)
    # expert tensors: expert-parallel only when E % model == 0
    if parent == "moe" and name in ("wg", "wu", "wd") and not _div(cfg.n_experts, msize):
        base = tuple(None if a == "model" else a for a in base)
    n_lead = len(shape) - len(base)
    assert n_lead >= 0, (path_names, tuple(shape), base)
    final = []
    for i, a in enumerate((None,) * n_lead + tuple(base)):
        if a is None:
            final.append(None)
            continue
        size = int(np.prod([_axsize(mesh, x) for x in _names(a)]))
        final.append(a if _div(shape[i], size) else None)
    return PartitionSpec(*final)


def _flat_paths(tree, prefix=()) -> list:
    """[(key path, leaf)] of a nested dict, keys sorted (``jax.tree_util``'s
    order)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flat_paths(tree[k], prefix + (str(k),))
        return out
    return [(prefix, tree)]


def _nest(flat: list) -> dict:
    tree: dict = {}
    for path, leaf in flat:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def param_specs(params, cfg: ModelConfig, mesh, serving: bool = False) -> dict:
    """The :class:`PartitionSpec` of every parameter: for a nested dict of
    leaves (anything with ``.shape``, keyed as the reference's tree) the
    same nested dict of specs; for a model, ``{leaf name: spec}`` in
    ``models.lm.leaves``' order, each leaf one layer."""
    if isinstance(params, nn.Module):
        from ..models import lm

        named = dict(params.named_parameters())
        return {name: _leaf_spec(path, tuple(named[name].shape), cfg, mesh, serving)
                for name, path, _ in lm.leaf_paths(params)}
    return _nest([(path, _leaf_spec(path, tuple(leaf.shape), cfg, mesh, serving))
                  for path, leaf in _flat_paths(params)])


def _map_specs(specs, fn):
    if isinstance(specs, dict):
        return {k: _map_specs(v, fn) for k, v in specs.items()}
    return fn(specs)


def param_shardings(params, cfg: ModelConfig, mesh, serving: bool = False) -> dict:
    return _map_specs(param_specs(params, cfg, mesh, serving=serving),
                      lambda s: NamedSharding(mesh, s))


def opt_state_shardings(opt_state, params, cfg: ModelConfig, mesh) -> dict:
    """AdamW's moments inherit the parameter sharding; ``step`` is
    replicated."""
    mu = _map_specs(param_specs(params, cfg, mesh),
                    lambda s: {"m": NamedSharding(mesh, s), "v": NamedSharding(mesh, s)})
    return {"mu": mu, "step": NamedSharding(mesh, PartitionSpec())}


# ---------------------------------------------------------------------------
# Activations / batches / caches
# ---------------------------------------------------------------------------


def _dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def batch_shardings(batch, mesh) -> dict:
    """tokens / frames / img: the batch axis over (pod, data); scalars, and
    a batch axis the dp size does not divide, replicated."""
    dp = _dp_axes(mesh)
    dp_size = int(np.prod([mesh.shape[a] for a in dp]))

    def spec(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape or not _div(shape[0], dp_size):
            return NamedSharding(mesh, PartitionSpec())
        return NamedSharding(mesh, PartitionSpec(dp, *(None,) * (len(shape) - 1)))

    return _map_specs(batch, spec)


_KV = ("k", "v", "attn_k", "attn_v", "self_k", "self_v", "cross_k", "cross_v", "img_k",
       "img_v")


def cache_shardings(cache, cfg: ModelConfig, mesh) -> dict:
    """Decode caches: batch over (pod, data); then kv-heads over model when
    divisible, else the sequence axis over model (distributed attention),
    else replicated.  Layouts (``models.*.init_cache``): attention k/v
    (..., B, S, K, Dh), the MLA latent (..., B, S, width), SSM conv / state
    (..., B, K - 1, ch) / (..., B, h, p, n); identified by name."""
    dp = _dp_axes(mesh)
    dp_size = int(np.prod([mesh.shape[a] for a in dp]))
    msize = _axsize(mesh, "model")

    def one(path, leaf):
        name = path[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        if name in _KV:                            # (..., B, S, K, Dh)
            bax, sax, kax = nd - 4, nd - 3, nd - 2
            if _div(shape[bax], dp_size):
                spec[bax] = dp
            if _div(shape[kax], msize):
                spec[kax] = "model"
            elif _div(shape[sax], msize):
                spec[sax] = "model"
        elif name.startswith("latent"):
            bax, sax = nd - 3, nd - 2
            if _div(shape[bax], dp_size):
                spec[bax] = dp
            if _div(shape[sax], msize):
                spec[sax] = "model"
        elif name.startswith("conv"):
            bax, cax = nd - 3, nd - 1
            if _div(shape[bax], dp_size):
                spec[bax] = dp
            if _div(shape[cax], msize):
                spec[cax] = "model"
        elif name.startswith("ssm"):
            bax, hax = nd - 4, nd - 3
            if _div(shape[bax], dp_size):
                spec[bax] = dp
            if _div(shape[hax], msize):
                spec[hax] = "model"
        return NamedSharding(mesh, PartitionSpec(*spec))

    return _nest([(path, one(path, leaf)) for path, leaf in _flat_paths(cache)])


def tree_shardings(tree, mesh, spec=PartitionSpec()) -> dict:
    return _map_specs(tree, lambda _: NamedSharding(mesh, spec))
