"""Bank-axis sharding: one GPBank fleet spread over the devices of a mesh.

Counterpart of ``repro/bank/sharded.py``.  Every slot of a bank owns an
independent (chol, u, b) factorization, so the capacity axis splits over
a mesh's 'bank' axis with no cross-shard work on the serving path.

Design:

  * ``ShardedGPBank`` has ``GPBank``'s public surface (fit / mean_var /
    update / downdate / refit_window / insert / evict / state ...), so
    ``BankRouter``, ``FleetEngine`` and ``TieredBank`` drive either.  Slots
    are GLOBAL ids: shard ``slot // shard_capacity`` owns local slot
    ``slot % shard_capacity``.
  * Each shard is a resident :class:`~repro_torch.bank.GPBank` of capacity
    C / S on its mesh device (the JAX package's ``shard_map`` bodies reuse
    the resident cores the same way), so the shard-local math keeps its one
    home: ``GPBank``'s entries, kernels and B^{-1} cache.  The host thread
    drives the shards one after another (a single controller, as the JAX
    program is); shards on distinct cards run their queues at once.
  * This module does the placement, the global <-> local slot map and the
    per-shard packing: a mixed-shard batch is split by shard and each
    shard's part padded to its OWN power-of-two rung, so a hot shard never
    pads the others and each shard sees O(log capacity) shapes.  Serving
    returns results in packed per-shard order with the position map; the
    engine puts them back in row order when it harvests.
  * The serving B^{-1} cache is kept eagerly: every shard is built with its
    cache, and every mutation carries it with the touched rows refreshed.
  * A 2-D ``(bank, data)`` mesh also splits each bank shard's fit rows over
    'data': each cell's moments (one bank fused-fit launch per cell on the
    ``pallas`` backend) are summed in cell order on the shard's lead
    device, the counterpart of the JAX fit's one ``psum``; serving stays
    bank-only.

Homogeneous banks only: per-slot hyperparameter overlays
(:meth:`GPBank.optimize`) have no shard-local serving path yet; convert with
:meth:`ShardedGPBank.to_bank` first.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Hashable, Mapping, Optional, Sequence

import numpy as np
import torch

from ..core import fagp
from ..core.expansions import get_expansion
from ..core.fagp import FAGPState, GPSpec, _f32
from ..core.gp import GP
from ..core.shardspec import spec_local
from ..obs.watchdog import shape_tracked
from .bank import (
    _LEAVES,
    GPBank,
    _as_mask,
    _bank_solve,
    _bank_spec,
    _check_bankable,
    _check_batch,
    _prior_leaves,
    _scatter,
    _to_device,
)

__all__ = ["ShardedGPBank"]


def _pow2(n: int) -> int:
    return 1 << (max(1, int(n)) - 1).bit_length()


# ---------------------------------------------------------------------------
# host-side per-shard grouping (the padding policy in one place)
# ---------------------------------------------------------------------------


def _group_rows(gslots: np.ndarray, C_l: int, S: int):
    """Pack a mixed-shard query batch by shard, each shard's rows padded to
    its own power-of-two rung by repeating its last row (results
    discarded).  Returns ``(groups, pos)``: one ``(shard, rows, lslots)``
    per shard touched, in shard order (``rows`` the padded batch rows it
    answers, ``lslots`` their local slots), and ``pos`` (n,), where row i's
    result lands in the shards' results concatenated."""
    shard = gslots // C_l
    order = np.argsort(shard, kind="stable")
    counts = np.bincount(shard, minlength=S)
    pos = np.empty(len(gslots), np.int64)
    groups, start, off = [], 0, 0
    for s in np.flatnonzero(counts):
        n = int(counts[s])
        Q = _pow2(n)
        rows = np.empty(Q, np.int64)
        rows[:n] = order[start:start + n]
        rows[n:] = rows[n - 1]
        pos[rows[:n]] = off + np.arange(n)
        groups.append((int(s), rows, gslots[rows] - s * C_l))
        start += n
        off += Q
    return groups, pos


def _group_slots(gslots: np.ndarray, C_l: int):
    """Per-shard grouping for the scatter ops (update, downdate, refit): one
    ``(shard, idx, lslots)`` per shard touched, ``idx`` the caller's groups
    aimed at it and ``lslots`` their local slots, padded to the shard's
    power-of-two rung (at most its capacity) with the lowest local slots no
    real group targets.  A padding group is fully masked: it leaves its
    slot untouched."""
    shard = gslots // C_l
    out = []
    for s in np.unique(shard):
        idx = np.flatnonzero(shard == s)
        real = gslots[idx] - s * C_l
        used = set(real.tolist())
        fill = [slot for slot in range(C_l) if slot not in used]
        fill = fill[:min(C_l, _pow2(len(idx))) - len(idx)]
        out.append((int(s), idx, np.concatenate([real, np.asarray(fill, np.int64)])))
    return out


# ---------------------------------------------------------------------------
# shard-local steps (shape-tracked: the watchdog's bank_shard_* names)
# ---------------------------------------------------------------------------


@shape_tracked
def _sh_binv(chol: torch.Tensor) -> torch.Tensor:
    """A shard's B^{-1} cache from its stacked factors."""
    return fagp._bank_binv(chol)


@shape_tracked
def _sh_mean_var(serve, stack: FAGPState, binv, lslots, Xq):
    """One shard's part of a mixed-tenant query batch: its packed rows
    against its local slots, on its device."""
    return serve(stack, binv, lslots, Xq)


@shape_tracked
def _sh_update_scatter(shard: GPBank, lslots, Xg, yg, mg, donate: bool) -> GPBank:
    return shard._update_at_slots(lslots, Xg, yg, mg, donate=donate)


@shape_tracked
def _sh_downdate_scatter(shard: GPBank, lslots, Xg, yg, mg):
    return shard._downdate_at_slots(lslots, Xg, yg, mg)


@shape_tracked
def _sh_refit_scatter(shard: GPBank, lslots, Xg, yg, mg) -> GPBank:
    return shard._refit_at_slots(lslots, Xg, yg, mg)


@shape_tracked
def _sh_write_slot(stack: FAGPState, lslot: int, values: dict) -> dict:
    """A shard's leaves with one tenant's ``values`` (on any device)
    written at ``lslot``."""
    return {f: _scatter(getattr(stack, f), lslot, values[f]) for f in _LEAVES}


@shape_tracked
def _sh_read_slot(stack: FAGPState, lslot: int) -> dict:
    """One slot's leaves, read from a shard (``rebalance``'s move)."""
    return {f: getattr(stack, f)[lslot] for f in _LEAVES}


# ---------------------------------------------------------------------------
# the sharded bank
# ---------------------------------------------------------------------------


def _with_binv(shard: GPBank) -> GPBank:
    """``shard`` with its B^{-1} cache formed (the eager cache)."""
    object.__setattr__(shard, "_binv_cache", _sh_binv(shard.stack.chol))
    return shard


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedGPBank:
    """A :class:`GPBank` whose capacity axis is split over a mesh's 'bank'
    axis (see module doc).

    shards: one resident ``GPBank`` per 'bank' index, of capacity C / S, on
            the mesh's device for that index (its lead device: 'data' cell
            0); its ``slots`` map tenants to LOCAL slots.
    mesh:   the :class:`~repro_torch.launch.mesh.Mesh` (first axis 'bank';
            the other axes split fit rows only).
    slots:  tenant -> GLOBAL slot (shard = slot // shard_capacity).
    hypers: always None: a sharded bank is homogeneous.
    """

    shards: tuple
    mesh: Any
    slots: Mapping[Hashable, int]
    hypers: Optional[Any] = None

    def __post_init__(self):
        if self.hypers is not None:
            raise ValueError(
                "ShardedGPBank is homogeneous-only: per-slot hyperparameter"
                " overlays (GPBank.optimize) have no shard-local serving "
                "path yet — convert with to_bank() first"
            )

    # -- constructors -------------------------------------------------------

    @staticmethod
    def _check_capacity(capacity: int, mesh) -> int:
        S = int(mesh.shape.get("bank", 0))
        if S < 1:
            raise ValueError(f"mesh needs a 'bank' axis; got {mesh.axis_names!r}")
        if capacity < 1 or capacity % S:
            raise ValueError(
                f"capacity must be a positive multiple of the bank axis "
                f"size {S}, got {capacity}"
            )
        return int(capacity)

    @staticmethod
    def _shard_devices(mesh) -> list:
        """Each bank shard's devices: its lead device first, then the rest of
        its 'data' cells."""
        return [list(row.reshape(-1)) for row in mesh.devices]

    @classmethod
    def create(cls, spec: GPSpec, capacity: int, mesh) -> "ShardedGPBank":
        """An empty sharded bank: every slot holds the prior state."""
        C_l = cls._check_capacity(capacity, mesh) // int(mesh.shape["bank"])
        shards = tuple(_with_binv(GPBank.create(spec_local(spec, devs[0]), C_l))
                       for devs in cls._shard_devices(mesh))
        return cls(shards=shards, mesh=mesh, slots={})

    @classmethod
    def fit(
        cls,
        Xb,
        yb,
        spec: GPSpec,
        mesh,
        *,
        mask=None,
        tenant_ids: Optional[Sequence[Hashable]] = None,
        capacity: Optional[int] = None,
    ) -> "ShardedGPBank":
        """Fit B independent GPs, sharded (same data contract as
        :meth:`GPBank.fit`).  Tenants place round-robin (tenant i -> shard
        i mod S), packed from each shard's lowest local slot; reserved
        capacity holds the prior leaves.  Each shard's moments come from one
        ``bank_moments`` call per 'data' cell (one bank fused-fit launch on
        ``pallas``), summed in cell order on the shard's lead device."""
        Xb, yb = _f32(Xb, None), _f32(yb, None)
        if Xb.ndim != 3 or yb.ndim != 2 or tuple(yb.shape) != tuple(Xb.shape[:2]):
            raise ValueError(
                f"ShardedGPBank.fit wants Xb (B, N, p) and yb (B, N); got "
                f"{tuple(Xb.shape)} and {tuple(yb.shape)}"
            )
        B, N, p = Xb.shape
        S = int(mesh.shape["bank"])
        cap = cls._check_capacity(-(-B // S) * S if capacity is None else int(capacity), mesh)
        if cap < B:
            raise ValueError(f"capacity {cap} < number of tenants {B}")
        C_l = cap // S
        tenant_ids = list(range(B) if tenant_ids is None else tenant_ids)
        if len(tenant_ids) != B or len(set(tenant_ids)) != B:
            raise ValueError(f"tenant_ids must be {B} distinct ids, got {tenant_ids!r}")
        spec = _bank_spec(spec)
        fagp._check_p(spec, p)
        backend = fagp._check_backend_support(spec)
        mask = _as_mask(mask, (B, N), Xb.device, "ShardedGPBank.fit")
        idx = fagp._idx_tensor(spec, p)
        exp = get_expansion(spec.expansion)
        shards = []
        for s, devs in enumerate(cls._shard_devices(mesh)):
            lead = devs[0]
            sp, idx_s = spec_local(spec, lead), idx.to(lead)
            mine = np.arange(s, B, S)
            loglam = exp.log_eigenvalues(idx_s, sp)
            leaves = _prior_leaves(loglam, C_l - len(mine))
            if len(mine):
                G, b = cls._moments(Xb, yb, mask, mine, devs, spec, idx, backend)
                lam, sqrtlam, chol, u = _bank_solve(G, b, loglam, sp.noise**2)
                del G
                fitted = dict(lam=lam, sqrtlam=sqrtlam, chol=chol, u=u, b=b)
                # reserved slots take the prior leaves, never a moment pass
                leaves = {f: torch.cat([v, leaves[f]]) for f, v in fitted.items()}
            active = np.zeros(C_l, bool)
            active[:len(mine)] = True
            shards.append(_with_binv(GPBank(stack=FAGPState(idx=idx_s, spec=sp, **leaves),
                                            active=active,
                                            slots={tenant_ids[i]: i // S for i in mine})))
        # round-robin placement: tenant i -> global slot (i % S) C_l + i // S
        return cls(shards=tuple(shards), mesh=mesh,
                   slots={t: (i % S) * C_l + i // S for i, t in enumerate(tenant_ids)})

    @staticmethod
    def _moments(Xb, yb, mask, mine, devs, spec, idx, backend):
        """The raw moments (G, b) of tenants ``mine``, their rows split over
        the shard's 'data' cells ``devs`` (N padded to a multiple of the
        cells, the pad rows masked), summed in cell order on ``devs[0]``."""
        D = len(devs)
        N = Xb.shape[1]
        N_l = -(-N // D)
        sel = torch.from_numpy(mine).to(Xb.device)
        Xs, ys, ms = Xb[sel], yb[sel], mask[sel]
        if N_l * D != N:
            pad = N_l * D - N
            Xs = torch.cat([Xs, Xs.new_zeros((len(mine), pad, Xs.shape[2]))], dim=1)
            ys = torch.cat([ys, ys.new_zeros((len(mine), pad))], dim=1)
            ms = torch.cat([ms, ms.new_zeros((len(mine), pad))], dim=1)
        block_rows = min(spec.block_rows, max(1, N_l))
        parts = []
        for j, dev in enumerate(devs):
            rows = slice(j * N_l, (j + 1) * N_l)
            parts.append(backend.bank_moments(
                Xs[:, rows].to(dev).contiguous(), ys[:, rows].to(dev).contiguous(),
                spec_local(spec, dev), idx.to(dev), block_rows,
                ms[:, rows].to(dev).contiguous()))
        G, b = parts[0]
        for G_j, b_j in parts[1:]:
            G += G_j.to(G.device)
            b += b_j.to(b.device)
        return G, b

    @classmethod
    def from_bank(cls, bank: GPBank, mesh, *, pad_capacity: bool = False) -> "ShardedGPBank":
        """Shard a resident bank: slots keep their global ids (shard =
        slot // shard_capacity), each shard's leaves copied to its device.
        ``pad_capacity`` rounds the capacity up to a multiple of the shard
        count with prior slots instead of raising."""
        if bank.hypers is not None:
            raise ValueError(
                "cannot shard a heterogeneous bank (per-slot overlays have "
                "no shard-local serving path yet)"
            )
        bank._check_live()
        S = int(mesh.shape.get("bank", 0))
        cap = bank.capacity
        if S >= 1 and cap % S and pad_capacity:
            cap = -(-cap // S) * S
        C_l = cls._check_capacity(cap, mesh) // S
        st = bank.stack
        leaves = {f: getattr(st, f) for f in _LEAVES}
        if cap > bank.capacity:
            loglam = get_expansion(bank.spec.expansion).log_eigenvalues(st.idx, bank.spec)
            prior = _prior_leaves(loglam, cap - bank.capacity)
            leaves = {f: torch.cat([v, prior[f]]) for f, v in leaves.items()}
        active = np.zeros(cap, bool)
        active[:bank.capacity] = bank.active
        shards = []
        for s, devs in enumerate(cls._shard_devices(mesh)):
            lo, dev = s * C_l, devs[0]
            stack = FAGPState(idx=st.idx.to(dev), spec=spec_local(bank.spec, dev),
                              **{f: v[lo:lo + C_l].to(dev, copy=True)
                                 for f, v in leaves.items()})
            local = {t: g - lo for t, g in bank.slots.items() if g // C_l == s}
            shards.append(_with_binv(GPBank(stack=stack, active=active[lo:lo + C_l].copy(),
                                            slots=local)))
        return cls(shards=tuple(shards), mesh=mesh, slots=dict(bank.slots))

    def to_bank(self) -> GPBank:
        """Gather the shards back into one resident bank on the first
        shard's device (global slot ids kept)."""
        home = self.shards[0].spec.device
        leaves = {f: torch.cat([getattr(sh.stack, f).to(home) for sh in self.shards])
                  for f in _LEAVES}
        stack = FAGPState(idx=self.shards[0].stack.idx, spec=self.spec, **leaves)
        return GPBank(stack=stack, active=self.active, slots=dict(self.slots))

    # -- introspection ------------------------------------------------------

    @property
    def spec(self) -> GPSpec:
        """The bank's spec, on the first shard's device."""
        return self.shards[0].spec

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def shard_capacity(self) -> int:
        return self.shards[0].capacity

    @property
    def capacity(self) -> int:
        return self.n_shards * self.shard_capacity

    @property
    def n_features(self) -> int:
        return self.shards[0].n_features

    @property
    def active(self) -> np.ndarray:
        """(capacity,) host bool mask of occupied global slots."""
        return np.concatenate([sh.active for sh in self.shards])

    @property
    def tenants(self) -> list:
        return list(self.slots)

    def __len__(self) -> int:
        return len(self.slots)

    def __contains__(self, tenant: Hashable) -> bool:
        return tenant in self.slots

    def slot_of(self, tenant: Hashable) -> int:
        try:
            return self.slots[tenant]
        except KeyError:
            raise KeyError(
                f"tenant {tenant!r} is not in this bank (tenants: "
                f"{self.tenants!r})"
            ) from None

    def shard_of(self, tenant: Hashable) -> int:
        """Which shard owns this tenant's slot."""
        return self.slot_of(tenant) // self.shard_capacity

    def shard_occupancy(self) -> np.ndarray:
        """(S,) active tenants per shard (host-side, no sync)."""
        return np.array([int(sh.active.sum()) for sh in self.shards], np.int64)

    def state(self, tenant: Hashable) -> FAGPState:
        """The tenant's session, unstacked, on its shard's device."""
        return self.shards[self.shard_of(tenant)].state(tenant)

    def states(self) -> dict:
        return {t: self.state(t) for t in self.slots}

    def _slots_np(self, tenant_ids) -> np.ndarray:
        if isinstance(tenant_ids, (str, bytes)) or not hasattr(tenant_ids, "__iter__"):
            raise TypeError(
                "tenant_ids must be a sequence of tenant ids, one per row "
                f"(got a scalar {tenant_ids!r}); for a single-tenant batch "
                "pass [tenant] * len(Xq)"
            )
        return np.fromiter((self.slot_of(t) for t in tenant_ids), np.int64)

    result_ready = staticmethod(GPBank.result_ready)

    def _with_shards(self, new: dict, **fields) -> "ShardedGPBank":
        """A new bank with the shards in ``new`` (index -> GPBank) replaced."""
        shards = tuple(new.get(s, sh) for s, sh in enumerate(self.shards))
        return dataclasses.replace(self, shards=shards, **fields)

    # -- serving ------------------------------------------------------------

    def _packed_mean_var(self, gslots: np.ndarray, Xq: torch.Tensor):
        """Serving core on global slots: the batch packed by shard, one
        gathered posterior per shard touched, on its device.  Returns
        ``(mus, vars, pos)``: each shard's results in packed order and
        where each row's result lands in them, concatenated."""
        serve = fagp._gathered_bank_mean_var(fagp._check_backend_support(self.spec).features)
        groups, pos = _group_rows(gslots, self.shard_capacity, self.n_shards)
        mus, vs = [], []
        for s, rows, lslots in groups:
            sh = self.shards[s]
            dev = sh.spec.device
            mu, var = _sh_mean_var(serve, sh.stack, sh._binv, torch.from_numpy(lslots).to(dev),
                                   Xq[torch.from_numpy(rows).to(Xq.device)].to(dev))
            mus.append(mu)
            vs.append(var)
        return mus, vs, pos

    def mean_var(self, tenant_ids, Xq):
        """Posterior mean and marginal variance for a mixed-tenant query
        batch (same contract as :meth:`GPBank.mean_var`), in row order on
        the first shard's device."""
        Xq = _f32(Xq, None)
        gslots = self._slots_np(tenant_ids)
        if Xq.ndim != 2 or gslots.shape[0] != Xq.shape[0]:
            raise ValueError(
                f"one tenant id per query row: got {gslots.shape[0]} ids "
                f"for Xq of shape {tuple(Xq.shape)}"
            )
        fagp._check_p(self.spec, Xq.shape[1])
        mus, vs, pos = self._packed_mean_var(gslots, Xq)
        home = self.spec.device
        unpack = torch.from_numpy(pos).to(home)
        return (torch.cat([m.to(home) for m in mus])[unpack],
                torch.cat([v.to(home) for v in vs])[unpack])

    def _serving_entry(self):
        """The pipelined engine's lean serving call, resolved once per bank
        object: ``call(slots, Xq)`` for host ``slots`` (Q,) int64 global
        slots and ``Xq`` (Q, p) float32 arrays gives ``(mus, vars, events,
        pos)``: each shard touched serves its packed rows on its device,
        staged through pinned memory and copied back without a host-device
        barrier, one CUDA event per shard touched (none on the CPU); the
        engine harvests the shards' results concatenated, row i at
        ``pos[i]``."""
        call = self.__dict__.get("_serving_cache")
        if call is not None:
            return call
        serve = fagp._gathered_bank_mean_var(fagp._check_backend_support(self.spec).features)
        parts = [(sh.stack, sh._binv, sh.spec.device) for sh in self.shards]
        C_l, S = self.shard_capacity, self.n_shards

        def call(slots, Xq):
            groups, pos = _group_rows(slots, C_l, S)
            mus, vs, events = [], [], []
            for s, rows, lslots in groups:
                stack, binv, dev = parts[s]
                mu, var = _sh_mean_var(serve, stack, binv, _to_device(lslots, dev),
                                       _to_device(Xq[rows], dev))
                if dev.type == "cuda":
                    mu, var = mu.to("cpu", non_blocking=True), var.to("cpu", non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(dev))
                    events.append(event)
                mus.append(mu)
                vs.append(var)
            return mus, vs, tuple(events), pos

        object.__setattr__(self, "_serving_cache", call)
        return call

    # -- ingest / forgetting ------------------------------------------------

    def _each_shard(self, slots, X, y, mask, who: str, step):
        """Split groups aimed at global ``slots`` by shard and run
        ``step(shard, lslots, X_s, y_s, mask_s)`` on each shard touched,
        its group axis padded to the shard's rung with fully-masked groups
        (``_group_slots``).  Returns ``[(shard index, groups, result)]``."""
        if isinstance(slots, torch.Tensor):
            slots = slots.cpu().numpy()
        gslots = np.asarray(slots, np.int64).reshape(-1)
        X, y = _f32(X, None), _f32(y, None)
        G, k, p = X.shape
        fagp._check_p(self.spec, p)
        mask = _as_mask(mask, (G, k), X.device, who)
        if gslots.shape != (G,) or np.unique(gslots).size != G:
            raise ValueError(f"{who} wants {G} distinct slots, got {gslots.tolist()}")
        out = []
        for s, idx, lslots in _group_slots(gslots, self.shard_capacity):
            n, Q = len(idx), len(lslots)
            sel = torch.from_numpy(idx).to(X.device)
            Xs, ys, ms = X.new_zeros((Q, k, p)), y.new_zeros((Q, k)), mask.new_zeros((Q, k))
            Xs[:n], ys[:n], ms[:n] = X[sel], y[sel], mask[sel]
            out.append((s, idx, step(self.shards[s], lslots, Xs, ys, ms)))
        return out

    def update(self, tenant_ids, Xk, yk, mask=None) -> "ShardedGPBank":
        """Batched rank-k ingest (same contract as :meth:`GPBank.update`)."""
        Xk, yk = _f32(Xk, None), _f32(yk, None)
        ids = list(tenant_ids)
        _check_batch("update", Xk, yk, ids, "update")
        return self._update_at_slots(self._slots_np(ids), Xk, yk, mask)

    def _update_at_slots(self, slots, Xk, yk, mask=None, donate: bool = False):
        """Slot-addressed core of :meth:`update` on global slots (the
        router's entry): each shard touched absorbs its groups in one
        ``GPBank._update_at_slots`` (a features launch and a batched sweep
        on ``pallas``); ``donate`` writes each touched shard in place."""
        done = self._each_shard(slots, Xk, yk, mask, "ShardedGPBank.update",
                                lambda sh, *a: _sh_update_scatter(sh, *a, donate))
        return self._with_shards({s: new for s, _, new in done})

    def downdate(self, tenant_ids, Xk, yk, mask=None):
        """Batched rank-k forget (same contract as :meth:`GPBank.downdate`):
        returns ``(bank, ok)``."""
        Xk, yk = _f32(Xk, None), _f32(yk, None)
        ids = list(tenant_ids)
        _check_batch("downdate", Xk, yk, ids, "downdate")
        return self._downdate_at_slots(self._slots_np(ids), Xk, yk, mask)

    def _downdate_at_slots(self, slots, Xk, yk, mask=None):
        done = self._each_shard(slots, Xk, yk, mask, "ShardedGPBank.downdate",
                                _sh_downdate_scatter)
        ok = np.ones(sum(len(idx) for _, idx, _ in done), bool)
        for _, idx, (_, ok_s) in done:
            ok[idx] = ok_s[:len(idx)]
        return self._with_shards({s: new for s, _, (new, _) in done}), ok

    def refit_window(self, tenant_ids, Xw, yw, mask=None) -> "ShardedGPBank":
        """Window refit (same contract as :meth:`GPBank.refit_window`)."""
        Xw, yw = _f32(Xw, None), _f32(yw, None)
        ids = list(tenant_ids)
        _check_batch("refit_window", Xw, yw, ids, "refit", names=("Xw", "yw", "W"))
        return self._refit_at_slots(self._slots_np(ids), Xw, yw, mask)

    def _refit_at_slots(self, slots, Xw, yw, mask=None) -> "ShardedGPBank":
        done = self._each_shard(slots, Xw, yw, mask, "ShardedGPBank.refit_window",
                                _sh_refit_scatter)
        return self._with_shards({s: new for s, _, new in done})

    # -- membership churn ---------------------------------------------------

    def _free_slot_on(self, shard: int) -> Optional[int]:
        free = np.flatnonzero(~self.shards[shard].active)
        return None if free.size == 0 else int(free[0])

    def _placement_shard(self) -> int:
        """Least-loaded shard with a free slot (ties -> lowest id): the
        placement policy; ``TieredBank`` restores inherit it through
        :meth:`insert`."""
        occ = self.shard_occupancy()
        for s in np.lexsort((np.arange(self.n_shards), occ)):
            if occ[s] < self.shard_capacity:
                return int(s)
        raise ValueError(
            f"bank is full ({self.capacity} slots); evict a tenant or "
            f"rebuild with a larger capacity"
        )

    def _write(self, s: int, lslot: int, values: dict, tenant=None) -> GPBank:
        """Shard ``s`` with ``values`` written at ``lslot``, that slot made
        ``tenant``'s (or freed, for None) and its B^{-1} row refreshed."""
        sh = self.shards[s]
        active = sh.active.copy()
        active[lslot] = tenant is not None
        slots = {t: j for t, j in sh.slots.items() if j != lslot}
        if tenant is not None:
            slots[tenant] = lslot
        new = sh._with(_sh_write_slot(sh.stack, lslot, values), active=active, slots=slots)
        sh._carry_binv_into(new, lslot)
        return new

    def _prior(self, s: int) -> dict:
        sh = self.shards[s]
        loglam = get_expansion(sh.spec.expansion).log_eigenvalues(sh.stack.idx, sh.spec)
        return {f: v[0] for f, v in _prior_leaves(loglam, 1).items()}

    def insert(self, tenant: Hashable, source) -> "ShardedGPBank":
        """Add a tenant on the least-loaded shard, in its lowest free local
        slot (same source contract as :meth:`GPBank.insert`)."""
        if tenant in self.slots:
            raise ValueError(f"tenant {tenant!r} already in the bank")
        s = self._placement_shard()
        lslot = self._free_slot_on(s)
        sp = self.shards[s].spec
        if isinstance(source, tuple):
            X, y = source
            st = fagp.fit(X, y, sp)
        else:
            st = source.state if isinstance(source, GP) else source
        _check_bankable(st, sp, f"insert({tenant!r})")
        new = self._write(s, lslot, {f: getattr(st, f) for f in _LEAVES}, tenant)
        return self._with_shards({s: new}, slots={**self.slots,
                                                  tenant: s * self.shard_capacity + lslot})

    def evict(self, tenant: Hashable) -> "ShardedGPBank":
        """Remove a tenant; its slot resets to the prior state."""
        g = self.slot_of(tenant)
        s, lslot = divmod(g, self.shard_capacity)
        new = self._write(s, lslot, self._prior(s))
        return self._with_shards({s: new}, slots={t: v for t, v in self.slots.items()
                                                  if t != tenant})

    def rebalance(self, max_moves: Optional[int] = None):
        """Move tenants from the fullest shards to the emptiest until the
        occupancy spread is <= 1 (or ``max_moves`` is hit).  Deterministic:
        the donor is the fullest shard (ties -> lowest id), the migrant its
        highest occupied local slot, the receiver the emptiest (ties ->
        lowest id), into its lowest free slot.  Returns ``(bank, moves)``."""
        bank, moves = self, 0
        C_l = self.shard_capacity
        while max_moves is None or moves < max_moves:
            occ = bank.shard_occupancy()
            donor = int(np.lexsort((np.arange(len(occ)), -occ))[0])
            recv = int(np.lexsort((np.arange(len(occ)), occ))[0])
            if occ[donor] - occ[recv] <= 1:
                break
            src = int(np.flatnonzero(bank.shards[donor].active)[-1])
            tenant = next(t for t, j in bank.shards[donor].slots.items() if j == src)
            dst = bank._free_slot_on(recv)
            values = _sh_read_slot(bank.shards[donor].stack, src)
            moved = {recv: bank._write(recv, dst, values, tenant),
                     donor: bank._write(donor, src, bank._prior(donor))}
            bank = bank._with_shards(moved, slots={**bank.slots, tenant: recv * C_l + dst})
            moves += 1
        return bank, moves

    # -- unsupported resident-only surface ---------------------------------

    def optimize(self, *a, **k):
        raise NotImplementedError(
            "fleet hyperparameter optimization produces a heterogeneous "
            "bank, which has no shard-local serving path yet — "
            "to_bank().optimize(...) and re-shard after"
        )
