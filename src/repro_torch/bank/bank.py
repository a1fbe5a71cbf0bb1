"""GPBank: a fleet of independent GP sessions served as one batched model.

Counterpart of ``repro/bank/bank.py`` for homogeneous banks (every tenant
shares the spec's hyperparameters).  A bank keeps ``capacity`` fitted
sessions on the device as ONE stacked :class:`~repro_torch.core.fagp.FAGPState`:

* leading bank axis on ``chol`` (C, M, M), ``u`` (C, M), ``b`` (C, M),
  ``lam``/``sqrtlam`` (C, M): the per-tenant factorizations;
* one shared :class:`~repro_torch.core.fagp.GPSpec` (index set, Mercer
  depth, backend, hyperparameters), so every tenant shares one feature map.

Some slots are *active* (hold a tenant); the rest hold the prior state
(chol = I, u = b = 0: zero mean, prior variance).

Entry points, each a few batched calls over the whole fleet:

* :meth:`GPBank.fit`      B datasets -> B factorizations: the backend's
  ``bank_moments`` (one launch of the bank kernel on the ``pallas``
  backend) and one batched Cholesky.  Ragged per-tenant N is a per-slot
  row mask on a fixed (B, N, p) stack.
* :meth:`GPBank.mean_var` a mixed-tenant query batch: row q is answered by
  tenant ``tenant_ids[q]``'s posterior, gathered from the stack against the
  per-slot B^{-1} cache.
* :meth:`GPBank.update`   batched rank-k ingest: the gathered groups' rank-k
  Cholesky update (one launch of the batched sweep kernel when K * 8 <= M
  on the ``pallas`` backend), scattered into a new stack.
* :meth:`GPBank.insert` / :meth:`GPBank.evict` membership churn.

A bank is immutable: every mutating method returns a new bank, and the old
one serves exactly as before.  The port never writes a stack tensor in
place: a mutation clones the leaves it changes (the JAX package's
``.at[].set`` does the same).  ``downdate``, ``refit_window``, ``optimize``
and per-slot hyperparameters (``hypers``) are not ported yet and raise
:class:`~repro_torch.core.approximation.UnsupportedError` naming their
ROADMAP items.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Hashable, Mapping, Optional, Sequence

import numpy as np
import torch

from ..core import fagp
from ..core.expansions import get_expansion
from ..core.fagp import FAGPState, GPSpec, _f32
from ..core.gp import GP, _not_ported

__all__ = ["GPBank"]

_LEAVES = ("lam", "sqrtlam", "chol", "u", "b")
_DOWNDATE = "bank downdate / refit_window (ROADMAP A2)"
_HETERO = ("heterogeneous bank: GPBank.optimize and per-slot hyperparameters "
           "(ROADMAP A3, on A1's NLML gradient)")
_OBS = "pipelined fleet serving with obs and the tiered bank (ROADMAP A4)"


def _bank_mean_weights(chol, sqrtlam, b, sig2):
    """u_s = D_s B_s^{-1} D_s b_s / sig2 for every slot: chol (C, M, M),
    sqrtlam and b (C, M) -> (C, M)."""
    rhs = (sqrtlam * b)[..., None]
    return sqrtlam * torch.cholesky_solve(rhs, chol)[..., 0] / sig2


def _bank_solve(G, b, loglam, sig2):
    """Batched fit epilogue: raw moments G (C, M, M), b (C, M) -> stacked
    (lam, sqrtlam, chol, u).  The scaled system keeps its one home
    (``fagp._assemble_scaled_system``), batched over slots."""
    Bm, sqrtlam = fagp._assemble_scaled_system(G, loglam, sig2)
    C = G.shape[0]
    sqrtlam = sqrtlam.expand(C, -1).contiguous()
    chol = torch.linalg.cholesky(Bm)
    u = _bank_mean_weights(chol, sqrtlam, b, sig2)
    lam = torch.exp(loglam).expand(C, -1).contiguous()
    return lam, sqrtlam, chol, u


def _scatter(stack: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor):
    """A new stack with ``rows`` written at ``slots`` (distinct)."""
    out = stack.clone()
    out[slots] = rows.to(out.device)
    return out


def _bank_update_scatter(chol_s, u_s, b_s, sqrtlam_s, noise, slots, Phi_g,
                         y_g, mask_g, rank_update):
    """Gather the slots' states, apply the rank-k update per group, scatter
    into new stack tensors.  Padded rows (mask 0) zero their feature row,
    which makes the rank-1 sweep an identity for them.  A *fully*-masked
    group (the router's group-axis padding) leaves its slot bit-identical:
    the identity sweep is exact only up to sqrt rounding, and an untouched
    tenant must not drift.  The sweep runs on the gathered copy, never on
    the stack's storage."""
    Phi_g = Phi_g * mask_g[..., None]
    y_g = y_g * mask_g
    chol_g = chol_s[slots]
    d = sqrtlam_s[slots]
    # B_new = B + sum_k v_k v_k^T,  v_k = D phi_k / sigma
    W = Phi_g * d[:, None, :] / noise
    ch = fagp._rank_k_chol(chol_g, W, rank_update)
    bb = b_s[slots] + (Phi_g.mT @ y_g[..., None])[..., 0]
    uu = _bank_mean_weights(ch, d, bb, noise**2)
    real = torch.amax(mask_g, dim=1) > 0
    live = slots[real]
    return (_scatter(chol_s, live, ch[real]), _scatter(u_s, live, uu[real]),
            _scatter(b_s, live, bb[real]))


def _write_slot(stack: FAGPState, slot: int, values: dict) -> dict:
    """New leaves with one tenant's values written at ``slot``."""
    index = torch.tensor([slot], device=stack.chol.device)
    return {f: _scatter(getattr(stack, f), index, values[f][None]) for f in _LEAVES}


def _prior_leaves(loglam: torch.Tensor, count: int) -> dict:
    """The per-slot leaves of the 'no data yet' state: chol = I, u = b = 0,
    the spec's eigenvalues (zero mean, prior variance).  The ONE definition
    of an empty slot: ``create`` builds whole banks from it, ``fit`` pads
    reserved capacity with it and ``evict`` resets a slot to it."""
    M = loglam.shape[0]
    dev = loglam.device
    return {
        "lam": torch.exp(loglam).expand(count, M).contiguous(),
        "sqrtlam": torch.exp(0.5 * loglam).expand(count, M).contiguous(),
        "chol": torch.eye(M, dtype=torch.float32, device=dev).expand(count, M, M).contiguous(),
        "u": torch.zeros((count, M), dtype=torch.float32, device=dev),
        "b": torch.zeros((count, M), dtype=torch.float32, device=dev),
    }


def _bank_spec(spec: GPSpec) -> GPSpec:
    """Normalize a spec for bank use: a bank is a serving structure and
    never stores per-tenant training features, so ``store_train`` is turned
    off (else every unstacked ``state(t)`` would claim stored features while
    holding ``Phi=None``)."""
    return spec.replace(store_train=False) if spec.store_train else spec


def _check_bankable(state: FAGPState, spec: GPSpec, who: str) -> None:
    """A state can join a homogeneous bank iff it was factorized under the
    bank's shared spec (structure AND hyperparameters, including any RFF
    spectral draws) and is single-output."""
    fagp._check_spec_regenerates_idx(state, spec)
    try:
        fagp._check_hypers_match(state, spec, who)
    except ValueError as e:
        raise ValueError(
            f"{e}; a bank shares one feature map and one eigenvalue "
            f"scaling across all tenants — refit the tenant under the "
            f"bank spec"
        ) from None
    if state.u.ndim != 1:
        raise ValueError(
            f"{who}: multi-output states (T={state.n_tasks}) cannot join a "
            f"bank; banks batch over tenants, one task each"
        )


def _as_mask(mask, shape, dev, who: str) -> torch.Tensor:
    if mask is None:
        return torch.ones(shape, dtype=torch.float32, device=dev)
    mask = _f32(mask, dev)
    if tuple(mask.shape) != tuple(shape):
        raise ValueError(
            f"{who}: mask must be {tuple(shape)}, got {tuple(mask.shape)} — a "
            f"broadcastable mask would silently drop rows from every group"
        )
    return mask


@dataclasses.dataclass(frozen=True, eq=False)
class GPBank:
    """A fixed-capacity bank of independent GP sessions (see module doc).

    Construct with :meth:`fit`, :meth:`create` or :meth:`from_states` (or
    ``core.convert.bank_from_numpy``); the default constructor is internal.

    stack:  stacked FAGPState: bank axis on chol/u/b/lam/sqrtlam, shared
            idx and spec.
    active: (capacity,) host-side bool mask of occupied slots.
    slots:  tenant id -> slot index (insertion order preserved).
    hypers: per-slot hyperparameters are not ported (must be None).
    """

    stack: FAGPState
    active: np.ndarray
    slots: Mapping[Hashable, int]
    hypers: Any = None

    def __post_init__(self):
        if self.hypers is not None:
            _not_ported("GPBank(hypers=...)", _HETERO, self.stack.spec)

    # -- constructors -------------------------------------------------------

    @classmethod
    def create(cls, spec: GPSpec, capacity: int) -> "GPBank":
        """An empty bank: every slot holds the prior state."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        spec = _bank_spec(spec)
        fagp._check_backend_support(spec)
        idx = fagp._idx_tensor(spec)
        loglam = get_expansion(spec.expansion).log_eigenvalues(idx, spec)
        stack = FAGPState(idx=idx, spec=spec, **_prior_leaves(loglam, capacity))
        return cls(stack=stack, active=np.zeros(capacity, bool), slots={})

    @classmethod
    def fit(
        cls,
        Xb,
        yb,
        spec: GPSpec,
        *,
        mask=None,
        tenant_ids: Optional[Sequence[Hashable]] = None,
        capacity: Optional[int] = None,
    ) -> "GPBank":
        """Fit B independent GPs in one batched pass.

        Xb: (B, N, p) stacked inputs; yb: (B, N) stacked targets;
        mask: (B, N) row validity (tenants with fewer than N real rows pad
        to N and mask the padding).  ``tenant_ids`` default to
        ``range(B)``; ``capacity`` (>= B) reserves extra prior slots for
        later :meth:`insert`.
        """
        spec = _bank_spec(spec)
        dev = spec.device
        Xb, yb = _f32(Xb, dev), _f32(yb, dev)
        if Xb.ndim != 3 or yb.ndim != 2 or tuple(yb.shape) != tuple(Xb.shape[:2]):
            raise ValueError(
                f"GPBank.fit wants Xb (B, N, p) and yb (B, N); got "
                f"{tuple(Xb.shape)} and {tuple(yb.shape)}"
            )
        B, N, p = Xb.shape
        fagp._check_p(spec, p)
        cap = B if capacity is None else int(capacity)
        if cap < B:
            raise ValueError(f"capacity {cap} < number of tenants {B}")
        tenant_ids = list(range(B) if tenant_ids is None else tenant_ids)
        if len(tenant_ids) != B or len(set(tenant_ids)) != B:
            raise ValueError(f"tenant_ids must be {B} distinct ids, got {tenant_ids!r}")
        mask = _as_mask(mask, (B, N), dev, "GPBank.fit")
        backend = fagp._check_backend_support(spec)
        idx = fagp._idx_tensor(spec, p)
        block_rows = min(spec.block_rows, max(1, N))
        G, b = backend.bank_moments(Xb.contiguous(), yb.contiguous(), spec, idx,
                                    block_rows, mask)
        loglam = get_expansion(spec.expansion).log_eigenvalues(idx, spec)
        lam, sqrtlam, chol, u = _bank_solve(G, b, loglam, spec.noise**2)
        del G
        leaves = dict(lam=lam, sqrtlam=sqrtlam, chol=chol, u=u, b=b)
        if cap > B:
            # reserved slots get the prior leaves directly: never pay the
            # moment pass or the Cholesky for an empty slot
            prior = _prior_leaves(loglam, cap - B)
            leaves = {f: torch.cat([v, prior[f]]) for f, v in leaves.items()}
        stack = FAGPState(idx=idx, spec=spec, **leaves)
        active = np.zeros(cap, bool)
        active[:B] = True
        return cls(stack=stack, active=active,
                   slots={t: s for s, t in enumerate(tenant_ids)})

    @classmethod
    def from_states(cls, states: Mapping[Hashable, Any], *,
                    capacity: Optional[int] = None) -> "GPBank":
        """Stack already-fitted sessions (``GP`` or ``FAGPState``) into a
        bank.  All must share one structural spec and one hyperparameter
        set (the bank's shared feature map)."""
        if not states:
            raise ValueError("from_states needs at least one state")
        items = [(t, s.state if isinstance(s, GP) else s) for t, s in states.items()]
        spec = _bank_spec(items[0][1].spec)
        for t, st in items:
            _check_bankable(st, spec, f"from_states(tenant {t!r})")
        B = len(items)
        cap = B if capacity is None else int(capacity)
        if cap < B:
            raise ValueError(f"capacity {cap} < number of states {B}")
        bank = cls.create(spec, cap)
        leaves = {
            f: torch.cat([torch.stack([getattr(st, f).to(spec.device) for _, st in items]),
                          getattr(bank.stack, f)[B:]])
            for f in _LEAVES
        }
        active = np.zeros(cap, bool)
        active[:B] = True
        return cls(stack=dataclasses.replace(bank.stack, **leaves), active=active,
                   slots={t: s for s, (t, _) in enumerate(items)})

    # -- introspection ------------------------------------------------------

    @property
    def spec(self) -> GPSpec:
        return self.stack.spec

    @property
    def capacity(self) -> int:
        return self.stack.u.shape[0]

    @property
    def n_features(self) -> int:
        return self.stack.idx.shape[0]

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

    def state(self, tenant: Hashable) -> FAGPState:
        """The tenant's session, unstacked: a normal single-model FAGPState
        usable with every ``fagp``/``GP`` entry point."""
        s = self.slot_of(tenant)
        return dataclasses.replace(
            self.stack, **{f: getattr(self.stack, f)[s] for f in _LEAVES})

    def states(self) -> dict:
        """All tenants' sessions, unstacked (tenant -> FAGPState)."""
        return {t: self.state(t) for t in self.slots}

    def _with(self, leaves: dict, **fields) -> "GPBank":
        """A new bank with the stack's ``leaves`` (and any bank ``fields``)
        replaced; the expansion's feature table rides along."""
        stack = dataclasses.replace(self.stack, **leaves)
        if "tile" in self.stack.serving:
            stack.serving["tile"] = self.stack.serving["tile"]
        return dataclasses.replace(self, stack=stack, **fields)

    @property
    def _binv(self) -> torch.Tensor:
        """Per-slot B^{-1} serving cache (C, M, M), computed on first use and
        kept on the instance: a bank is immutable, so it never goes stale.
        Mutations that know their slots carry it forward with only those
        rows refreshed (``_carry_binv_into``)."""
        cached = self.__dict__.get("_binv_cache")
        if cached is None:
            cached = fagp._bank_binv(self.stack.chol)
            object.__setattr__(self, "_binv_cache", cached)
        return cached

    def _carry_binv_into(self, new: "GPBank", slots: torch.Tensor) -> None:
        """If this bank already paid for the full cache, hand it to ``new``
        with the rows of ``slots`` refreshed, instead of making the next
        query recompute B^{-1} for the whole capacity."""
        cached = self.__dict__.get("_binv_cache")
        if cached is not None:
            slots = torch.atleast_1d(slots)
            rows = fagp._bank_binv(new.stack.chol[slots])
            object.__setattr__(new, "_binv_cache", _scatter(cached, slots, rows))

    def _slots_for(self, tenant_ids) -> torch.Tensor:
        if isinstance(tenant_ids, (str, bytes)) or not hasattr(tenant_ids, "__iter__"):
            raise TypeError(
                "tenant_ids must be a sequence of tenant ids, one per row "
                f"(got a scalar {tenant_ids!r}); for a single-tenant batch "
                "pass [tenant] * len(Xq)"
            )
        return torch.tensor([self.slot_of(t) for t in tenant_ids],
                            dtype=torch.long, device=self.spec.device)

    # -- the batched pipeline ----------------------------------------------

    def mean_var(self, tenant_ids, Xq):
        """Posterior mean and marginal variance for a MIXED-tenant query
        batch: row q of ``Xq`` (Q, p) is answered by ``tenant_ids[q]``'s
        posterior."""
        Xq = _f32(Xq, self.spec.device)
        slots = self._slots_for(tenant_ids)
        if Xq.ndim != 2 or slots.shape[0] != Xq.shape[0]:
            raise ValueError(
                f"one tenant id per query row: got {slots.shape[0]} ids "
                f"for Xq of shape {tuple(Xq.shape)}"
            )
        fagp._check_p(self.spec, Xq.shape[1])
        backend = fagp._check_backend_support(self.spec)
        serve = fagp._gathered_bank_mean_var(backend.features)
        return serve(self.stack, self._binv, slots, Xq)

    def update(self, tenant_ids, Xk, yk, mask=None) -> "GPBank":
        """Batched rank-k ingest: group g absorbs (Xk[g], yk[g]) into tenant
        ``tenant_ids[g]``'s factorization.  ``mask`` (G, k) zeroes padded
        rows (ragged ingest).  Tenants must be distinct within one call
        (the scattered writes would collide); the router splits them into
        rounds."""
        dev = self.spec.device
        Xk, yk = _f32(Xk, dev), _f32(yk, dev)
        if Xk.ndim != 3 or tuple(yk.shape) != tuple(Xk.shape[:2]):
            raise ValueError(
                f"GPBank.update wants Xk (G, k, p) and yk (G, k); got "
                f"{tuple(Xk.shape)} and {tuple(yk.shape)}"
            )
        ids = list(tenant_ids)
        if len(set(ids)) != len(ids):
            raise ValueError(
                f"duplicate tenant in one update batch ({ids!r}): the "
                f"scattered writes would collide — split into rounds "
                f"(BankRouter.ingest does this)"
            )
        if len(ids) != Xk.shape[0]:
            raise ValueError(
                f"one tenant id per update group: got {len(ids)} ids for "
                f"{Xk.shape[0]} groups"
            )
        return self._update_at_slots(self._slots_for(ids), Xk, yk, mask)

    def _update_at_slots(self, slots, Xk, yk, mask=None,
                         donate: bool = False) -> "GPBank":
        """Slot-addressed core of :meth:`update`, and the router's entry: a
        fully-masked group leaves its slot untouched, so the router pads
        the group axis to a power-of-two bucket with masked groups aimed at
        distinct unused slots.  Slots must be distinct."""
        if donate:
            _not_ported("GPBank update with donate=True", _OBS, self.spec)
        dev = self.spec.device
        Xk, yk = _f32(Xk, dev), _f32(yk, dev)
        G, k, p = Xk.shape
        fagp._check_p(self.spec, p)
        mask = _as_mask(mask, (G, k), dev, "GPBank.update")
        slots = torch.as_tensor(slots, dtype=torch.long, device=dev)
        if tuple(slots.shape) != (G,) or torch.unique(slots).numel() != G:
            raise ValueError(f"update wants {G} distinct slots, got {slots.tolist()}")
        backend = fagp._check_backend_support(self.spec)
        Phi_g = backend.features(Xk.reshape(G * k, p), self.spec, self.stack.idx,
                                 self.stack).reshape(G, k, -1)
        chol, u, b = _bank_update_scatter(
            self.stack.chol, self.stack.u, self.stack.b, self.stack.sqrtlam,
            self.spec.noise, slots, Phi_g, yk, mask, backend.rank_update,
        )
        new = self._with(dict(chol=chol, u=u, b=b))
        self._carry_binv_into(new, slots)
        return new

    def downdate(self, tenant_ids, Xk, yk, mask=None):
        """Batched rank-k forget (not ported yet)."""
        _not_ported("GPBank.downdate", _DOWNDATE, self.spec)

    def refit_window(self, tenant_ids, Xw, yw, mask=None) -> "GPBank":
        """Re-factorize tenants from retained window data (not ported yet)."""
        _not_ported("GPBank.refit_window", _DOWNDATE, self.spec)

    def optimize(self, Xb, yb, **kwargs) -> "GPBank":
        """Fleet-scale hyperparameter learning (not ported yet)."""
        _not_ported("GPBank.optimize", _HETERO, self.spec)

    # -- membership churn ---------------------------------------------------

    def insert(self, tenant: Hashable, source) -> "GPBank":
        """Add a tenant into the first free slot.  ``source`` is a fitted
        ``GP`` / ``FAGPState`` sharing the bank's spec, or an ``(X, y)``
        tuple fitted under it.  Raises when full or when the id is taken."""
        if tenant in self.slots:
            raise ValueError(f"tenant {tenant!r} already in the bank")
        free = np.flatnonzero(~self.active)
        if free.size == 0:
            raise ValueError(
                f"bank is full ({self.capacity} slots); evict a tenant or "
                f"rebuild with a larger capacity"
            )
        if isinstance(source, tuple):
            X, y = source
            st = fagp.fit(X, y, self.spec)
        else:
            st = source.state if isinstance(source, GP) else source
        _check_bankable(st, self.spec, f"insert({tenant!r})")
        slot = int(free[0])
        leaves = _write_slot(self.stack, slot, {f: getattr(st, f) for f in _LEAVES})
        active = self.active.copy()
        active[slot] = True
        new = self._with(leaves, active=active, slots={**self.slots, tenant: slot})
        self._carry_binv_into(new, torch.tensor([slot], device=self.spec.device))
        return new

    def evict(self, tenant: Hashable) -> "GPBank":
        """Remove a tenant; its slot is reset to the prior state and becomes
        reusable by the next :meth:`insert`."""
        slot = self.slot_of(tenant)
        loglam = get_expansion(self.spec.expansion).log_eigenvalues(
            self.stack.idx, self.spec)
        prior = _prior_leaves(loglam, 1)
        leaves = _write_slot(self.stack, slot, {f: prior[f][0] for f in _LEAVES})
        active = self.active.copy()
        active[slot] = False
        slots = {t: s for t, s in self.slots.items() if t != tenant}
        new = self._with(leaves, active=active, slots=slots)
        self._carry_binv_into(new, torch.tensor([slot], device=self.spec.device))
        return new
