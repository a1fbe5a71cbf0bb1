"""GPBank: a fleet of independent GP sessions served as one batched model.

Counterpart of ``repro/bank/bank.py``.  A bank keeps ``capacity`` fitted
sessions on the device as ONE stacked :class:`~repro_torch.core.fagp.FAGPState`:

* leading bank axis on ``chol`` (C, M, M), ``u`` (C, M), ``b`` (C, M),
  ``lam``/``sqrtlam`` (C, M): the per-tenant factorizations;
* one shared :class:`~repro_torch.core.fagp.GPSpec` (index set, Mercer
  depth, backend, hyperparameters), so every tenant shares one feature map;
  or, in a *heterogeneous* bank (after :meth:`GPBank.optimize`), a per-slot
  (eps, rho, noise) overlay (``GPBank.hypers``) over the shared structure.

Some slots are *active* (hold a tenant); the rest hold the prior state
(chol = I, u = b = 0: zero mean, prior variance).

Entry points, each a few batched calls over the whole fleet:

* :meth:`GPBank.fit`      B datasets -> B factorizations: the backend's
  ``bank_moments`` (one launch of the bank kernel on the ``pallas``
  backend) and one batched Cholesky.  Ragged per-tenant N is a per-slot
  row mask on a fixed (B, N, p) stack.
* :meth:`GPBank.mean_var` a mixed-tenant query batch: row q is answered by
  tenant ``tenant_ids[q]``'s posterior, gathered from the stack against the
  per-slot B^{-1} cache; a heterogeneous bank builds each row's features
  under its slot's hyperparameters (one launch of the features kernel with
  per-row constants on the ``pallas`` backend).
* :meth:`GPBank.update`   batched rank-k ingest: the gathered groups' rank-k
  Cholesky update (one launch of the batched sweep kernel when K * 8 <= M
  on the ``pallas`` backend), scattered into a new stack.
* :meth:`GPBank.downdate` batched rank-k forgetting: hyperbolic rank-1
  downdate sweeps (one launch of the batched downdate kernel on the
  ``pallas`` backend); a group that loses a pivot keeps its slot
  bit-exactly and reports ``ok=False``.
* :meth:`GPBank.refit_window` re-factorizes tenants from retained data,
  each under its own slot's hyperparameters (one launch of the bank kernel
  with per-slot constants): the downdate's fallback and its reference.
* :meth:`GPBank.optimize` fleet-scale hyperparameter learning on the lane
  engine, then that refit: the bank becomes heterogeneous.
* :meth:`GPBank.insert` / :meth:`GPBank.evict` membership churn.

A bank is immutable: every mutating method returns a new bank, and the old
one serves exactly as before.  A mutation clones the leaves it changes (the
JAX package's ``.at[].set`` does the same), with one exception: an update
with ``donate=True`` (``BankRouter(donate_updates=True)``) writes into the
old stack's storage, the counterpart of a donated JAX buffer, and the donor
bank raises on any later use.

The pipelined engine (``bank/engine.py``) serves through
:meth:`GPBank._serving_entry`: slot map, features function, B^{-1} and
feature table resolved once per bank object, the block's slots and rows
staged through pinned memory and copied without a host-device barrier,
its results copied back the same way behind a CUDA event that
:meth:`GPBank.result_ready` polls.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Hashable, Mapping, Optional, Sequence

import numpy as np
import torch

from ..core import fagp
from ..core.approximation import get_approximation, require_capability
from ..core.expansions import get_expansion
from ..core.fagp import FAGPState, GPSpec, _f32
from ..core.gp import GP
from ..core.mercer import SEKernelParams
from ..obs.watchdog import shape_tracked

__all__ = ["GPBank"]

_LEAVES = ("lam", "sqrtlam", "chol", "u", "b")


def _bank_mean_weights(chol, sqrtlam, b, sig2):
    """u_s = D_s B_s^{-1} D_s b_s / sig2 for every slot: chol (C, M, M),
    sqrtlam and b (C, M), sig2 shared or (C, 1) -> (C, M)."""
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


def _scatter(stack: torch.Tensor, slots, rows: torch.Tensor, donate: bool = False):
    """A new stack with ``rows`` written at ``slots`` (a device index tensor
    of distinct slots, or one int slot); with ``donate``, ``stack`` itself,
    written in place."""
    out = stack if donate else stack.clone()
    out[slots] = rows.to(out.device)
    return out


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a host-device barrier: on a card,
    staged through pinned memory and copied with ``non_blocking=True`` (the
    caching host allocator keeps the staging block until the copy is done);
    on the CPU, the array's own storage."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _group_noise(noise: torch.Tensor):
    """(noise for W (G, K, M), sig2 for the mean weights (G, M)): the bank's
    one noise, or one per group (G,) in a heterogeneous bank."""
    if noise.ndim == 0:
        return noise, noise**2
    return noise[:, None, None], (noise**2)[:, None]


def _keep_where(flag: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """Per group (leading axis): ``new`` where ``flag``, else ``old``."""
    return torch.where(flag.reshape(-1, *([1] * (new.ndim - 1))), new, old)


def _bank_update_scatter_impl(chol_s, u_s, b_s, sqrtlam_s, noise, slots, Phi_g,
                              y_g, mask_g, rank_update, donate=False):
    """Gather the slots' states, apply the rank-k update per group, scatter
    back.  Padded rows (mask 0) zero their feature row, which makes the
    rank-1 sweep an identity for them.  A *fully*-masked group (the
    router's group-axis padding) writes its gathered values back verbatim:
    the identity sweep is exact only up to sqrt rounding, and an untouched
    tenant must not drift.  The sweep runs on the gathered copy, never on
    the stack's storage, and nothing here reads a device value on the host.
    ``noise`` is the bank's or one per group (G,).  ``donate`` writes the
    results into the stack's own tensors instead of new ones."""
    Phi_g = Phi_g * mask_g[..., None]
    y_g = y_g * mask_g
    chol_g = chol_s[slots]
    d = sqrtlam_s[slots]
    nz, sig2 = _group_noise(noise)
    # B_new = B + sum_k v_k v_k^T,  v_k = D phi_k / sigma
    W = Phi_g * d[:, None, :] / nz
    ch = fagp._rank_k_chol(chol_g, W, rank_update)
    b_g = b_s[slots]
    bb = b_g + (Phi_g.mT @ y_g[..., None])[..., 0]
    uu = _bank_mean_weights(ch, d, bb, sig2)
    real = torch.amax(mask_g, dim=1) > 0
    return (_scatter(chol_s, slots, _keep_where(real, ch, chol_g), donate),
            _scatter(u_s, slots, _keep_where(real, uu, u_s[slots]), donate),
            _scatter(b_s, slots, _keep_where(real, bb, b_g), donate))


@shape_tracked
def _bank_update_scatter(*args):
    return _bank_update_scatter_impl(*args)


@shape_tracked
def _bank_update_scatter_donated(*args):
    """:func:`_bank_update_scatter` writing into the old stack's tensors:
    the caller owns the bank exclusively and drops the donor."""
    return _bank_update_scatter_impl(*args, donate=True)


@shape_tracked
def _bank_downdate_scatter(chol_s, u_s, b_s, sqrtlam_s, noise, slots, Phi_g,
                           y_g, mask_g, rank_downdate):
    """The downdate mirror of ``_bank_update_scatter``: gather the slots'
    states, remove the masked rank-k rows per group, B' = B - sum_k v_k v_k^T
    (v_k = D phi_k / sigma), by hyperbolic sweeps (never by subtracting and
    refactoring, which NaNs silently where positive definiteness is lost),
    and scatter into new stack tensors.  A group that lost a pivot, and a
    fully-masked padding group, leaves its slot bit-identical: the scatter
    discards its output, so the refit fallback starts from a consistent
    state.  Returns the new leaves and a (G,) ``ok`` flag per group on the
    device (a padding group reports ok: nothing to remove)."""
    Phi_g = Phi_g * mask_g[..., None]
    y_g = y_g * mask_g
    chol_g = chol_s[slots]
    d = sqrtlam_s[slots]
    nz, sig2 = _group_noise(noise)
    W = Phi_g * d[:, None, :] / nz
    ch, ok = rank_downdate(chol_g, W)
    b_g = b_s[slots]
    bb = b_g - (Phi_g.mT @ y_g[..., None])[..., 0]
    uu = _bank_mean_weights(ch, d, bb, sig2)
    real = torch.amax(mask_g, dim=1) > 0
    good = ok & real
    return (_scatter(chol_s, slots, _keep_where(good, ch, chol_g)),
            _scatter(u_s, slots, _keep_where(good, uu, u_s[slots])),
            _scatter(b_s, slots, _keep_where(good, bb, b_g)), ok | ~real)


@shape_tracked
def _bank_refit_scatter(leaves: dict, slots, fresh: dict, mask_g) -> dict:
    """New stack leaves with the refit's ``fresh`` per-group leaves written
    at ``slots``; a fully-masked padding group writes its slot's own values
    back verbatim."""
    real = torch.amax(mask_g, dim=1) > 0
    return {f: _scatter(old, slots, _keep_where(real, fresh[f], old[slots]))
            for f, old in leaves.items()}


@shape_tracked
def _hetero_gathered_mean_var(stack, binv, slots, Xq, eps_s, rho_s, backend, cache):
    """Mixed-tenant serving of a heterogeneous bank: each row's features
    under its slot's (eps, rho) (one launch of the features kernel with
    per-row constants on the ``pallas`` backend), then the gathered
    posterior."""
    Phis = backend.slot_features(Xq, stack.spec, stack.idx, eps_s, rho_s, slots, stack, cache)
    return fagp._bank_gathered_posterior(binv, stack.u, stack.sqrtlam, slots, Phis)


def _bank_hetero_refit(Xb, yb, maskb, eps_b, rho_b, noise_b, spec, idx):
    """Batched refit of B tenants, each under ITS OWN hyperparameters
    (eps_b, rho_b (B, p), noise_b (B,)): the backend's ``bank_moments`` with
    per-slot maps (one launch of the bank kernel on the ``pallas`` backend,
    no N x M Phi), then the batched scaled solve, each slot with its own
    eigenvalue row and noise.  Returns stacked (lam, sqrtlam, chol, u, b)."""
    backend = fagp.get_backend(spec.backend)
    B = Xb.shape[0]
    G, b = backend.bank_moments(Xb.contiguous(), yb.contiguous(), spec, idx,
                                spec.block_rows, maskb.contiguous(), hypers=(eps_b, rho_b))
    loglam = get_expansion(spec.expansion).log_eigenvalues(
        idx, spec.replace(eps=eps_b, rho=rho_b)).expand(B, -1).contiguous()
    sig2 = noise_b**2
    Bm, sqrtlam = fagp._assemble_scaled_system(G, loglam, sig2[:, None, None])
    del G
    chol = torch.linalg.cholesky(Bm)
    u = _bank_mean_weights(chol, sqrtlam, b, sig2[:, None])
    return torch.exp(loglam), sqrtlam, chol, u, b


@shape_tracked
def _write_slot(stack: FAGPState, slot: int, values: dict) -> dict:
    """New leaves with one tenant's values written at ``slot`` (a host int:
    no index tensor to copy to the card)."""
    return {f: _scatter(getattr(stack, f), slot, values[f]) for f in _LEAVES}


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


def _check_single_task(state: FAGPState, who: str) -> None:
    if state.u.ndim != 1:
        raise ValueError(
            f"{who}: multi-output states (T={state.n_tasks}) cannot join a "
            f"bank; banks batch over tenants, one task each"
        )


def _check_family(state) -> None:
    """Bank admission is a capability of the state's family ('bank'): a
    Vecchia session is refused with the structured ``UnsupportedError``."""
    require_capability(get_approximation(state.spec.approximation), "bank", state.spec)


def _check_bankable(state: FAGPState, spec: GPSpec, who: str) -> None:
    """A state can join a homogeneous bank iff it was factorized under the
    bank's shared spec (structure AND hyperparameters, including any RFF
    spectral draws) and is single-output."""
    _check_family(state)
    fagp._check_spec_regenerates_idx(state, spec)
    try:
        fagp._check_hypers_match(state, spec, who)
    except ValueError as e:
        raise ValueError(
            f"{e}; a bank shares one feature map and one eigenvalue "
            f"scaling across all tenants — refit the tenant under the "
            f"bank spec"
        ) from None
    _check_single_task(state, who)


def _check_bankable_hetero(state: FAGPState, spec: GPSpec, who: str) -> None:
    """A heterogeneous bank admits any tenant sharing the bank's expansion
    STRUCTURE: eps/rho/noise may differ per slot, but the expansion family,
    truncation and any RFF spectral draws stay bank-wide (they define the
    shared index table and, for RFF, the shared base frequencies)."""
    _check_family(state)
    for f in fagp._STRUCTURAL_FIELDS:
        if getattr(state.spec, f) != getattr(spec, f):
            raise ValueError(
                f"{who}: spec/state mismatch: state was fitted with "
                f"{state.spec.describe()} but the bank holds "
                f"{spec.describe()}; even a heterogeneous bank shares one "
                f"expansion structure — refit the tenant"
            )
    if not fagp._leaf_equal(state.spec.omega, spec.omega):
        raise ValueError(
            f"{who}: omega differs from the bank's spectral draws; the "
            f"RFF base frequencies are bank structure even in a "
            f"heterogeneous bank — refit the tenant under the bank's draws"
        )
    fagp._check_spec_regenerates_idx(state, state.spec)
    _check_single_task(state, who)


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


def _check_batch(who: str, X, y, ids, what: str, names=("Xk", "yk", "k")):
    """X (G, k, p) and y (G, k), one distinct tenant id per group."""
    x, yn, k = names
    if X.ndim != 3 or tuple(y.shape) != tuple(X.shape[:2]):
        raise ValueError(
            f"GPBank.{who} wants {x} (G, {k}, p) and {yn} (G, {k}); got "
            f"{tuple(X.shape)} and {tuple(y.shape)}"
        )
    if len(set(ids)) != len(ids):
        raise ValueError(
            f"duplicate tenant in one {what} batch ({ids!r}): the "
            f"scattered writes would collide — split into rounds"
            + (" (BankRouter.ingest does this)" if what == "update" else "")
        )
    if len(ids) != X.shape[0]:
        raise ValueError(
            f"one tenant id per {what} group: got {len(ids)} ids for "
            f"{X.shape[0]} groups"
        )


@dataclasses.dataclass(frozen=True, eq=False)
class GPBank:
    """A fixed-capacity bank of independent GP sessions (see module doc).

    Construct with :meth:`fit`, :meth:`create` or :meth:`from_states` (or
    ``core.convert.bank_from_numpy``); the default constructor is internal.

    stack:  stacked FAGPState: bank axis on chol/u/b/lam/sqrtlam, shared
            idx and spec.
    active: (capacity,) host-side bool mask of occupied slots.
    slots:  tenant id -> slot index (insertion order preserved).
    hypers: None for a homogeneous bank (every tenant under the spec's
            eps/rho/noise), or per-slot
            :class:`~repro_torch.core.mercer.SEKernelParams` (eps and rho
            (C, p), noise (C,)) once :meth:`optimize` has learned
            per-tenant values; serving then builds each query row's
            features under its own slot's hyperparameters.
    """

    stack: FAGPState
    active: np.ndarray
    slots: Mapping[Hashable, int]
    hypers: Optional[SEKernelParams] = None

    def __post_init__(self):
        h = self.hypers
        if h is None:
            return
        if not isinstance(h, SEKernelParams):
            raise TypeError(
                f"GPBank.hypers must be None or a SEKernelParams of per-slot "
                f"eps and rho (C, p) and noise (C,), got {type(h).__name__}")
        C, p = self.capacity, self.stack.spec.p
        for f, want in (("eps", (C, p)), ("rho", (C, p)), ("noise", (C,))):
            leaf = getattr(h, f)
            if tuple(leaf.shape) != want or leaf.dtype != torch.float32 \
                    or leaf.device != self.stack.spec.device:
                raise ValueError(
                    f"GPBank.hypers.{f} must be float32 {want} on "
                    f"{self.stack.spec.device}, got {leaf.dtype} {tuple(leaf.shape)} "
                    f"on {leaf.device}")

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

    def _check_live(self) -> None:
        """Raise on a bank whose stack was donated to an update (the
        counterpart of reading a donated JAX buffer)."""
        if self.__dict__.get("_donated"):
            raise RuntimeError(
                "this GPBank's stack was donated to an update (donate=True) and "
                "written in place; use the bank that update returned"
            )

    def state(self, tenant: Hashable) -> FAGPState:
        """The tenant's session, unstacked: a normal single-model FAGPState
        usable with every ``fagp``/``GP`` entry point.  In a heterogeneous
        bank its spec carries the tenant's OWN hyperparameters."""
        self._check_live()
        s = self.slot_of(tenant)
        st = dataclasses.replace(
            self.stack, **{f: getattr(self.stack, f)[s] for f in _LEAVES})
        if self.hypers is not None:
            h = self.hypers
            st = dataclasses.replace(st, spec=self.spec.replace(
                eps=h.eps[s], rho=h.rho[s], noise=h.noise[s]))
        return st

    def states(self) -> dict:
        """All tenants' sessions, unstacked (tenant -> FAGPState)."""
        return {t: self.state(t) for t in self.slots}

    def _stacked_hypers(self) -> SEKernelParams:
        """Per-slot hyperparameters, materialized: the overlay when
        heterogeneous, the shared spec values broadcast when not."""
        if self.hypers is not None:
            return self.hypers
        sp, C = self.spec, self.capacity
        return SEKernelParams(eps=sp.eps.expand(C, -1), rho=sp.rho.expand(C, -1),
                              noise=sp.noise.expand(C))

    def _with(self, leaves: dict, **fields) -> "GPBank":
        """A new bank with the stack's ``leaves`` (and any bank ``fields``)
        replaced; the expansion's feature table rides along, and so do the
        per-slot feature maps while the hyperparameters stay."""
        stack = dataclasses.replace(self.stack, **leaves)
        if "tile" in self.stack.serving:
            stack.serving["tile"] = self.stack.serving["tile"]
        new = dataclasses.replace(self, stack=stack, **fields)
        if "hypers" not in fields and "_slot_cache" in self.__dict__:
            object.__setattr__(new, "_slot_cache", self.__dict__["_slot_cache"])
        return new

    @property
    def _slot_maps(self) -> dict:
        """The backend's per-slot feature maps of this bank's overlay
        (``slot_features``' cache), kept while the hyperparameters stay."""
        cache = self.__dict__.get("_slot_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_slot_cache", cache)
        return cache

    @property
    def _binv(self) -> torch.Tensor:
        """Per-slot B^{-1} serving cache (C, M, M), computed on first use and
        kept on the instance: a bank is immutable, so it never goes stale.
        Mutations that know their slots carry it forward with only those
        rows refreshed (``_carry_binv_into``)."""
        self._check_live()
        cached = self.__dict__.get("_binv_cache")
        if cached is None:
            cached = fagp._bank_binv(self.stack.chol)
            object.__setattr__(self, "_binv_cache", cached)
        return cached

    def _carry_binv_into(self, new: "GPBank", slots, donate: bool = False) -> None:
        """If this bank already paid for the full cache, hand it to ``new``
        with the rows of ``slots`` (a device index tensor, or one int slot)
        refreshed, instead of making the next query recompute B^{-1} for
        the whole capacity; with ``donate``, refreshed in place."""
        cached = self.__dict__.get("_binv_cache")
        if cached is not None:
            if isinstance(slots, int):
                rows = fagp._bank_binv(new.stack.chol, slice(slots, slots + 1))[0]
            else:
                rows = fagp._bank_binv(new.stack.chol, slots)
            object.__setattr__(new, "_binv_cache", _scatter(cached, slots, rows, donate))

    def _slots_for(self, tenant_ids) -> torch.Tensor:
        if isinstance(tenant_ids, (str, bytes)) or not hasattr(tenant_ids, "__iter__"):
            raise TypeError(
                "tenant_ids must be a sequence of tenant ids, one per row "
                f"(got a scalar {tenant_ids!r}); for a single-tenant batch "
                "pass [tenant] * len(Xq)"
            )
        return _to_device(np.fromiter((self.slot_of(t) for t in tenant_ids), np.int64),
                          self.spec.device)

    def _group_slots(self, slots, G: int, who: str) -> torch.Tensor:
        """``slots`` as a device index tensor of G distinct slots.  Host
        slots (a list, an array, a CPU tensor) are checked on the host and
        copied without a barrier; a device tensor is checked on the device."""
        if isinstance(slots, torch.Tensor) and slots.device.type != "cpu":
            if tuple(slots.shape) != (G,) or torch.unique(slots).numel() != G:
                raise ValueError(f"{who} wants {G} distinct slots, got {slots.tolist()}")
            return slots.to(torch.long)
        if isinstance(slots, torch.Tensor):
            slots = slots.numpy()
        arr = np.asarray(slots, dtype=np.int64)
        if arr.shape != (G,) or np.unique(arr).size != G:
            raise ValueError(f"{who} wants {G} distinct slots, got {arr.tolist()}")
        return _to_device(arr, self.spec.device)

    def _group_features(self, slots: torch.Tensor, Xk: torch.Tensor):
        """(Phi (G, k, M), noise) of the groups ``Xk`` (G, k, p) aimed at
        ``slots``: under the bank's spec (noise the spec's), or in a
        heterogeneous bank each group under its slot's hyperparameters
        (noise (G,), one per group)."""
        G, k, p = Xk.shape
        backend = fagp._check_backend_support(self.spec)
        flat = Xk.reshape(G * k, p)
        if self.hypers is None:
            Phi = backend.features(flat, self.spec, self.stack.idx, self.stack)
            return Phi.reshape(G, k, -1), self.spec.noise
        h = self.hypers
        Phi = backend.slot_features(flat, self.spec, self.stack.idx, h.eps, h.rho,
                                    slots.repeat_interleave(k), self.stack, self._slot_maps)
        return Phi.reshape(G, k, -1), h.noise[slots]

    # -- the batched pipeline ----------------------------------------------

    @staticmethod
    def result_ready(*events) -> bool:
        """Have these dispatched results landed?  The engine polls this with
        the CUDA event recorded after a block's result copies
        (``Event.query()``, never a wait) to harvest finished blocks without
        blocking on an unfinished one.  Anything else (a CPU block's None)
        reports ready, as the JAX package's arrays without readiness
        introspection do."""
        return all(e.query() for e in events if isinstance(e, torch.cuda.Event))

    def _serving_entry(self):
        """The pipelined engine's lean serving call, resolved once per bank
        object (kept on the instance): slot map, features function, B^{-1}
        and feature table are looked up here, not per block, and nothing is
        validated per row.  Returns ``call(slots, Xq)`` for host ``slots``
        (Q,) int64 and ``Xq`` (Q, p) float32 arrays, giving ``(mu, var,
        event)``.  On a card the inputs reach the device by non-blocking
        copies from pinned memory (:func:`_to_device`), the results come
        back by non-blocking copies into pinned host tensors, and ``event``
        is recorded after those copies, so dispatching a block never waits
        for the device.  On the CPU the results are the computed tensors
        and ``event`` is None."""
        call = self.__dict__.get("_serving_cache")
        if call is not None:
            return call
        stack, binv, dev = self.stack, self._binv, self.spec.device
        backend = fagp._check_backend_support(self.spec)
        if self.hypers is None:
            serve = fagp._gathered_bank_mean_var(backend.features)

            def compute(slots, Xq):
                return serve(stack, binv, slots, Xq)
        else:
            eps_s, rho_s, cache = self.hypers.eps, self.hypers.rho, self._slot_maps

            def compute(slots, Xq):
                return _hetero_gathered_mean_var(stack, binv, slots, Xq, eps_s, rho_s,
                                                 backend, cache)

        def call(slots, Xq):
            mu, var = compute(_to_device(slots, dev), _to_device(Xq, dev))
            if dev.type != "cuda":
                return mu, var, None
            # a non-blocking copy to the host lands in pinned memory, which
            # the caching host allocator keeps until the copy is done
            hmu, hvar = mu.to("cpu", non_blocking=True), var.to("cpu", non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            return hmu, hvar, event

        object.__setattr__(self, "_serving_cache", call)
        return call

    def mean_var(self, tenant_ids, Xq):
        """Posterior mean and marginal variance for a MIXED-tenant query
        batch: row q of ``Xq`` (Q, p) is answered by ``tenant_ids[q]``'s
        posterior."""
        self._check_live()
        Xq = _f32(Xq, self.spec.device)
        slots = self._slots_for(tenant_ids)
        if Xq.ndim != 2 or slots.shape[0] != Xq.shape[0]:
            raise ValueError(
                f"one tenant id per query row: got {slots.shape[0]} ids "
                f"for Xq of shape {tuple(Xq.shape)}"
            )
        fagp._check_p(self.spec, Xq.shape[1])
        backend = fagp._check_backend_support(self.spec)
        if self.hypers is None:
            serve = fagp._gathered_bank_mean_var(backend.features)
            return serve(self.stack, self._binv, slots, Xq)
        h = self.hypers
        return _hetero_gathered_mean_var(self.stack, self._binv, slots, Xq, h.eps, h.rho,
                                         backend, self._slot_maps)

    def update(self, tenant_ids, Xk, yk, mask=None) -> "GPBank":
        """Batched rank-k ingest: group g absorbs (Xk[g], yk[g]) into tenant
        ``tenant_ids[g]``'s factorization.  ``mask`` (G, k) zeroes padded
        rows (ragged ingest).  Tenants must be distinct within one call
        (the scattered writes would collide); the router splits them into
        rounds."""
        dev = self.spec.device
        Xk, yk = _f32(Xk, dev), _f32(yk, dev)
        ids = list(tenant_ids)
        _check_batch("update", Xk, yk, ids, "update")
        return self._update_at_slots(self._slots_for(ids), Xk, yk, mask)

    def _update_at_slots(self, slots, Xk, yk, mask=None,
                         donate: bool = False) -> "GPBank":
        """Slot-addressed core of :meth:`update`, and the router's entry: a
        fully-masked group leaves its slot untouched, so the router pads
        the group axis to a power-of-two bucket with masked groups aimed at
        distinct unused slots.  Slots must be distinct.

        ``donate=True`` writes the update into this bank's chol/u/b tensors
        and its B^{-1} cache in place instead of cloning them (no second
        800 MB stack at the fleet's width), and this bank then raises on
        use.  Reserved for serving loops that own their bank exclusively
        (``BankRouter(donate_updates=True)``).  Blocks dispatched before the
        update still read the old values: they were queued on the same
        stream ahead of the in-place writes, which the device runs in
        order; the port keeps every launch on the current stream."""
        self._check_live()
        dev = self.spec.device
        Xk, yk = _f32(Xk, dev), _f32(yk, dev)
        G, k, p = Xk.shape
        fagp._check_p(self.spec, p)
        mask = _as_mask(mask, (G, k), dev, "GPBank.update")
        slots = self._group_slots(slots, G, "update")
        backend = fagp._check_backend_support(self.spec)
        Phi_g, noise = self._group_features(slots, Xk)
        scatter = _bank_update_scatter_donated if donate else _bank_update_scatter
        chol, u, b = scatter(
            self.stack.chol, self.stack.u, self.stack.b, self.stack.sqrtlam,
            noise, slots, Phi_g, yk, mask, backend.rank_update,
        )
        new = self._with(dict(chol=chol, u=u, b=b))
        self._carry_binv_into(new, slots, donate)
        if donate:
            object.__setattr__(self, "_donated", True)
        return new

    # -- sliding-window forgetting (rank-k downdate + refit fallback) -------

    def downdate(self, tenant_ids, Xk, yk, mask=None):
        """Batched rank-k FORGET: group g removes previously absorbed rows
        (Xk[g], yk[g]) from tenant ``tenant_ids[g]``'s factorization, by
        hyperbolic rank-1 downdate sweeps (one launch of the batched
        downdate kernel on the ``pallas`` backend).  ``mask`` (G, k) zeroes
        padded rows.  Tenants must be distinct within one call.

        Returns ``(bank, ok)`` where ``ok`` is a host (G,) bool array: a
        group whose downdate lost positive definiteness kept its slot
        bit-exactly UNCHANGED (ok False); re-factorize it from retained
        data with :meth:`refit_window`."""
        dev = self.spec.device
        Xk, yk = _f32(Xk, dev), _f32(yk, dev)
        ids = list(tenant_ids)
        _check_batch("downdate", Xk, yk, ids, "downdate")
        return self._downdate_at_slots(self._slots_for(ids), Xk, yk, mask)

    def _downdate_at_slots(self, slots, Xk, yk, mask=None):
        """Slot-addressed core of :meth:`downdate`, the fixed-shape entry:
        fully-masked padding groups on distinct slots leave their slots
        bit-identical and report ok."""
        self._check_live()
        dev = self.spec.device
        Xk, yk = _f32(Xk, dev), _f32(yk, dev)
        G, k, p = Xk.shape
        fagp._check_p(self.spec, p)
        mask = _as_mask(mask, (G, k), dev, "GPBank.downdate")
        slots = self._group_slots(slots, G, "downdate")
        backend = fagp._check_backend_support(self.spec)
        Phi_g, noise = self._group_features(slots, Xk)
        chol, u, b, ok = _bank_downdate_scatter(
            self.stack.chol, self.stack.u, self.stack.b, self.stack.sqrtlam,
            noise, slots, Phi_g, yk, mask, backend.rank_downdate,
        )
        new = self._with(dict(chol=chol, u=u, b=b))
        self._carry_binv_into(new, slots)
        return new, ok.cpu().numpy()

    def refit_window(self, tenant_ids, Xw, yw, mask=None) -> "GPBank":
        """Re-factorize ``tenant_ids`` from scratch on their RETAINED window
        data (Xw (G, W, p), yw (G, W), mask (G, W) for ragged windows), each
        under its own slot's hyperparameters, its eigenvalue row rewritten:
        one launch of the bank kernel with per-slot maps on the ``pallas``
        backend.  The fallback for downdates that lost positive
        definiteness, and the reference the downdate is held against
        (<= 1e-5)."""
        dev = self.spec.device
        Xw, yw = _f32(Xw, dev), _f32(yw, dev)
        ids = list(tenant_ids)
        _check_batch("refit_window", Xw, yw, ids, "refit", names=("Xw", "yw", "W"))
        return self._refit_at_slots(self._slots_for(ids), Xw, yw, mask)

    def _refit_at_slots(self, slots, Xw, yw, mask=None) -> "GPBank":
        """Slot-addressed core of :meth:`refit_window` (the fixed-shape
        entry; fully-masked padding groups leave their slots untouched)."""
        self._check_live()
        dev = self.spec.device
        Xw, yw = _f32(Xw, dev), _f32(yw, dev)
        G, W, p = Xw.shape
        fagp._check_p(self.spec, p)
        mask = _as_mask(mask, (G, W), dev, "GPBank.refit_window")
        slots = self._group_slots(slots, G, "refit_window")
        fagp._check_backend_support(self.spec)
        hyp = self._stacked_hypers()
        spec_r = self.spec.replace(block_rows=min(self.spec.block_rows, max(1, W)))
        fresh = dict(zip(_LEAVES, _bank_hetero_refit(
            Xw, yw, mask, hyp.eps[slots], hyp.rho[slots], hyp.noise[slots], spec_r,
            self.stack.idx)))
        new = self._with(_bank_refit_scatter(
            {f: getattr(self.stack, f) for f in _LEAVES}, slots, fresh, mask))
        self._carry_binv_into(new, slots)
        return new

    # -- membership churn ---------------------------------------------------

    def insert(self, tenant: Hashable, source) -> "GPBank":
        """Add a tenant into the first free slot.  ``source`` is a fitted
        ``GP`` / ``FAGPState`` sharing the bank's spec (in a heterogeneous
        bank: its structure, under any hyperparameters), or an ``(X, y)``
        tuple fitted under the bank's spec.  Raises when full or when the
        id is taken."""
        self._check_live()
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
        if self.hypers is None:
            _check_bankable(st, self.spec, f"insert({tenant!r})")
        else:
            _check_bankable_hetero(st, self.spec, f"insert({tenant!r})")
        slot = int(free[0])
        leaves = _write_slot(self.stack, slot, {f: getattr(st, f).to(self.spec.device)
                                                for f in _LEAVES})
        fields = {}
        if self.hypers is not None:
            fields["hypers"] = self._overlay_with(slot, st.spec)
        active = self.active.copy()
        active[slot] = True
        new = self._with(leaves, active=active, slots={**self.slots, tenant: slot}, **fields)
        self._carry_binv_into(new, slot)
        return new

    def evict(self, tenant: Hashable) -> "GPBank":
        """Remove a tenant; its slot is reset to the prior state (under the
        bank spec's own hyperparameters) and becomes reusable by the next
        :meth:`insert`."""
        self._check_live()
        slot = self.slot_of(tenant)
        loglam = get_expansion(self.spec.expansion).log_eigenvalues(
            self.stack.idx, self.spec)
        prior = _prior_leaves(loglam, 1)
        leaves = _write_slot(self.stack, slot, {f: prior[f][0] for f in _LEAVES})
        fields = {}
        if self.hypers is not None:
            fields["hypers"] = self._overlay_with(slot, self.spec)
        active = self.active.copy()
        active[slot] = False
        slots = {t: s for t, s in self.slots.items() if t != tenant}
        new = self._with(leaves, active=active, slots=slots, **fields)
        self._carry_binv_into(new, slot)
        return new

    def _overlay_with(self, slot: int, sp: GPSpec) -> SEKernelParams:
        """The overlay with ``slot`` set to ``sp``'s (eps, rho, noise)."""
        h = self.hypers
        return SEKernelParams(
            **{f: _scatter(getattr(h, f), slot, _f32(getattr(sp, f), self.spec.device))
               for f in ("eps", "rho", "noise")})

    # -- fleet-scale hyperparameter optimization ----------------------------

    def optimize(
        self,
        Xb,
        yb,
        *,
        tenant_ids: Optional[Sequence[Hashable]] = None,
        mask=None,
        restarts: int = 4,
        steps: int = 100,
        lr: float = 5e-2,
        tol: Optional[float] = None,
        jitter: float = 0.3,
        seed: int = 0,
        callback=None,
        metrics=None,
        tracer=None,
    ) -> "GPBank":
        """Learn per-tenant hyperparameters for the fleet in one batched run,
        then refit the winners back into the stacked state.

        Runs the (B tenants x R restarts) lane engine
        (``repro_torch.optim.gp_hyperopt.optimize_fleet``; each lane's
        arithmetic is that of a single-tenant ``GP.optimize`` run), then
        one refit of the B tenants, each under its own learned (eps, rho,
        noise) (one launch of the bank kernel with per-slot maps on the
        ``pallas`` backend).

        Xb (B, N, p) / yb (B, N) carry each tenant's training data in the
        row order of ``tenant_ids`` (default: every tenant in insertion
        order); ``mask`` (B, N) expresses ragged per-tenant N.  ``restarts``
        jittered inits per tenant, the best selected by final NLML;
        ``tol`` freezes converged lanes.

        Returns a new HETEROGENEOUS bank: the optimized slots hold
        factorizations under their own learned hyperparameters, with their
        own eigenvalue rows.  A bank that is already heterogeneous starts
        from each tenant's current values.  ``metrics`` / ``tracer``
        (``repro_torch.obs``) forward to ``optimize_fleet``'s progress
        telemetry.
        """
        from ..optim.gp_hyperopt import optimize_fleet

        self._check_live()
        dev = self.spec.device
        Xb, yb = _f32(Xb, dev), _f32(yb, dev)
        if Xb.ndim != 3 or yb.ndim != 2 or tuple(yb.shape) != tuple(Xb.shape[:2]):
            raise ValueError(
                f"GPBank.optimize wants Xb (B, N, p) and yb (B, N); got "
                f"{tuple(Xb.shape)} and {tuple(yb.shape)}"
            )
        B, N, p = Xb.shape
        fagp._check_p(self.spec, p)
        ids = list(self.tenants if tenant_ids is None else tenant_ids)
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate tenant in optimize batch ({ids!r})")
        if len(ids) != B:
            raise ValueError(f"one tenant id per data row: got {len(ids)} ids for {B} rows")
        slots = self._slots_for(ids)
        if mask is not None:
            mask = _as_mask(mask, (B, N), dev, "GPBank.optimize")
        init = None
        if self.hypers is not None:
            init = {f: getattr(self.hypers, f)[slots] for f in ("eps", "rho", "noise")}
        res = optimize_fleet(
            Xb, yb, self.spec, mask=mask, restarts=restarts, steps=steps, lr=lr,
            tol=tol, jitter=jitter, seed=seed, init=init, callback=callback,
            metrics=metrics, tracer=tracer,
        )
        maskb = torch.ones((B, N), dtype=torch.float32, device=dev) if mask is None else mask
        spec_r = self.spec.replace(block_rows=min(self.spec.block_rows, max(1, N)))
        fresh = _bank_hetero_refit(Xb, yb, maskb, res.eps, res.rho, res.noise, spec_r,
                                   self.stack.idx)
        leaves = {f: _scatter(getattr(self.stack, f), slots, v)
                  for f, v in zip(("lam", "sqrtlam", "chol", "u", "b"), fresh)}
        hyp = self._stacked_hypers()
        hypers = SEKernelParams(**{f: _scatter(getattr(hyp, f), slots, getattr(res, f))
                                   for f in ("eps", "rho", "noise")})
        new = self._with(leaves, hypers=hypers)
        self._carry_binv_into(new, slots)
        return new
