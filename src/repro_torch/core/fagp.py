"""Fast Approximate Gaussian Process (FAGP): fit, serve, update, NLML.

Counterpart of ``repro/core/fagp.py`` (paper Eqs. 8-12).  The N x N kernel
inverse is replaced, through the Woodbury identity, by the M x M system

    B = I + D G D / sigma^2,   G = Phi^T Phi,   D = diag(sqrt(lambda))

assembled in log space in one place (``_assemble_scaled_system``), so
eigenvalues that underflow float32 leave inert identity rows.

    spec = GPSpec.create(n=8, eps=[0.8, 0.8], noise=0.05, device="cuda")
    state = fit(X, y, spec)                 # spec baked into the state
    mu, var = predict_mean_var(state, Xs)   # serving path
    state = fit_update(state, X_new, y_new) # rank-k ingest, no refit
    loss = nlml(X, y, spec)

Execution goes through a registry of backends that keeps the JAX names so a
spec carries across unchanged:

* ``"jnp"``    -- the plain path: row blocks of the expansion's feature
  map accumulated with matmuls, triangular solves for the variance;
* ``"pallas"`` -- the kernel path: the streaming fused fit, the expansion
  features and the diag-quad kernels of ``kernels/`` (hand-written CUDA on
  a CUDA tensor, their plain versions on a CPU tensor), and the rank-K
  Cholesky sweep kernel for ``fit_update``.

Everything is float32 on the spec's device; inputs are moved there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import chol_update as _chol
from ..kernels import ops
from ..obs.watchdog import shape_tracked
from .approximation import (
    Approximation,
    UnsupportedError,
    get_approximation,
    register_approximation,
)
from .expansions import available_expansions, get_expansion

__all__ = [
    "FAGPState",
    "FitBackend",
    "GPSpec",
    "available_backends",
    "available_expansions",
    "build_features",
    "fit",
    "fit_update",
    "get_backend",
    "get_expansion",
    "nlml",
    "predict",
    "predict_mean_var",
    "register_backend",
]


def _f32(x, device) -> torch.Tensor:
    """x (tensor, numpy, JAX array, list or scalar) as float32 on device."""
    if not isinstance(x, torch.Tensor):
        x = np.array(x, dtype=np.float32)   # a writable copy
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class GPSpec:
    """The one self-describing specification of a GP session.

    eps:   per-dimension inverse length scales, (p,).
    rho:   per-dimension Mercer scale factors, (p,) (unused by RFF).
    noise: observation noise std sigma_n (scalar tensor).
    omega: (R, p) eps-free spectral base draws for the RFF expansions.
    n / index_set / degree: Hermite truncation (``mercer.make_index_set``).
    block_rows: row-block size of the plain moment accumulation.
    store_train: keep (Phi, y) in the fitted state (needed for
        ``predict(mode="paper")``; costs an N x M buffer).
    backend: 'jnp' (plain) or 'pallas' (kernels).
    expansion: 'hermite' | 'rff_se' | 'rff_matern52'.
    approximation: registered family, 'fagp' (default) or 'vecchia'
        (``core/vecchia.py``).
    kernel / neighbors: the Vecchia family's structure (the exact
        reference kernel 'se' | 'matern52', the conditioning-set size k);
        None on 'fagp' specs, whose structure is the expansion.

    The tensors live on one device (``spec.device``), which every fit and
    prediction of the session runs on.
    """

    eps: torch.Tensor
    rho: torch.Tensor
    noise: torch.Tensor
    n: int
    index_set: str = "full"
    degree: Optional[int] = None
    block_rows: int = 4096
    store_train: bool = False
    backend: str = "jnp"
    expansion: str = "hermite"
    omega: Optional[torch.Tensor] = None
    approximation: str = "fagp"
    kernel: Optional[str] = None
    neighbors: Optional[int] = None

    @staticmethod
    def create(
        n: int,
        eps,
        rho=2.0,
        noise=1e-2,
        *,
        index_set: str = "full",
        degree: Optional[int] = None,
        block_rows: int = 4096,
        store_train: bool = False,
        backend: str = "jnp",
        expansion: str = "hermite",
        num_features: Optional[int] = None,
        seed: int = 0,
        omega=None,
        approximation: str = "fagp",
        kernel: Optional[str] = None,
        neighbors: Optional[int] = None,
        device=None,
    ) -> "GPSpec":
        """Constructor with scalar broadcasting (``eps`` fixes p).  The RFF
        families draw their base frequencies here from (num_features, seed)
        with numpy, exactly as the JAX package does.  ``device`` defaults to
        "cuda" and raises where there is no card."""
        dev = resolve_device(device)
        eps = torch.atleast_1d(_f32(eps, dev))
        rho = torch.broadcast_to(_f32(rho, dev), eps.shape).clone()
        exp = get_expansion(expansion)
        if omega is None:
            if num_features is not None and num_features < 1:
                raise ValueError(f"num_features must be >= 1, got {num_features}")
            omega = exp.draw_spec_data(
                eps.shape[0], 256 if num_features is None else num_features, seed
            )
            if omega is None and num_features is not None:
                raise ValueError(
                    f"expansion {expansion!r} draws no spectral data; "
                    f"num_features only applies to the RFF families — did "
                    f"you mean expansion='rff_se' / 'rff_matern52'?"
                )
        elif exp.draw_spec_data(1, 1, 0) is None:
            raise ValueError(
                f"expansion {expansion!r} takes no omega (it draws no "
                f"spectral data)"
            )
        elif num_features is not None and len(omega) != num_features:
            raise ValueError(
                f"explicit omega has {len(omega)} rows but "
                f"num_features={num_features}"
            )
        spec = GPSpec(
            eps=eps, rho=rho, noise=_f32(noise, dev), n=int(n),
            index_set=index_set, degree=degree, block_rows=block_rows,
            store_train=store_train, backend=backend, expansion=expansion,
            omega=None if omega is None else _f32(omega, dev),
            approximation=approximation, kernel=kernel,
            neighbors=None if neighbors is None else int(neighbors),
        )
        get_approximation(approximation).validate(spec)
        return spec

    @staticmethod
    def create_rff(eps, noise=1e-2, *, kernel: str = "se",
                   num_features: int = 256, seed: int = 0, rho=2.0,
                   block_rows: int = 4096, store_train: bool = False,
                   backend: str = "jnp", device=None) -> "GPSpec":
        """Sugar for the RFF families: M = 2 * num_features."""
        return GPSpec.create(
            1, eps, rho, noise, block_rows=block_rows,
            store_train=store_train, backend=backend,
            expansion=f"rff_{kernel}", num_features=num_features, seed=seed,
            device=device,
        )

    @staticmethod
    def create_vecchia(eps, noise=1e-2, *, kernel: str = "se", neighbors: int = 32,
                       rho=2.0, block_rows: int = 4096, backend: str = "jnp",
                       device=None) -> "GPSpec":
        """Sugar for the Vecchia nearest-neighbour family
        (``core/vecchia.py``): ``kernel`` names the exact reference kernel
        ('se' | 'matern52'), ``neighbors`` is the conditioning-set size k.
        The expansion fields are inert for this family."""
        return GPSpec.create(
            1, eps, rho, noise, block_rows=block_rows, backend=backend,
            approximation="vecchia", kernel=kernel, neighbors=neighbors,
            device=device,
        )

    @property
    def p(self) -> int:
        return self.eps.shape[0]

    @property
    def device(self) -> torch.device:
        return self.eps.device

    def indices(self, p: Optional[int] = None) -> np.ndarray:
        """The expansion's static (M, w) index table; its row count is M."""
        return get_expansion(self.expansion).indices(self, p or self.p)

    def n_features(self, p: Optional[int] = None) -> int:
        return self.indices(p).shape[0]

    def replace(self, **overrides) -> "GPSpec":
        return dataclasses.replace(self, **overrides)

    def describe(self) -> str:
        if self.approximation != "fagp":
            return (
                f"GPSpec(approximation={self.approximation!r}, "
                f"kernel={self.kernel!r}, neighbors={self.neighbors}, "
                f"p={self.p}, backend={self.backend!r}, "
                f"device={str(self.device)!r})"
            )
        extra = (
            f"n={self.n}, index_set={self.index_set!r}, degree={self.degree}"
            if self.expansion == "hermite"
            else f"R={0 if self.omega is None else self.omega.shape[0]}"
        )
        return (
            f"GPSpec(expansion={self.expansion!r}, {extra}, p={self.p}, "
            f"backend={self.backend!r}, store_train={self.store_train}, "
            f"device={str(self.device)!r})"
        )


# fields frozen into the factorization: with_spec may not change them (for
# vecchia the kernel and the neighbour count likewise define the session)
_STRUCTURAL_FIELDS = ("approximation", "expansion", "n", "index_set", "degree",
                      "kernel", "neighbors")
_HYPER_FIELDS = ("eps", "rho", "noise", "omega")


def _leaf_equal(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    a = torch.as_tensor(a).detach().to("cpu", torch.float32)
    b = torch.as_tensor(b).detach().to("cpu", torch.float32)
    return a.shape == b.shape and torch.equal(a, b)


@dataclasses.dataclass(frozen=True, eq=False)
class FAGPState:
    """Fitted FAGP statistics in the scaled-system form, spec baked in.

    ``Phi`` (N, M) and ``y`` (N,) or (N, T), the training features and
    targets, are kept only under ``spec.store_train`` (None otherwise).
    ``serving`` is a per-state cache of what the serving path derives from
    the fit (B^{-1} for the diag-quad kernel, the kernels' feature tables);
    every new state (``fit_update``, ``with_spec``) starts with it empty.
    """

    idx: torch.Tensor          # (M, w) int32 expansion index table
    lam: torch.Tensor          # (M,)   weights (may underflow; info only)
    sqrtlam: torch.Tensor      # (M,)   exp(0.5 log lambda) -- the scaling D
    chol: torch.Tensor         # (M, M) lower Cholesky of B
    u: torch.Tensor            # (M,) or (M, T) mean weights
    b: torch.Tensor            # (M,) or (M, T) raw moment Phi^T y
    spec: GPSpec
    Phi: Optional[torch.Tensor] = None   # (N, M) train features (store_train only)
    y: Optional[torch.Tensor] = None     # (N,) or (N, T) train targets (store_train only)
    serving: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    @property
    def n_features(self) -> int:
        return self.idx.shape[0]

    @property
    def n_tasks(self) -> int:
        return 1 if self.u.ndim == 1 else self.u.shape[1]

    def with_spec(self, spec: Optional[GPSpec] = None, **overrides) -> "FAGPState":
        """Swap execution knobs (backend, block_rows) at serve time.
        Structural fields and hyperparameters are frozen into the
        factorization and are rejected."""
        if spec is None:
            spec = dataclasses.replace(self.spec, **overrides)
        elif overrides:
            raise TypeError("pass either a full spec or keyword overrides, not both")
        for f in _STRUCTURAL_FIELDS:
            if getattr(spec, f) != getattr(self.spec, f):
                raise ValueError(
                    f"spec/state mismatch: state was fitted with "
                    f"{self.spec.describe()} but the new spec has "
                    f"{f}={getattr(spec, f)!r}; structural choices are "
                    f"frozen into the factorization — refit instead"
                )
        _check_spec_regenerates_idx(self, spec)
        _check_hypers_match(self, spec, "with_spec")
        if spec.store_train and self.Phi is None:
            raise ValueError(
                "with_spec cannot enable store_train on an already-fitted state "
                "(the training features were never stored); refit with "
                "store_train=True"
            )
        if spec.device != self.spec.device:
            raise ValueError(
                f"with_spec: the state lives on {self.spec.device}, the spec "
                f"on {spec.device}"
            )
        _check_backend_support(spec)
        return dataclasses.replace(self, spec=spec)


def _check_hypers_match(state: FAGPState, spec: GPSpec, who: str) -> None:
    """Raise unless ``spec`` carries exactly the hyperparameter leaves
    (eps/rho/noise, plus any RFF spectral draws) the state was factorized
    with: the data half of every spec/state compatibility check (shared by
    ``FAGPState.with_spec`` and the bank's admission checks)."""
    for f in _HYPER_FIELDS:
        if not _leaf_equal(getattr(spec, f), getattr(state.spec, f)):
            raise ValueError(
                f"{who}: spec/state mismatch: {f} differs from the value "
                f"this state was fitted with; hyperparameters are frozen "
                f"into the factorization — refit (or fit_update) instead"
            )


def _check_spec_regenerates_idx(state: FAGPState, spec: GPSpec) -> None:
    """Raise unless ``spec`` regenerates exactly the index table baked into
    the state: the structural half of every spec/state compatibility
    check."""
    have = state.idx.detach().cpu().numpy()
    want = spec.indices()
    if want.shape != have.shape or not np.array_equal(want, have):
        raise ValueError(
            f"spec/state mismatch: this state was fitted with "
            f"{state.spec.describe()}, but {spec.describe()} generates a "
            f"different index table; the expansion structure is frozen "
            f"into the factorization — refit instead"
        )


def build_features(X: torch.Tensor, spec: GPSpec,
                   idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phi(X) under the spec's expansion (plain path): (N, p) -> (N, M)."""
    if idx is None:
        idx = _idx_tensor(spec)
    return get_expansion(spec.expansion).features(X, idx, spec)


def _idx_tensor(spec: GPSpec, p: Optional[int] = None) -> torch.Tensor:
    return torch.from_numpy(spec.indices(p)).to(spec.device)


def _tscale(d: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scale the leading (M) axis of v by d, for v of shape (M,) or (M, T)."""
    return d[:, None] * v if v.ndim == 2 else d * v


def _row_weight(mi: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-row weight mi (N,) applied to v of shape (N,) or (N, T)."""
    return mi[:, None] * v if v.ndim == 2 else mi * v


def _assemble_scaled_system(G: torch.Tensor, loglam: torch.Tensor, sig2):
    """The one home of the f32 log-space scaled system:
    B = I + D G D / sigma^2, D = diag(exp(0.5 log lambda)), for one G
    (M, M) or a stack (C, M, M), sharing the eigenvalues (M,) or each with
    its own row of loglam (C, M) and its own sig2 (C, 1, 1).
    Returns (B, sqrtlam)."""
    M = G.shape[-1]
    sqrtlam = torch.exp(0.5 * loglam)
    B = torch.eye(M, dtype=G.dtype, device=G.device) \
        + (sqrtlam[..., :, None] * G * sqrtlam[..., None, :]) / sig2
    return B, sqrtlam


def _solve_mean_weights(chol, sqrtlam, b, sig2):
    """u = D B^{-1} D b / sig2, batched over task columns of b (M, T)."""
    rhs = _tscale(sqrtlam, b)
    sol = torch.cholesky_solve(rhs[:, None] if rhs.ndim == 1 else rhs, chol)
    if b.ndim == 1:
        sol = sol[:, 0]
    return _tscale(sqrtlam, sol) / sig2


def _block_scan_moments(X, y, feats_fn, M: int, block_rows: int,
                        row_mask=None, want_gram: bool = True):
    """The one home of the streaming row-block accumulation: G = Phi^T Phi
    (skipped when ``want_gram`` is False) and b = Phi^T y over row blocks of
    ``feats_fn(Xi)``, masked rows contributing nothing; y is (N,) or (N, T).
    O(M^2) live memory beyond one (block_rows, M) tile.  The sums take X's
    dtype: float32 on every path, float64 for a witness of the same NLML."""
    N = X.shape[0]
    G = torch.zeros((M, M), dtype=X.dtype, device=X.device) if want_gram else None
    b = torch.zeros((M,) + tuple(y.shape[1:]), dtype=X.dtype, device=X.device)
    for lo in range(0, N, block_rows):
        Phi_i = feats_fn(X[lo:lo + block_rows])
        yi = y[lo:lo + block_rows]
        if row_mask is not None:
            mi = row_mask[lo:lo + block_rows]
            Phi_i = Phi_i * mi[:, None]
            yi = _row_weight(mi, yi)
        if want_gram:
            G += Phi_i.T @ Phi_i
        b += Phi_i.T @ yi
    return G, b


def _finish_fit(B, b, loglam, sqrtlam, sig2, idx, spec, Phi=None, y=None):
    """Shared fit epilogue: M x M Cholesky and the mean weights; ``Phi``
    and ``y`` are the stored training data (``store_train``) or None."""
    chol = torch.linalg.cholesky(B)
    u = _solve_mean_weights(chol, sqrtlam, b, sig2)
    return FAGPState(idx=idx, lam=torch.exp(loglam), sqrtlam=sqrtlam,
                     chol=chol, u=u, b=b, spec=spec, Phi=Phi,
                     y=None if Phi is None else y.clone())


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------


def _supports_everything(spec: "GPSpec") -> Optional[str]:
    return None


@dataclasses.dataclass(frozen=True)
class FitBackend:
    """Execution backend for the FAGP hot paths.

    fit:         (X, y, idx, spec) -> FAGPState.
    features:    (X, spec, idx, state=None) -> (N, M).
    mean_var:    (state, Xs) -> (mu, var), the serving path.
    moments:     (X, y, spec, idx, block_rows, mask) -> raw (G, b).
    rank_update: (chol, W) -> chol(chol chol^T + W^T W), the K*8 <= M
                 branch of ``fit_update``; also takes a batch
                 chol (G, M, M), W (G, K, M) (``GPBank.update``).
    rank_downdate: (chol, W) -> (chol(chol chol^T - W^T W), ok), batched
                 like ``rank_update`` (``GPBank.downdate``); ``ok`` False
                 where a pivot was lost.
    bank_moments: (Xb (B, N, p), yb (B, N), spec, idx, block_rows,
                 maskb (B, N), hypers=None) -> raw (G (B, M, M), b (B, M))
                 for B independent datasets (``GPBank.fit``); per-slot row
                 masks express ragged per-tenant N; ``hypers`` (eps, rho),
                 each (B, p), give every slot its own feature map (a
                 heterogeneous bank's refit).
    slot_features: (X (Q, p), spec, idx, eps (C, p), rho (C, p), slots (Q,),
                 state=None, cache=None) -> (Q, M): row q under slot
                 ``slots[q]``'s (eps, rho) (a heterogeneous bank's serving,
                 update and downdate); ``cache`` a dict kept with eps and rho.
    supports:    spec -> None, or the reason the backend refuses it.

    The bank's serving path needs no other hook: it is the gathered
    posterior over the backend's ``features`` (``_gathered_bank_mean_var``).
    """

    name: str
    fit: Callable[..., "FAGPState"]
    features: Callable[..., torch.Tensor]
    mean_var: Callable[..., tuple]
    moments: Callable[..., tuple]
    rank_update: Callable[..., torch.Tensor]
    rank_downdate: Callable[..., tuple]
    bank_moments: Callable[..., tuple]
    slot_features: Callable[..., torch.Tensor]
    supports: Callable[["GPSpec"], Optional[str]] = _supports_everything


_BACKENDS: dict = {}


def register_backend(backend: FitBackend) -> None:
    _BACKENDS[backend.name] = backend


def get_backend(name: str) -> FitBackend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered: {available_backends()}"
        ) from None


def available_backends() -> list:
    return sorted(_BACKENDS)


def _check_backend_support(spec: GPSpec) -> FitBackend:
    """Validate the spec against its expansion and its backend's declared
    capabilities; refusals are structured ``UnsupportedError``s."""
    if spec.approximation != "fagp":
        raise UnsupportedError(
            f"the fagp module does not support {spec.describe()}: its entry "
            f"points run the 'fagp' family only",
            layer="approximation", capability="fagp", spec=spec,
        )
    get_expansion(spec.expansion).validate(spec)
    backend = get_backend(spec.backend)
    reason = backend.supports(spec)
    if reason is not None:
        raise UnsupportedError(
            f"backend {spec.backend!r} does not support {spec.describe()}: "
            f"{reason} (registered backends: {available_backends()})",
            layer="backend", capability=spec.backend, spec=spec,
        )
    return backend


# --- jnp backend: the plain path -------------------------------------------


def _jnp_features(X, spec, idx, state=None):
    return get_expansion(spec.expansion).features(X, idx, spec)


def _jnp_moments(X, y, spec, idx, block_rows, mask=None):
    return _block_scan_moments(
        X, y, lambda Xi: _jnp_features(Xi, spec, idx), idx.shape[0],
        block_rows, row_mask=mask,
    )


def _jnp_fit(X, y, idx, spec):
    exp = get_expansion(spec.expansion)
    sig2 = spec.noise**2
    loglam = exp.log_eigenvalues(idx, spec)
    G, b = _jnp_moments(X, y, spec, idx, spec.block_rows)
    B, sqrtlam = _assemble_scaled_system(G, loglam, sig2)
    Phi = _jnp_features(X, spec, idx) if spec.store_train else None
    return _finish_fit(B, b, loglam, sqrtlam, sig2, idx, spec, Phi, y)


def _jnp_mean_var(state, Xs):
    Phis = _jnp_features(Xs, state.spec, state.idx)
    mu = Phis @ state.u
    PhisD = Phis * state.sqrtlam[None, :]
    V = torch.linalg.solve_triangular(state.chol, PhisD.T, upper=False)
    return mu, torch.sum(V * V, dim=0)


# --- bank (multi-tenant) hooks ----------------------------------------------
# One stacked FAGPState holds C independent fitted sessions (leading bank
# axis on chol/u/b/lam/sqrtlam; idx and spec shared).  ``bank_moments``
# computes B fits' sufficient statistics at once; ``_gathered_bank_mean_var``
# answers one mixed-tenant query batch by gathering each row's slot state.


def _bank_binv(chol_s: torch.Tensor, slots=None) -> torch.Tensor:
    """Per-slot B^{-1} (C, M, M) from the stacked Cholesky factors, of the
    slots ``slots`` selects (an index tensor or a slice; all by default):
    the bank's serving cache, computed once per bank version (``GPBank``
    carries it across mutations, refreshing only the slots they touch).

    A slot's B^{-1} is the same bits whether it is inverted alone, with a
    few slots or with the whole stack, so a carried cache equals a fresh
    one.  The batched inversion does not promise that by itself: on the
    CPU, LAPACK rounds by a matrix's alignment in the batch's column-major
    copy (matrix k at k M^2 floats), and on the card a batch of one takes
    another routine than a batch of several.  So each slot is inverted
    padded with identity rows to a multiple of 8 (matrix k at a 256-byte
    stride), in a batch of at least two; the cache is a view of the padded
    result.  A refresh's gathered factors are let go once copied into the
    padded batch, so it holds at most two batches at once, as before."""
    src = chol_s if slots is None else chol_s[slots]
    C, M, _ = src.shape
    Mp = -(-M // 8) * 8
    if Mp == M and C >= 2:
        return torch.cholesky_inverse(src)
    work = torch.eye(Mp, dtype=src.dtype, device=src.device).repeat(max(C, 2), 1, 1)
    work[:C, :M, :M] = src
    del src
    return torch.cholesky_inverse(work)[:C, :M, :M]


@shape_tracked
def _bank_gathered_posterior(binv_s, u_s, sqrtlam_s, slots, Phis):
    """Mixed-tenant posterior from a stacked state: query row q reads slot
    ``slots[q]``.  binv_s (C, M, M), u_s and sqrtlam_s (C, M), slots (Q,),
    Phis (Q, M) -> (mu (Q,), var (Q,))."""
    mu = torch.sum(Phis * u_s[slots], dim=1)
    PhisD = Phis * sqrtlam_s[slots]
    var = torch.einsum("qm,qmn,qn->q", PhisD, binv_s[slots], PhisD)
    return mu, var


def _looped_bank_moments(moments):
    """A ``bank_moments`` from a backend's single-model ``moments``: slot by
    slot (the JAX package's vmap, written out), so each slot's sums are
    exactly those of a single fit, under its own (eps, rho) where ``hypers``
    gives them: the ``jnp`` backend's hook."""
    def f(Xb, yb, spec, idx, block_rows, maskb=None, hypers=None):
        B, N, _ = Xb.shape
        if maskb is None:
            maskb = torch.ones((B, N), dtype=torch.float32, device=Xb.device)
        # banks hold SMALL tenants: never let a block pad a slot's few rows
        # up to the default serving block
        block_rows = min(block_rows, max(1, N))
        specs = [spec if hypers is None else spec.replace(eps=hypers[0][s], rho=hypers[1][s])
                 for s in range(B)]
        out = [moments(Xb[s], yb[s], specs[s], idx, block_rows, maskb[s]) for s in range(B)]
        return torch.stack([G for G, _ in out]), torch.stack([b for _, b in out])
    return f


def _jnp_slot_features(X, spec, idx, eps, rho, slots, state=None, cache=None):
    """Per-row hyperparameters on the plain path: the rows of each slot
    through the feature map under that slot's own spec (the reference's
    per-row vmap, grouped by slot)."""
    out = torch.empty((X.shape[0], idx.shape[0]), dtype=torch.float32, device=X.device)
    for s in torch.unique(slots).tolist():
        rows = torch.nonzero(slots == s)[:, 0]
        out[rows] = _jnp_features(X[rows], spec.replace(eps=eps[s], rho=rho[s]), idx)
    return out


def _gathered_bank_mean_var(features):
    """The bank's serving function over a backend's feature map:
    (stack, binv (C, M, M), slots (Q,), Xq (Q, p)) -> (mu, var) for a
    mixed-tenant query batch against a stacked FAGPState, ``binv`` the
    per-slot B^{-1} cache (``_bank_binv``).  The gathered path is
    backend-independent; only the features differ."""
    def f(stack, binv, slots, Xq):
        Phis = features(Xq, stack.spec, stack.idx, stack)
        return _bank_gathered_posterior(binv, stack.u, stack.sqrtlam, slots, Phis)
    return f


# --- pallas backend: the kernels --------------------------------------------


def _tile(spec, idx, state=None):
    """The expansion's kernel feature table (cached on a fitted state)."""
    if state is not None and "tile" in state.serving:
        return state.serving["tile"]
    tile = get_expansion(spec.expansion).tile_args(spec, idx)
    if state is not None:
        state.serving["tile"] = tile
    return tile


def _pallas_supports(spec: GPSpec) -> Optional[str]:
    return get_expansion(spec.expansion).pallas_supports(spec)


def _pallas_features(X, spec, idx, state=None):
    return ops.expansion_phi(X, _tile(spec, idx, state))


def _pallas_streamed_bt(X, Y, spec, idx, mask=None):
    """Per-task b = Phi^T Y for multi-output y through the features kernel,
    one row block at a time (a second pass over X, as in the JAX package)."""
    tile = _tile(spec, idx)
    _, b = _block_scan_moments(
        X, Y, lambda Xi: ops.expansion_phi(Xi, tile), idx.shape[0],
        spec.block_rows, row_mask=mask, want_gram=False,
    )
    return b


def _pallas_moments(X, y, spec, idx, block_rows, mask=None):
    y0 = y if y.ndim == 1 else y[:, 0]
    G, b = ops.fused_fit_moments(X, y0, _tile(spec, idx), None, 1.0, mask,
                                 scale=False, block_rows=block_rows)
    if y.ndim == 2:
        b = _pallas_streamed_bt(X, y, spec, idx, mask)
    return G, b


def _pallas_fit(X, y, idx, spec):
    """The streaming fused kernel builds B = I + D G D / sig2 and b from X
    directly; multi-output b takes a second pass through the features
    kernel.  ``store_train`` adds one features launch that writes Phi out
    (the N x M buffer the fused kernel avoids, by request); the Gram still
    comes from the fused kernel."""
    exp = get_expansion(spec.expansion)
    sig2 = spec.noise**2
    loglam = exp.log_eigenvalues(idx, spec)
    sqrtlam = torch.exp(0.5 * loglam)
    y0 = y if y.ndim == 1 else y[:, 0]
    B, b = ops.fused_fit_moments(X, y0, _tile(spec, idx), sqrtlam, float(sig2))
    if y.ndim == 2:
        b = _pallas_streamed_bt(X, y, spec, idx)
    Phi = ops.expansion_phi(X, _tile(spec, idx)) if spec.store_train else None
    return _finish_fit(B, b, loglam, sqrtlam, sig2, idx, spec, Phi, y)


def _binv(state: FAGPState) -> torch.Tensor:
    """B^{-1} from the fitted factor, computed once per state."""
    if "binv" not in state.serving:
        state.serving["binv"] = torch.cholesky_inverse(state.chol)
    return state.serving["binv"]


def _pallas_mean_var(state, Xs):
    Phis = _pallas_features(Xs, state.spec, state.idx, state)
    mu = Phis @ state.u
    var = ops.diag_quad(Phis * state.sqrtlam[None, :], _binv(state))
    return mu, var


def _pallas_bank_moments(Xb, yb, spec, idx, block_rows, maskb=None, hypers=None):
    """One launch of the bank kernel for the whole bank, whichever
    expansion the bank's shared spec names, each slot under its own map
    where ``hypers`` gives them (``block_rows`` unused: the kernel streams
    its own rows)."""
    tile = (_tile(spec, idx) if hypers is None
            else get_expansion(spec.expansion).slot_tile_args(spec, idx, *hypers))
    return ops.bank_fused_fit_moments(Xb, yb, tile, maskb)


def _pallas_slot_features(X, spec, idx, eps, rho, slots, state=None, cache=None):
    """Per-row hyperparameters on the kernel path, one launch: Hermite rows
    each under their slot's constants (a stacked tile, kept in ``cache``);
    RFF rows scaled by their slot's eps over the spec's under the shared
    table (W = sqrt(2) eps . omega: the kernel keeps each column's [W;
    phase] in registers across rows, so it takes no per-row table).  The
    scaling rounds differently from a session fitted under the slot's own
    eps; the JAX package's RFF gates hold it."""
    tile = _tile(spec, idx, state)
    if tile.kind == "rff":
        return ops.expansion_phi(X * (eps / spec.eps)[slots], tile)
    stacked = None if cache is None else cache.get("slot_tile")
    if stacked is None:
        stacked = get_expansion(spec.expansion).slot_tile_args(spec, idx, eps, rho)
        if cache is not None:
            cache["slot_tile"] = stacked
    return ops.expansion_phi(X, stacked, slots.to(torch.int32))


register_backend(FitBackend(
    name="jnp", fit=_jnp_fit, features=_jnp_features, mean_var=_jnp_mean_var,
    moments=_jnp_moments, rank_update=_chol.chol_update_plain,
    rank_downdate=_chol.chol_downdate_plain,
    bank_moments=_looped_bank_moments(_jnp_moments), slot_features=_jnp_slot_features,
))
register_backend(FitBackend(
    name="pallas", fit=_pallas_fit, features=_pallas_features,
    mean_var=_pallas_mean_var, moments=_pallas_moments,
    rank_update=ops.chol_update, rank_downdate=ops.chol_downdate,
    supports=_pallas_supports, bank_moments=_pallas_bank_moments,
    slot_features=_pallas_slot_features,
))


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def _check_p(spec: GPSpec, p: int) -> None:
    if spec.p != p:
        raise ValueError(
            f"spec/input mismatch: {spec.describe()} was built for p={spec.p} "
            f"input dimensions but the data has p={p}"
        )


def fit(X, y, spec: GPSpec) -> FAGPState:
    """Fit the FAGP posterior on the spec's device; y is (N,) or (N, T)
    for T tasks sharing one factorization."""
    if not isinstance(spec, GPSpec):
        raise TypeError("fit(X, y, spec) takes a GPSpec")
    X, y = _f32(X, spec.device), _f32(y, spec.device)
    _check_p(spec, X.shape[1])
    backend = _check_backend_support(spec)
    return backend.fit(X, y, _idx_tensor(spec, X.shape[1]), spec)


def _rank_k_chol(chol, W, rank_update):
    """chol(chol chol^T + W^T W) for one system (M, M) / (K, M) or a batch
    (G, M, M) / (G, K, M): the one home of the K * 8 <= M switch."""
    K, M = W.shape[-2:]
    if K * 8 <= M:
        # small K: sequential rank-1 sweeps, O(K M^2)
        return rank_update(chol, W)
    # K comparable to M: refactorize, O(M^3 / 3), still no pass over the
    # original rows
    return torch.linalg.cholesky(chol @ chol.mT + W.mT @ W)


def _update_arrays(chol, b, sqrtlam, noise, Phi_new, y_new, rank_update):
    """Rank-K update core: (chol, b) -> (chol', b', u')."""
    sig2 = noise**2
    # B_new = B + sum_k v_k v_k^T,  v_k = D phi_k / sigma
    W = Phi_new * sqrtlam[None, :] / noise
    chol = _rank_k_chol(chol, W, rank_update)
    b = b + Phi_new.T @ y_new
    u = _solve_mean_weights(chol, sqrtlam, b, sig2)
    return chol, b, u


def fit_update(state: FAGPState, X_new, y_new) -> FAGPState:
    """Absorb new observations without refitting: a rank-k Cholesky update
    of B (O(k M^2)) and a fresh M x M solve for the mean weights."""
    spec = state.spec
    X_new, y_new = _f32(X_new, spec.device), _f32(y_new, spec.device)
    if y_new.ndim != state.u.ndim or (
        y_new.ndim == 2 and y_new.shape[1] != state.u.shape[1]
    ):
        raise ValueError(
            f"fit_update task mismatch: state holds {state.n_tasks} task(s) "
            f"but y_new has shape {tuple(y_new.shape)}"
        )
    backend = _check_backend_support(spec)
    Phi_new = backend.features(X_new, spec, state.idx, state)
    chol, b, u = _update_arrays(state.chol, state.b, state.sqrtlam,
                                spec.noise, Phi_new, y_new, backend.rank_update)
    Phi = y = None
    if state.Phi is not None:
        Phi = torch.cat([state.Phi, Phi_new], dim=0)
        y = torch.cat([state.y, y_new], dim=0)
    return dataclasses.replace(state, chol=chol, b=b, u=u, Phi=Phi, y=y)


def _predict_fused(state: FAGPState, Xs):
    """Weight-space path, no N-sized intermediates:
    Sigma* = (Phi* D) B^{-1} (Phi* D)^T by one triangular solve."""
    Phis = build_features(Xs, state.spec, state.idx)
    mu = Phis @ state.u
    PhisD = Phis * state.sqrtlam[None, :]
    V = torch.linalg.solve_triangular(state.chol, PhisD.T, upper=False)
    return mu, V.T @ V


def _predict_paper(state: FAGPState, Xs):
    """The literal Eqs. 11-12 chain in the paper's operation order, from
    the stored (Phi, y): the N x N approximate inverse
    Sigma_n^{-1} - Sigma_n^{-1} Phi Lbar^{-1} Phi^T Sigma_n^{-1}, then
    W (N*, N), then mu* and Sigma*.  In float32 the N x N inverse cancels
    badly as N grows (see ROADMAP.md section C), as in the JAX package."""
    Phis = build_features(Xs, state.spec, state.idx)            # (N*, M)
    return _paper_chain(state.Phi, state.y, Phis, state.lam, state.sqrtlam,
                        state.chol, state.spec.noise**2)


def _paper_chain(Phi, y, Phis, Lam, D, chol, sig2):
    """Eqs. 11-12 from the train features Phi (N, M), targets y, query
    features Phis (N*, M), eigenvalues Lam = D^2 and the Cholesky factor
    of B, in whatever dtype they are given."""
    N = Phi.shape[0]
    # Lbar^{-1} Phi^T = D B^{-1} D Phi^T, (M, N)
    LbarinvPhiT = D[:, None] * torch.cholesky_solve(D[:, None] * Phi.T, chol)
    Kinv = torch.eye(N, dtype=Phi.dtype, device=Phi.device) / sig2 \
        - (Phi @ LbarinvPhiT) / (sig2 * sig2)
    PhisLam = Phis * Lam[None, :]                               # Phi* Lambda
    W = (PhisLam @ Phi.T) @ Kinv                                # (N*, N), Eq. 11's W
    mu = W @ y
    cov = PhisLam @ Phis.T - (W @ Phi) @ (Lam[:, None] * Phis.T)  # Eq. 12
    return mu, cov


def predict(state: FAGPState, Xs, mode: str = "fused"):
    """Posterior mean and full covariance (N*, N*) at Xs.  ``mode="fused"``
    is the weight-space form Sigma* = (Phi* D) B^{-1} (Phi* D)^T;
    ``mode="paper"`` the literal Eqs. 11-12 chain, which needs a state
    fitted with ``store_train=True``."""
    spec = state.spec
    if mode == "fused":
        return _predict_fused(state, _f32(Xs, spec.device))
    if mode == "paper":
        if state.Phi is None:
            raise ValueError(
                f"mode='paper' needs the training features stored in the "
                f"fitted state, but this state was fitted with "
                f"{spec.replace(store_train=False).describe()} — refit with a "
                f"spec that sets store_train=True"
            )
        return _predict_paper(state, _f32(Xs, spec.device))
    raise ValueError(f"unknown mode {mode!r}")


def predict_mean_var(state: FAGPState, Xs):
    """Posterior mean and marginal variance (N*,): the serving path, which
    never forms the N* x N* covariance."""
    Xs = _f32(Xs, state.spec.device)
    backend = _check_backend_support(state.spec)
    return backend.mean_var(state, Xs)


def _removed(old: str, new: str) -> None:
    raise TypeError(f"{old} was removed (deprecated two releases ago); {new}")


# ---------------------------------------------------------------------------
# The differentiable NLML
#
# The moments hooks are not differentiable (the kernel has no autograd
# rule), so the moments are wrapped in a ``torch.autograd.Function`` whose
# backward pass streams row blocks of the expansion's differentiable
# feature map: O(M^2) live memory beyond one (block_rows, M) tile, never an
# N x M buffer, on either backend.
# ---------------------------------------------------------------------------


def _moments_via_registry(spec: GPSpec, X, y, mask):
    """Raw (G, b) = (Phi^T Phi, Phi^T y) over the masked rows through
    ``spec.backend``'s moments hook (the value; ``_MomentsDiff`` adds the
    gradient)."""
    backend = get_backend(spec.backend)
    # a small problem's one block is its N rows, not the serving block
    block_rows = min(spec.block_rows, max(1, X.shape[0]))
    return backend.moments(X, y, spec, _idx_tensor(spec, X.shape[1]),
                           block_rows, mask)


class _MomentsDiff(torch.autograd.Function):
    """(G, b) of ``_moments_via_registry``, differentiable in the spec's
    leaves (eps, rho, omega) and in the data (X, y, mask).

    ``apply(eps, rho, noise, omega, X, y, mask, spec)``: the leaves come in
    as explicit arguments (omega may be None); the spec, its leaves
    stripped, keeps the static fields and rebuilds the spec around them.

    The backward pass re-derives the cotangent contraction
    <Gbar, Phi^T Phi> + <bbar, Phi^T y> block by block through the
    expansion's feature map: for the masked rows Phi_i and weighted targets
    y_i of a block, dPhi_i = Phi_i (Gbar + Gbar^T) + y_i bbar^T (Gbar need
    not be symmetric) and dy_i = Phi_i bbar, pulled back to the leaves and
    the block's X, y and mask by autograd.  The noise gets no cotangent:
    the moments do not depend on it.
    """

    @staticmethod
    def forward(ctx, eps, rho, noise, omega, X, y, mask, spec):
        static = spec.replace(eps=None, rho=None, noise=None, omega=None)
        ctx.static = static
        ctx.save_for_backward(eps, rho, noise, omega, X, y, mask)
        with torch.no_grad():
            return _moments_via_registry(
                static.replace(eps=eps, rho=rho, noise=noise, omega=omega),
                X, y, mask)

    @staticmethod
    def backward(ctx, Gbar, bbar):
        eps, rho, noise, omega, X, y, mask = ctx.saved_tensors
        need = ctx.needs_input_grad
        grads = [None] * 8
        hyper = [i for i in (0, 1, 3) if need[i]]      # eps, rho, omega
        data = [i for i in (4, 5, 6) if need[i]]       # X, y, mask
        if not hyper and not data:
            return tuple(grads)
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(i in hyper)
                      for i, t in enumerate((eps, rho, noise, omega))]
            spec = ctx.static.replace(eps=leaves[0], rho=leaves[1],
                                      noise=leaves[2], omega=leaves[3])
            feats = get_expansion(spec.expansion).features
            idx = _idx_tensor(spec, X.shape[1])
            for i in hyper:
                grads[i] = torch.zeros_like(leaves[i])
            for i, t in zip((4, 5, 6), (X, y, mask)):
                if need[i]:
                    grads[i] = torch.zeros_like(t)
            S = Gbar + Gbar.mT
            N = X.shape[0]
            block_rows = min(spec.block_rows, max(1, N))
            for lo in range(0, N, block_rows):
                rows = slice(lo, lo + block_rows)
                Xi, yi, mi = (t[rows].detach().requires_grad_(need[i])
                              for i, t in zip((4, 5, 6), (X, y, mask)))
                Phi = feats(Xi, idx, spec) * mi[:, None]
                yw = _row_weight(mi, yi)
                P = Phi.detach()
                yb = yw.detach()
                outs, cts = [], []
                if Phi.requires_grad:
                    outs.append(Phi)
                    cts.append(P @ S + (yb[:, None] * bbar[None, :]
                                        if yb.ndim == 1 else yb @ bbar.mT))
                if yw.requires_grad:
                    outs.append(yw)
                    cts.append(P @ bbar)
                if not outs:
                    continue
                inputs = [leaves[i] for i in hyper] + [
                    t for i, t in zip((4, 5, 6), (Xi, yi, mi)) if need[i]]
                got = torch.autograd.grad(outs, inputs, cts, allow_unused=True)
                for i, g in zip(hyper, got[:len(hyper)]):
                    if g is not None:
                        grads[i] += g
                for i, g in zip(data, got[len(hyper):]):
                    if g is not None:
                        grads[i][rows] = g
        return tuple(grads)


def _nlml_core(X, y, spec: GPSpec, mask):
    """The one masked NLML, differentiable through ``_MomentsDiff``: the
    moments from the spec's backend, the epilogue through the shared
    scaled system.  ``mask`` (N,) of 0/1 row weights makes rows invisible
    (N in the logdet and normalization terms is the mask's sum): the unit
    the lane engine (``repro_torch.optim.gp_hyperopt``) steps."""
    exp = get_expansion(spec.expansion)
    idx = _idx_tensor(spec, X.shape[1])
    T = 1 if y.ndim == 1 else y.shape[1]
    sig2 = spec.noise**2
    loglam = exp.log_eigenvalues(idx, spec)
    G, b = _MomentsDiff.apply(spec.eps, spec.rho, spec.noise, spec.omega,
                              X, y, mask, spec)
    n_eff = torch.sum(mask)
    B, sqrtlam = _assemble_scaled_system(G, loglam, sig2)
    chol = torch.linalg.cholesky(B)
    bs = _tscale(sqrtlam, b) / sig2
    w = torch.cholesky_solve(bs[:, None] if bs.ndim == 1 else bs, chol)
    w = w[:, 0] if bs.ndim == 1 else w
    # y^T Kinv y = y^T y / sig2 - (D b / sig2)^T B^{-1} (D b / sig2)
    quad = torch.sum(_row_weight(mask, y) * y) / sig2 - torch.sum(bs * w)
    # logdet(K) = logdet(B) + N log sig2 (determinant lemma, scaled form)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol))) + n_eff * torch.log(sig2)
    return 0.5 * (quad + T * (logdet + n_eff * math.log(2.0 * math.pi)))


def nlml(X, y, spec: GPSpec, idx=None, n_max: Optional[int] = None,
         block_rows: Optional[int] = None, *, mask=None) -> torch.Tensor:
    """Negative log marginal likelihood, O(N M^2 + M^3), with the moments
    dispatched through the spec's backend; ``mask`` (N,) drops rows.  For
    y (N, T) the result sums the per-task NLMLs.

    Differentiable (``_nlml_core``) in the spec's eps, rho and noise (for
    the RFF expansions, eps through the scaled spectral draws, and in
    omega) and in X, y and mask, on both backends, without an N x M buffer:
    ``torch.autograd.grad(nlml(X, y, spec.replace(eps=torch.exp(le))), le)``.

    The signature is the JAX package's: ``block_rows`` overrides the spec's
    row-block size; ``idx`` and ``n_max`` belong to the removed
    ``nlml(X, y, params, idx, n_max)`` API and raise ``TypeError``, as a
    spec that is not a ``GPSpec`` does."""
    if idx is not None or n_max is not None or not isinstance(spec, GPSpec):
        _removed(
            "nlml(X, y, params, idx, n_max)",
            "build a GPSpec and call nlml(X, y, spec)",
        )
    X, y = _f32(X, spec.device), _f32(y, spec.device)
    _check_p(spec, X.shape[1])
    _check_backend_support(spec)
    if block_rows is not None:
        spec = spec.replace(block_rows=block_rows)
    N = X.shape[0]
    if mask is None:
        mask = torch.ones((N,), dtype=torch.float32, device=spec.device)
    else:
        mask = _f32(mask, spec.device)
        if tuple(mask.shape) != (N,):
            raise ValueError(f"nlml mask must be (N,) = ({N},), got {tuple(mask.shape)}")
    return _nlml_core(X, y, spec, mask)


# ---------------------------------------------------------------------------
# The registered approximation family
# ---------------------------------------------------------------------------


_CKPT_LEAVES = ("lam", "sqrtlam", "chol", "u", "b")


class _FagpApproximation(Approximation):
    """``spec.approximation == "fagp"``: the paper's decomposed-kernel family."""

    name = "fagp"
    capabilities = frozenset({"fit", "predict", "mean_var", "update", "nlml",
                              "optimize", "bank"})
    state_type = FAGPState

    def validate(self, spec: Any) -> None:
        if spec.kernel is not None or spec.neighbors is not None:
            raise ValueError(
                f"kernel=/neighbors= are vecchia-only spec fields but "
                f"approximation='fagp'; the FAGP family's structure is its "
                f"expansion — use GPSpec.create_vecchia for the Vecchia "
                f"family ({spec.describe()})"
            )
        get_expansion(spec.expansion).validate(spec)

    def fit(self, X, y, spec):
        return fit(X, y, spec)

    def predict(self, state, Xs, *, mode: str = "fused"):
        return predict(state, Xs, mode=mode)

    def mean_var(self, state, Xs):
        return predict_mean_var(state, Xs)

    def update(self, state, X_new, y_new):
        return fit_update(state, X_new, y_new)

    def nlml(self, X, y, spec, *, mask=None):
        return nlml(X, y, spec, mask=mask)

    def optimize(self, X, y, spec, *, steps: int = 100, lr: float = 5e-2,
                 restarts: int = 1, tol: Optional[float] = None,
                 jitter: float = 0.3, seed: int = 0, callback=None):
        """Gradient NLML hyperparameter learning on the lane engine
        (``repro_torch.optim.gp_hyperopt``), then a fit at the learned
        hyperparameters: the body behind ``GP.optimize``."""
        from ..optim import gp_hyperopt

        def cb(step, vals, hp):
            if callback is None:
                return
            r = int(np.argmin(vals[0]))
            callback(step, float(vals[0, r]),
                     gp_hyperopt._hp_to_spec(spec, {f: leaf[0, r] for f, leaf in hp.items()}))

        result = gp_hyperopt.optimize_restarts(
            X, y, spec, restarts=restarts, steps=steps, lr=lr, tol=tol,
            jitter=jitter, seed=seed, callback=cb,
        )
        return fit(X, y, result.spec_for(spec, 0))

    # -- checkpoint hooks (checkpoint/gpstate.py) ---------------------------

    def ckpt_leaf_names(self) -> tuple:
        return _CKPT_LEAVES

    def ckpt_leaves(self, state: FAGPState) -> dict:
        return {f: getattr(state, f) for f in _CKPT_LEAVES}

    def ckpt_meta(self, state: FAGPState) -> dict:
        return {"M": int(state.n_features), "n_tasks": int(state.n_tasks)}

    def ckpt_rebuild(self, spec, leaves: dict, train) -> FAGPState:
        train = train or {}
        return FAGPState(
            idx=_idx_tensor(spec), lam=leaves["lam"], sqrtlam=leaves["sqrtlam"],
            chol=leaves["chol"], u=leaves["u"], b=leaves["b"], spec=spec,
            Phi=train.get("Phi"), y=train.get("y"),
        )


register_approximation(_FagpApproximation())

# importing the sibling family registers it; it comes after this module's
# definitions (core/vecchia.py reads _STRUCTURAL_FIELDS and friends lazily)
from . import vecchia as _vecchia  # noqa: E402,F401  (registration import)
