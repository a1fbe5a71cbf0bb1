"""Core of the port: mercer, expansions, approximation, fagp, vecchia, gp,
exact_gp (and convert, which carries JAX parameters across).

Counterpart of ``repro/core/__init__.py``, with the same public names, less
the legacy ``FAGPConfig``.
``mercer`` is imported first: the kernels' plain tile builder imports the
recurrence from it while this package is still initializing.
"""
from . import mercer  # noqa: I001  (first: see the docstring)
from . import approximation, exact_gp, expansions, fagp, gp, vecchia
from .approximation import (
    Approximation,
    UnsupportedError,
    available_approximations,
    get_approximation,
    register_approximation,
)
from .expansions import (
    KernelExpansion,
    available_expansions,
    get_expansion,
    register_expansion,
)
from .fagp import (
    FAGPState,
    GPSpec,
    fit,
    fit_update,
    nlml,
    predict,
    predict_mean_var,
)
from .gp import GP
from .vecchia import VecchiaState
from .mercer import (
    SEKernelParams,
    eigenvalues_1d,
    eigenfunctions_1d,
    eigenvalues_nd,
    log_eigenvalues_1d,
    log_eigenvalues_nd,
    full_grid,
    hyperbolic_cross,
    k_matern52_ard,
    k_se_ard,
    make_index_set,
    phi_nd,
    total_degree,
)

__all__ = [
    "approximation", "exact_gp", "expansions", "fagp", "gp", "mercer", "vecchia",
    "Approximation", "UnsupportedError", "available_approximations",
    "get_approximation", "register_approximation",
    "KernelExpansion", "available_expansions", "get_expansion",
    "register_expansion",
    "FAGPState", "GPSpec", "fit", "fit_update", "nlml", "predict",
    "predict_mean_var",
    "GP", "VecchiaState", "SEKernelParams",
    "eigenvalues_1d", "eigenfunctions_1d", "eigenvalues_nd",
    "log_eigenvalues_1d", "log_eigenvalues_nd", "full_grid",
    "hyperbolic_cross", "k_matern52_ard", "k_se_ard", "make_index_set",
    "phi_nd", "total_degree",
]
