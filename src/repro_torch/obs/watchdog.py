"""Runtime recompile watchdog.

Counterpart of ``repro/obs/watchdog.py``.  The JAX package guards its
serving path by the jit cache sizes of its executables: warm the bucket
ladder, snapshot, churn, assert that nothing grew.  The port compiles no
serving graph (no ``torch.compile``, no graph capture), so the same idiom
runs over what the port can grow instead:

* a **shape registry** per serving and ingest function
  (:func:`shape_tracked`): the distinct input-shape signatures (shapes and
  dtypes of its tensor arguments, the types of the rest) the function has
  been called with.  A call with a signature never seen before is what a
  jitted function would have compiled for, so a shape leak past the bucket
  ladder grows the registry;
* the **kernel builds** (``kernels/_build.py``): ``nvcc`` runs started.
  Every kernel is built on first use, so a build after :meth:`arm` is a
  compile on the serving path.

Both expose ``_cache_size()``, so :meth:`RecompileWatchdog.register`,
:meth:`~RecompileWatchdog.arm` and :meth:`~RecompileWatchdog.check` are the
JAX package's.  Modes: ``"raise"`` (RecompileError, for tests and benches
proving the invariant), ``"warn"`` (``warnings.warn`` per growth event,
the serving default), ``"count"`` (silent; read :attr:`recompiles`).  All
modes count, and the count lands in the metrics registry when one is wired
through (``serve_recompiles_total``).
"""
from __future__ import annotations

import functools
import threading
import warnings
from typing import Callable, Optional

__all__ = ["RecompileError", "RecompileWatchdog", "serving_watchdog", "shape_tracked"]


class RecompileError(RuntimeError):
    """A registered function grew after the watchdog was armed."""


def _cache_size(fn) -> int:
    return int(fn._cache_size())


def _signature(value):
    """The shape signature of one argument: a tensor's (or array's) shape
    and dtype, containers element by element, anything else its type."""
    shape = getattr(value, "shape", None)
    if shape is not None and hasattr(value, "dtype"):
        return (tuple(shape), str(value.dtype))
    if isinstance(value, (list, tuple)):
        return tuple(_signature(v) for v in value)
    if isinstance(value, dict):
        return tuple((k, _signature(value[k])) for k in sorted(value, key=repr))
    return type(value).__name__


def shape_tracked(fn: Callable) -> Callable:
    """Wrap ``fn`` so that it records the shape signature of every call; the
    wrapper's ``_cache_size()`` is the number of distinct signatures seen
    (the count a jitted function's executable cache would hold)."""
    seen: set = set()
    lock = threading.Lock()

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        sig = (_signature(args), _signature(kwargs))
        if sig not in seen:
            with lock:
                seen.add(sig)
        return fn(*args, **kwargs)

    wrapper._cache_size = lambda: len(seen)
    return wrapper


class RecompileWatchdog:
    """Snapshots per-function cache sizes and reports growth.

    ``register`` wants anything exposing ``_cache_size()`` (a
    :func:`shape_tracked` function, the kernel-build count); ``arm()``
    re-baselines after warmup so legitimate first calls of the bucket ladder
    are not reported; ``check()`` compares and, per mode, raises / warns /
    counts.
    """

    def __init__(self, *, mode: str = "warn", counter=None) -> None:
        if mode not in ("raise", "warn", "count"):
            raise ValueError(f"mode must be raise|warn|count, got {mode!r}")
        self.mode = mode
        self._fns: dict = {}            # name -> tracked function
        self._baseline: dict = {}       # name -> cache size at arm()
        self._counter = counter         # obs.metrics Counter (or None)
        self.recompiles = 0             # total growth observed since arm()
        self.events: list = []          # (context, {name: growth}) log

    def register(self, name: str, fn: Callable) -> "RecompileWatchdog":
        if not hasattr(fn, "_cache_size"):
            raise TypeError(
                f"{name!r}: object has no _cache_size() — register a "
                f"shape_tracked function itself, not a wrapper"
            )
        self._fns[name] = fn
        self._baseline[name] = _cache_size(fn)
        return self

    def arm(self) -> "RecompileWatchdog":
        """Re-baseline every registered function (call after warmup: growth
        before arm() is expected, growth after is a leak)."""
        for name, fn in self._fns.items():
            self._baseline[name] = _cache_size(fn)
        return self

    def sizes(self) -> dict:
        return {name: _cache_size(fn) for name, fn in self._fns.items()}

    def check(self, context: str = "") -> dict:
        """Compare cache sizes against the armed baseline.  Returns
        ``{name: growth}`` for functions that grew (and advances the
        baseline so each growth is reported once)."""
        grew = {}
        for name, fn in self._fns.items():
            size = _cache_size(fn)
            base = self._baseline[name]
            if size > base:
                grew[name] = size - base
                self._baseline[name] = size
        if grew:
            n = sum(grew.values())
            self.recompiles += n
            self.events.append((context, grew))
            if self._counter is not None:
                self._counter.inc(n)
            msg = (f"recompile detected ({context or 'serving path'}): "
                   + ", ".join(f"{k} +{v}" for k, v in sorted(grew.items())))
            if self.mode == "raise":
                raise RecompileError(msg)
            if self.mode == "warn":
                warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return grew


class _KernelBuilds:
    """The kernel-build count as a registrable ``_cache_size()``."""

    def __init__(self, build_module):
        self._build = build_module

    def _cache_size(self) -> int:
        return self._build.build_count()


def serving_watchdog(*, mode: str = "warn", metrics=None,
                     watchdog: Optional[RecompileWatchdog] = None
                     ) -> RecompileWatchdog:
    """A watchdog pre-registered with every serving-path function the stack
    dispatches through, under the JAX package's names: the bank's slot write
    and scatters, the gathered posteriors, the hyperopt lane step, the
    sharded bank's shard-local steps (``bank_shard_*``); plus
    ``kernel_builds``.  Imports lazily so ``repro_torch.obs`` itself stays
    importable without torch."""
    from ..bank import bank as bank_mod
    from ..bank import sharded as sharded_mod
    from ..core import fagp
    from ..kernels import _build
    from ..optim import gp_hyperopt

    counter = None
    if metrics is not None:
        counter = metrics.counter(
            "serve_recompiles_total",
            "serving-path executables compiled after watchdog arm",
        )
    wd = watchdog or RecompileWatchdog(mode=mode, counter=counter)
    for name, fn in (
        ("bank_write_slot", bank_mod._write_slot),
        ("bank_update_scatter", bank_mod._bank_update_scatter),
        ("bank_update_scatter_donated", bank_mod._bank_update_scatter_donated),
        ("bank_gathered_posterior", fagp._bank_gathered_posterior),
        ("hetero_gathered_mean_var", bank_mod._hetero_gathered_mean_var),
        ("bank_downdate_scatter", bank_mod._bank_downdate_scatter),
        ("bank_refit_scatter", bank_mod._bank_refit_scatter),
        ("hyperopt_lane_step", gp_hyperopt._lane_step),
        ("hyperopt_lane_values", gp_hyperopt._lane_values),
        ("bank_shard_mean_var", sharded_mod._sh_mean_var),
        ("bank_shard_update_scatter", sharded_mod._sh_update_scatter),
        ("bank_shard_downdate_scatter", sharded_mod._sh_downdate_scatter),
        ("bank_shard_refit_scatter", sharded_mod._sh_refit_scatter),
        ("bank_shard_write_slot", sharded_mod._sh_write_slot),
        ("bank_shard_read_slot", sharded_mod._sh_read_slot),
        ("bank_shard_binv", sharded_mod._sh_binv),
        ("kernel_builds", _KernelBuilds(_build)),
    ):
        wd.register(name, fn)
    return wd
