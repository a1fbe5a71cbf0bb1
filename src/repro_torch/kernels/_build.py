"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file is one kernel family with a plain C interface (no
PyTorch headers, so each compiles in seconds).  On the first call of
:func:`library` all sources are compiled together, one ``nvcc`` process
per source started at once, into ``build/repro_torch_kernels/<hash>/``
under the checkout's root; the hash covers the sources and the flags, so a
changed source is never served from a stale library.  Each ``.so`` is
written under a temporary name and renamed into place, so two processes
building at once cannot load a half-written file.

There is no fallback: where ``nvcc`` is missing or a source does not
compile, :func:`library` raises :class:`KernelBuildError`.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

__all__ = [
    "KernelBuildError", "LaunchCounter", "SOURCES", "build_count", "build_dir",
    "check_launch", "library", "on_device", "ptr",
]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("phi_features", "phi_gram", "diag_quad", "chol_update", "scaled_gram")
HEADERS = ("expansion.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)
_DEFAULT_CUDA_HOME = "/usr/local/cuda"

_LIBS: dict = {}
_SAME_DEVICE = contextlib.nullcontext()
_LOCK = threading.Lock()
_BUILDS = [0]      # nvcc runs started by this process (build_count)


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


class LaunchCounter:
    """Counts launches of one kernel, by variant.  Incremented by the
    kernel's launch function right after a launch and nowhere else, so a
    run can show that its path went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.counts: dict = {}

    def add(self, variant: str = "") -> None:
        self.counts[variant] = self.counts.get(variant, 0) + 1

    def reset(self) -> None:
        self.counts.clear()


def build_dir() -> Path:
    """``build/repro_torch_kernels`` beside ``src/`` at the root of the
    checkout.  Raises where the package does not run from a checkout's
    ``src/`` (a copy installed into site-packages has no checkout to build
    in; install it editable instead)."""
    src = Path(__file__).resolve().parents[2]
    if src.name != "src":
        raise KernelBuildError(
            f"repro_torch runs from {src}, not from a checkout's src/: the "
            "CUDA kernels are built into build/repro_torch_kernels/ of the "
            "checkout (run with PYTHONPATH=src or pip install -e .)"
        )
    return src.parent / "build" / "repro_torch_kernels"


def find_nvcc() -> Optional[str]:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default location; None where there is none."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cand = Path(os.environ[var]) / "bin" / "nvcc"
            if cand.is_file():
                return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(_DEFAULT_CUDA_HOME) / "bin" / "nvcc"
    return str(cand) if cand.is_file() else None


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in [f"{s}.cu" for s in SOURCES] + list(HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build_all() -> Path:
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (looked at $CUDA_HOME/bin, PATH and "
            f"{_DEFAULT_CUDA_HOME}/bin): the CUDA kernels of repro_torch are "
            "built from kernels/csrc/*.cu on the machine with the card; run "
            "on the CPU with device='cpu' instead"
        )
    out = build_dir() / _digest()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in SOURCES:
        so = out / f"lib{name}.so"
        if so.is_file():
            continue
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        log = open(out / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, log,
                      subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
        _BUILDS[0] += 1
    failed = []
    for name, so, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append((name, (out / f"{name}.log").read_text()[-4000:]))
        else:
            os.replace(tmp, so)
    if failed:
        raise KernelBuildError(
            "nvcc failed for " + ", ".join(n for n, _ in failed) + ":\n"
            + "\n".join(f"--- {n}\n{t}" for n, t in failed)
        )
    return out


def build_count() -> int:
    """The ``nvcc`` runs this process has started: what the serving
    watchdog (``repro_torch.obs.serving_watchdog``) reads as kernel builds."""
    return _BUILDS[0]


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (building every kernel
    on first use)."""
    if name not in SOURCES:
        raise ValueError(f"unknown kernel library {name!r}; have {SOURCES}")
    with _LOCK:
        if name not in _LIBS:
            out = _build_all()
            for src in SOURCES:
                try:
                    _LIBS[src] = ctypes.CDLL(str(out / f"lib{src}.so"))
                except OSError as e:
                    raise KernelBuildError(f"cannot load lib{src}.so: {e}") from e
        return _LIBS[name]


def on_device(t: torch.Tensor):
    """The context a launch on ``t`` runs in: ``torch.cuda.device`` of
    ``t``'s card where another card is current, else a shared null context.
    A C entry point launches on the current card and reads its per-device
    plan there (``cudaGetDevice``), so a shard on ``cuda:1`` launched while
    ``cuda:0`` is current would take another card's plan; on the current
    card the check is one device query and nothing more."""
    index = t.get_device()
    if torch._C._cuda_getDevice() == index:
        return _SAME_DEVICE
    return torch.cuda.device(index)


def ptr(t) -> Optional[ctypes.c_void_p]:
    """A tensor's device pointer for a ``c_void_p`` argument (None -> NULL)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def check_launch(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code (its
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def ptxas_report() -> dict:
    """What ``-Xptxas -v`` said for each built source (registers, shared
    memory, spills), read back from the build logs."""
    out = build_dir() / _digest()
    return {
        name: (out / f"{name}.log").read_text() if (out / f"{name}.log").is_file() else ""
        for name in SOURCES
    }
