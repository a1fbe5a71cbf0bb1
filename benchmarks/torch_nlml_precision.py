#!/usr/bin/env python3
"""How far the float32 NLML and its gradient sit from float64, by width.

    python3 benchmarks/torch_nlml_precision.py      # from the repository root; one card

For each (N, p, n) below, on the Eq. 21 data of ``make_gp_dataset`` (noise
0.05) and a Hermite spec (eps 0.8, rho 2, noise 0.05), the NLML and its
gradient in (log eps, log rho, log noise) on the two backends in float32
(``pallas``: the fused-fit kernel's moments; ``jnp``: the block scan), and
the same NLML in float64 through the port's streamed backward pass
(``fagp._nlml_core`` on the jnp backend).  Each float32 result is printed in
units of the JAX package's gates (value rtol 1e-4; gradient rtol 1e-3,
atol 1e-2; tests/test_gp_hyperopt.py:123-127), against the other backend
and against float64, per gradient block, with the condition number of the
float64 B (seed 0).  Seeds 0-3; the largest ratio over them is printed.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (N, p, n): the JAX test's case, small widths, the fleet's and the
# Figure 1 point's
WIDTHS = [(200, 2, 6), (1000, 2, 6), (200, 4, 3), (2000, 4, 5), (10_000, 2, 4),
          (10_000, 4, 5), (10_000, 4, 11)]
SEEDS = range(4)
NAMES = ("value", "log_eps", "log_rho", "log_noise")


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.core import fagp
    from repro_torch.core.gp import GPSpec
    from repro_torch.data import make_gp_dataset
    from repro_torch.optim import gp_hyperopt

    if not torch.cuda.is_available():
        print("torch_nlml_precision: needs an NVIDIA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")

    def ratio(a, b, rtol, atol):
        return float(((a - b).abs() / (atol + rtol * b.abs())).max())

    def ratios(a, b):
        return [ratio(a[0], b[0], 1e-4, 0.0)] + [ratio(x, y, 1e-3, 1e-2)
                                                 for x, y in zip(a[1:], b[1:])]

    for N, p, n in WIDTHS:
        worst = {k: np.zeros(len(NAMES)) for k in ("pallas_vs_jnp", "pallas_vs_f64",
                                                   "jnp_vs_f64")}
        for seed in SEEDS:
            X, y, _, _ = make_gp_dataset(N, p, noise=0.05, seed=seed, device=dev)
            spec = GPSpec.create(n, eps=np.full((p,), 0.8, np.float32), rho=2.0,
                                 noise=0.05, device=dev)
            res = {}
            for be, dt in (("pallas", torch.float32), ("jnp", torch.float32),
                           ("f64", torch.float64)):
                lv = {f"log_{f}": torch.log(getattr(spec, f)).detach().to(dt)
                      .requires_grad_() for f in ("eps", "rho", "noise")}
                sp = gp_hyperopt._hp_to_spec(
                    spec.replace(backend="jnp" if be == "f64" else be), lv)
                v = fagp._nlml_core(X.to(dt), y.to(dt), sp,
                                    torch.ones(N, dtype=dt, device=dev))
                res[be] = [v.detach().double()] + [
                    g.double() for g in torch.autograd.grad(v, list(lv.values()))]
                if be == "f64" and seed == SEEDS[0]:
                    with torch.no_grad():
                        G, _ = fagp._moments_via_registry(sp, X.double(), y.double(),
                                                          torch.ones(N, dtype=dt, device=dev))
                        idx = fagp._idx_tensor(sp)
                        B, _ = fagp._assemble_scaled_system(
                            G, fagp.get_expansion(sp.expansion).log_eigenvalues(idx, sp),
                            sp.noise**2)
                        ev = torch.linalg.eigvalsh(B)
                        cond = float(ev.max() / ev.min())
                del v
            for k, (a, b) in {"pallas_vs_jnp": ("pallas", "jnp"),
                              "pallas_vs_f64": ("pallas", "f64"),
                              "jnp_vs_f64": ("jnp", "f64")}.items():
                worst[k] = np.maximum(worst[k], ratios(res[a], res[b]))
            torch.cuda.empty_cache()
        M = n ** p
        print(f"[precision] N={N} p={p} n={n} M={M} cond(B)={cond:.3e}: " + json.dumps(
            {k: dict(zip(NAMES, (round(float(x), 3) for x in v))) for k, v in worst.items()}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
