"""Serve one GP session: fit, then rounds of rank-k ingest and microbatched
``mean_var`` queries.

Counterpart of ``repro/launch/serve_gp.py::serve_gp`` (the single-session
loop; the fleet, bank and telemetry paths come with later slices):

  python -m repro_torch.launch.serve_gp --backend pallas --device cuda \\
      --n-train 10000 --p 4 --n 11 --rounds 4 --update-size 64 \\
      --queries 1024 --microbatch 128

Times are host-clock seconds around work that ends in
``torch.cuda.synchronize()`` on a card.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core import fagp
from ..core.gp import GP, GPSpec
from ..data import make_gp_dataset
from ..device import resolve_device

__all__ = ["serve_gp", "microbatched_mean_var"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def microbatched_mean_var(gp, Xs: torch.Tensor, *, microbatch: int):
    """``mean_var`` in fixed-size microbatches (zero-padded tail).

    Returns (mu, var, per_batch_seconds) with mu and var as numpy arrays.
    Padding and slicing happen up front, outside the timed region.
    """
    if isinstance(gp, fagp.FAGPState):
        gp = GP.from_state(gp)
    Nq = Xs.shape[0]
    nb = max(1, (Nq + microbatch - 1) // microbatch)
    Xp = torch.nn.functional.pad(Xs, (0, 0, 0, nb * microbatch - Nq))
    blocks = [Xp[i * microbatch:(i + 1) * microbatch].contiguous() for i in range(nb)]
    _sync(Xs.device)
    mus, variances, times = [], [], []
    for blk in blocks:
        t0 = time.perf_counter()
        mu, var = gp.mean_var(blk)
        _sync(blk.device)
        times.append(time.perf_counter() - t0)
        mus.append(mu.cpu().numpy())
        variances.append(var.cpu().numpy())
    return np.concatenate(mus)[:Nq], np.concatenate(variances)[:Nq], times


def serve_gp(
    *,
    backend: str = "jnp",
    n_train: int = 2048,
    p: int = 2,
    n: int = 8,
    rounds: int = 4,
    update_size: int = 64,
    queries: int = 512,
    microbatch: int = 128,
    noise: float = 0.05,
    seed: int = 0,
    device=None,
) -> dict:
    """Fit on ``n_train`` rows, then ``rounds`` x (ingest ``update_size``
    rows, answer ``queries`` in microbatches).  Returns fit time, per-round
    metrics, M, the device, and the final session under ``"gp"``."""
    dev = resolve_device(device)
    spec = GPSpec.create(n, eps=np.full((p,), 0.8, np.float32), rho=2.0,
                         noise=noise, backend=backend, device=dev)
    total = n_train + rounds * update_size
    X_all, y_all, Xs, ys = make_gp_dataset(total, p, noise=noise, seed=seed, device=dev)
    X0, y0 = X_all[:n_train], y_all[:n_train]

    _sync(dev)
    t0 = time.perf_counter()
    gp = GP.fit(X0, y0, spec)
    _sync(dev)
    t_fit = time.perf_counter() - t0

    Xq = Xs[:queries]
    ysq = ys[:Xq.shape[0]].cpu().numpy()
    history = []
    for r in range(rounds):
        lo = n_train + r * update_size
        Xn, yn = X_all[lo:lo + update_size], y_all[lo:lo + update_size]
        t0 = time.perf_counter()
        gp = gp.update(Xn, yn)
        _sync(dev)
        t_update = time.perf_counter() - t0

        mu, var, times = microbatched_mean_var(gp, Xq, microbatch=microbatch)
        times.sort()
        history.append({
            "round": r,
            "rows_absorbed": int(lo + update_size),
            "update_s": t_update,
            "predict_p50_s": times[len(times) // 2],
            "queries_per_s": Xq.shape[0] / sum(times),
            "rmse": float(np.sqrt(np.mean((mu - ysq) ** 2))),
            "var_finite": bool(np.all(np.isfinite(var))),
        })
    return {"fit_s": t_fit, "rounds": history, "M": gp.n_features,
            "device": str(dev), "gp": gp}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="jnp", choices=fagp.available_backends())
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-train", type=int, default=2048)
    ap.add_argument("--p", type=int, default=2)
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--update-size", type=int, default=64)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--microbatch", type=int, default=128)
    ap.add_argument("--noise", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    out = serve_gp(
        backend=args.backend, n_train=args.n_train, p=args.p, n=args.n,
        rounds=args.rounds, update_size=args.update_size,
        queries=args.queries, microbatch=args.microbatch, noise=args.noise,
        seed=args.seed, device=args.device,
    )
    print(f"fit: {out['fit_s'] * 1e3:.1f} ms  M={out['M']}  device={out['device']}")
    for h in out["rounds"]:
        print(f"round {h['round']}: rows={h['rows_absorbed']} "
              f"update={h['update_s'] * 1e3:.2f} ms "
              f"p50={h['predict_p50_s'] * 1e3:.2f} ms "
              f"q/s={h['queries_per_s']:.0f} rmse={h['rmse']:.4f}")
    out.pop("gp")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
