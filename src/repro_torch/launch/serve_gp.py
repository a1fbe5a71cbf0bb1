"""GP serving loops: one session, or a whole fleet through the bank router.

Counterpart of ``repro/launch/serve_gp.py``:

* ``serve_gp``    ONE fitted session serves microbatched ``mean_var``
  queries while new observations stream in (rank-k ingest).
* ``serve_fleet`` MANY independent sessions (one per tenant) live in a
  :class:`~repro_torch.bank.GPBank` and traffic flows through a
  :class:`~repro_torch.bank.BankRouter`: the synchronous loop
  (``engine="sync"``), optionally re-optimizing stale tenants every few
  rounds (``reopt_every``).  The pipelined engine, the tiered and sharded
  fleets and telemetry come with later slices (ROADMAP.md) and raise
  ``UnsupportedError``.

  python -m repro_torch.launch.serve_gp --backend pallas --device cuda \\
      --n-train 10000 --p 4 --n 11 --rounds 4 --update-size 64 \\
      --queries 1024 --microbatch 128
  python -m repro_torch.launch.serve_gp --backend pallas --device cuda \\
      --fleet 512 --engine sync --n-train 10000 --p 4 --n 5 --rounds 4 \\
      --update-size 2048 --queries 8192 --microbatch 256 --reopt-every 2

Times are host-clock seconds around work that ends in
``torch.cuda.synchronize()`` on a card.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..bank import BankRouter, GPBank
from ..core import fagp
from ..core.gp import GP, GPSpec, _not_ported
from ..data import make_gp_dataset
from ..device import resolve_device

__all__ = ["serve_gp", "serve_fleet", "fleet_dataset", "microbatched_mean_var"]


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


def fleet_dataset(rng: np.random.Generator, *, tenants: int, n_train: int,
                  p: int, rounds: int, observations_per_round: int,
                  noise: float, seed: int):
    """The fleet's data, drawn exactly as the JAX package's ``serve_fleet``
    draws it: tenant t observes the Eq. 21 target shifted by its own offset
    (one ``rng`` draw), from a pool made with seed ``seed + t``.  Returns
    (offsets (tenants,), Xb (tenants, n_train, p), yb (tenants, n_train),
    pools: per-tenant (X_all, y_all) numpy arrays)."""
    offsets = rng.uniform(-1.0, 1.0, size=tenants).astype(np.float32)
    total = n_train + rounds * max(
        1, observations_per_round // max(1, tenants)) + observations_per_round
    Xb = np.zeros((tenants, n_train, p), np.float32)
    yb = np.zeros((tenants, n_train), np.float32)
    pools = []
    for t in range(tenants):
        X_all, y_all, _, _ = make_gp_dataset(total, p, noise=noise, seed=seed + t,
                                             device="cpu")
        X_all, y_all = X_all.numpy(), y_all.numpy() + offsets[t]
        Xb[t], yb[t] = X_all[:n_train], y_all[:n_train]
        pools.append((X_all, y_all))
    return offsets, Xb, yb, pools


_OBS = "pipelined fleet serving with obs (ROADMAP A4)"


def serve_fleet(
    *,
    backend: str = "jnp",
    tenants: int = 64,
    n_train: int = 64,
    p: int = 2,
    n: int = 8,
    rounds: int = 4,
    queries_per_round: int = 512,
    observations_per_round: int = 128,
    microbatch: int = 64,
    ingest_chunk: int = 16,
    noise: float = 0.05,
    seed: int = 0,
    reopt_every: int = 0,
    reopt_min_rows: int = 16,
    reopt_steps: int = 25,
    reopt_restarts: int = 2,
    engine: str = "pipelined",
    capacity=None,
    cold_dir=None,
    window: int = 0,
    shards: int = 0,
    metrics=None,
    tracer=None,
    watchdog=None,
    device=None,
) -> dict:
    """Serve a fleet of ``tenants`` independent GPs concurrently.

    Each tenant observes its own shifted copy of the synthetic target
    (:func:`fleet_dataset`).  Every round, per-tenant observation streams
    are absorbed with batched ``GPBank.update`` rounds, then mixed-tenant
    query traffic (a uniformly random tenant per query) flows through the
    router in padded microbatches.  Reported per round, as in the JAX
    package: ingest time, query wall time, its mean per microbatch,
    fleet-wide queries/s and the RMSE against each tenant's own
    noise-free target, and the re-optimization's time and tenants
    (``reopt_s``, ``reopt_tenants``); the port adds ``ingest_rounds``
    (distinct-tenant update rounds) and ``var_finite``.  The returned dict
    also carries the final bank under ``"bank"``.

    ``reopt_every > 0`` re-optimizes STALE tenants every that many rounds,
    after the round's ingest: tenants that absorbed >= ``reopt_min_rows``
    observations since their last optimization are re-learned with one
    batched ``GPBank.optimize`` run (``reopt_steps`` steps,
    ``reopt_restarts`` restarts) over their accumulated data, padded to
    the fixed pool size and masked (``BankRouter.reoptimize``); the bank
    becomes heterogeneous and each tenant serves under its own learned
    hyperparameters.

    Only ``engine="sync"`` is ported (the JAX default, ``"pipelined"``,
    raises ``UnsupportedError``), and so do ``cold_dir`` (and with it
    ``capacity`` and ``window``, which without a cold tier raise the JAX
    package's ``ValueError``), ``shards``, ``metrics``, ``tracer`` and
    ``watchdog``.  The JAX signature's knobs that only those paths read
    (the pipelined engine's ``max_in_flight``, ``queue_budget`` and
    ``slo_s``) and the record fields they fill (``timeouts``,
    ``aged_rows``) come with their paths.  Times are host-clock seconds
    around work that ends in ``torch.cuda.synchronize()`` on a card.
    """
    if engine not in ("pipelined", "sync"):
        raise ValueError(f"engine must be 'pipelined' or 'sync', got {engine!r}")
    if engine == "pipelined":
        _not_ported("serve_fleet(engine='pipelined')", _OBS)
    for name, given, item in (
        ("cold_dir", cold_dir is not None, "the tiered bank, TieredBank (ROADMAP A4)"),
        ("shards", bool(shards), "multi-device (ROADMAP A5)"),
        ("metrics", metrics is not None, _OBS),
        ("tracer", tracer is not None, _OBS),
        ("watchdog", watchdog is not None, _OBS),
    ):
        if given:
            _not_ported(f"serve_fleet({name}=...)", item)
    if capacity is not None or window:
        raise ValueError("capacity/window need a cold tier; pass cold_dir")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    spec = GPSpec.create(n, eps=np.full((p,), 0.8, np.float32), rho=2.0,
                         noise=noise, backend=backend, device=dev)
    offsets, Xb, yb, pools = fleet_dataset(
        rng, tenants=tenants, n_train=n_train, p=p, rounds=rounds,
        observations_per_round=observations_per_round, noise=noise, seed=seed)

    _sync(dev)
    t0 = time.perf_counter()
    bank = GPBank.fit(torch.from_numpy(Xb), torch.from_numpy(yb), spec)
    _sync(dev)
    t_fit = time.perf_counter() - t0

    router = BankRouter(bank, microbatch=microbatch, ingest_chunk=ingest_chunk)
    consumed = [n_train] * tenants
    history = []
    for r in range(rounds):
        # -- ingest: each tenant streams a few fresh observations ----------
        for _ in range(observations_per_round):
            t = int(rng.integers(0, tenants))
            X_all, y_all = pools[t]
            i = consumed[t] % X_all.shape[0]
            consumed[t] += 1
            router.observe(t, X_all[i], y_all[i])
        rounds_before = router.ingest_rounds
        t0 = time.perf_counter()
        absorbed = router.ingest()
        _sync(dev)
        t_ingest = time.perf_counter() - t0

        # -- periodic re-optimization of stale tenants ---------------------
        t_reopt, n_reopt = 0.0, 0
        if reopt_every and (r + 1) % reopt_every == 0:
            stale = router.stale_tenants(reopt_min_rows)
            if stale:
                # the row axis padded to the FIXED pool size (masked), as in
                # the JAX loop, so every round's stale data has one shape
                n_max = pools[0][0].shape[0]
                Xo = np.zeros((len(stale), n_max, p), np.float32)
                yo = np.zeros((len(stale), n_max), np.float32)
                mo = np.zeros((len(stale), n_max), np.float32)
                for i, t in enumerate(stale):
                    X_all, y_all = pools[t]
                    rows = min(consumed[t], X_all.shape[0])
                    Xo[i, :rows] = X_all[:rows]
                    yo[i, :rows] = y_all[:rows]
                    mo[i, :rows] = 1.0
                t0 = time.perf_counter()
                router.reoptimize(stale, torch.from_numpy(Xo), torch.from_numpy(yo),
                                  mask=torch.from_numpy(mo), restarts=reopt_restarts,
                                  steps=reopt_steps, seed=seed)
                _sync(dev)
                t_reopt = time.perf_counter() - t0
                n_reopt = len(stale)

        # -- queries: mixed-tenant traffic through the router --------------
        q_tenants = rng.integers(0, tenants, queries_per_round)
        Xq = rng.uniform(-1.0, 1.0, size=(queries_per_round, p)).astype(np.float32)
        tickets = [router.submit(int(t), Xq[i]) for i, t in enumerate(q_tenants)]
        t0 = time.perf_counter()
        results = router.flush()
        t_query = time.perf_counter() - t0
        mu = np.array([results[tk][0] for tk in tickets])
        var = np.array([results[tk][1] for tk in tickets])
        # RMSE of each query against its own tenant's (noise-free) Eq. 21
        # target sum_j cos(x_j) + offset_t
        truth = np.sum(np.cos(Xq), axis=1) + offsets[q_tenants]
        nb = max(1, (queries_per_round + microbatch - 1) // microbatch)
        history.append({
            "round": r,
            "rows_absorbed": absorbed,
            "ingest_s": t_ingest,
            "query_s": t_query,
            "query_mean_s": t_query / nb,
            "queries_per_s": queries_per_round / t_query,
            "rmse": float(np.sqrt(np.mean((mu - truth) ** 2))),
            "ingest_rounds": router.ingest_rounds - rounds_before,
            "var_finite": bool(np.all(np.isfinite(var))),
            "reopt_s": t_reopt,
            "reopt_tenants": n_reopt,
        })
    return {"fit_s": t_fit, "tenants": tenants, "rounds": history,
            "M": bank.n_features, "engine": engine, "device": str(dev),
            "bank": router.bank}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="jnp", choices=fagp.available_backends())
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fleet", type=int, default=0, metavar="B",
                    help="serve a bank of B tenants instead of one session")
    ap.add_argument("--engine", default="pipelined", choices=["pipelined", "sync"],
                    help="fleet serving frontend (only 'sync' is ported)")
    ap.add_argument("--n-train", type=int, default=2048)
    ap.add_argument("--p", type=int, default=2)
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--update-size", type=int, default=64)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--microbatch", type=int, default=128)
    ap.add_argument("--reopt-every", type=int, default=0, metavar="K",
                    help="re-optimize stale tenants every K serving rounds")
    ap.add_argument("--noise", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.fleet:
        out = serve_fleet(
            backend=args.backend, tenants=args.fleet, n_train=args.n_train,
            p=args.p, n=args.n, rounds=args.rounds,
            queries_per_round=args.queries,
            observations_per_round=args.update_size,
            microbatch=args.microbatch, noise=args.noise, seed=args.seed,
            reopt_every=args.reopt_every, engine=args.engine, device=args.device,
        )
        print(f"fleet of {out['tenants']} fitted in {out['fit_s'] * 1e3:.1f} ms "
              f"(M={out['M']} each; {out['engine']} engine; device={out['device']})")
        for h in out["rounds"]:
            reopt = (f"; reopt {h['reopt_tenants']} tenants {h['reopt_s'] * 1e3:.1f} ms"
                     if h["reopt_tenants"] else "")
            print(f"round {h['round']}: ingest {h['rows_absorbed']} rows "
                  f"{h['ingest_s'] * 1e3:.1f} ms; query mean "
                  f"{h['query_mean_s'] * 1e3:.2f} ms/microbatch; "
                  f"{h['queries_per_s']:.0f} q/s; rmse {h['rmse']:.4f}{reopt}")
        out.pop("bank")
        print(json.dumps(out))
        return
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
