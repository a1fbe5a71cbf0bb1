"""GP serving loops: one session, or a whole fleet through the bank router.

Counterpart of ``repro/launch/serve_gp.py``:

* ``serve_gp``    ONE fitted session serves microbatched ``mean_var``
  queries while new observations stream in (rank-k ingest).
* ``serve_fleet`` MANY independent sessions (one per tenant) live in a
  :class:`~repro_torch.bank.GPBank` and traffic flows through a
  :class:`~repro_torch.bank.BankRouter`: by default through the pipelined
  :class:`~repro_torch.bank.FleetEngine` (``engine="pipelined"``), or the
  synchronous loop (``engine="sync"``); optionally re-optimizing stale
  tenants every few rounds (``reopt_every``), elastic over a cold tier of
  checkpoints with sliding-window forgetting (``cold_dir``, ``capacity``,
  ``window``: :class:`~repro_torch.bank.TieredBank`), with telemetry
  (``metrics``, ``tracer``, ``watchdog``: ``repro_torch.obs``), and
  sharded over the devices of a mesh (``shards``:
  :class:`~repro_torch.bank.ShardedGPBank`).

  python -m repro_torch.launch.serve_gp --backend pallas --device cuda \\
      --n-train 10000 --p 4 --n 11 --rounds 4 --update-size 64 \\
      --queries 1024 --microbatch 128
  python -m repro_torch.launch.serve_gp --backend pallas --device cuda \\
      --fleet 512 --n-train 10000 --p 4 --n 5 --rounds 4 \\
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

from ..bank import BankRouter, FleetEngine, GPBank, ShardedGPBank, TieredBank
from ..core import fagp
from ..core.gp import GP, GPSpec
from ..data import make_gp_dataset
from ..device import resolve_device
from ..obs import (
    NULL,
    NULL_TRACER,
    MetricsRegistry,
    Tracer,
    serving_watchdog,
    start_metrics_server,
)
from ..obs import metrics as obs_metrics

__all__ = ["serve_gp", "serve_fleet", "fleet_dataset", "microbatched_mean_var"]


def _sync(*devices: torch.device) -> None:
    for device in set(devices):
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
    max_in_flight: int = 4,
    queue_budget: int = 4096,
    slo_s=None,
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
    serving frontend in padded microbatches.  Reported per round, as in the
    JAX package: ingest time, query wall time, its mean per microbatch,
    fleet-wide queries/s, the RMSE against each tenant's own noise-free
    target, the timeout count, the re-optimization's time and tenants
    (``reopt_s``, ``reopt_tenants``) and the rows aged out (``aged_rows``);
    the port adds ``ingest_rounds`` (distinct-tenant update rounds) and
    ``var_finite``.  The returned dict carries the engine's cumulative
    latency metrics under ``"latency"`` when ``engine="pipelined"`` (else
    the registry's snapshot under ``"telemetry"`` when one was passed), the
    tier's ``"lifecycle"`` stats and the tier itself (``"tiered"``) with
    ``cold_dir``, and the final bank under ``"bank"``.

    ``engine`` selects the serving frontend: ``"pipelined"`` (default)
    drives a :class:`~repro_torch.bank.FleetEngine` (``max_in_flight``
    blocks dispatched ahead while the host packs the next, a
    ``queue_budget`` on admitted rows, expired tickets (``slo_s``) answered
    with the timeout sentinel instead of a seat in a padded block, the
    block size autotuned to the arrival rate); ``"sync"`` is the strict
    submit-all / flush / block loop.

    ``reopt_every > 0`` re-optimizes STALE tenants every that many rounds,
    after the round's ingest: tenants that absorbed >= ``reopt_min_rows``
    observations since their last optimization are re-learned with one
    batched ``GPBank.optimize`` run (``reopt_steps`` steps,
    ``reopt_restarts`` restarts) over their accumulated data, padded to
    a fixed row count and masked (``BankRouter.reoptimize``); the bank
    becomes heterogeneous and each tenant serves under its own learned
    hyperparameters.

    ``cold_dir`` turns the fleet ELASTIC (pipelined engine only): the bank
    becomes a :class:`~repro_torch.bank.TieredBank` with ``capacity`` hot
    slots (default: all tenants resident) fronting versioned per-tenant
    checkpoints under ``cold_dir``; traffic to cold tenants warm-restores
    them through the engine, evicting LRU tenants back to disk.
    ``window > 0`` additionally ages stale tenants before re-optimization:
    everything older than each stale tenant's newest ``window`` rows is
    forgotten by the batched rank-k downdate (masked-refit fallback on lost
    positive definiteness), and the re-optimization learns from the
    retained window.  Without ``cold_dir``, ``capacity`` and ``window``
    raise the JAX package's ``ValueError``.

    ``metrics`` / ``tracer`` / ``watchdog`` (``repro_torch.obs``) thread
    fleet telemetry through the router, the pipelined engine, the tiered
    lifecycle and the re-optimization.

    ``shards > 0`` shards the fleet's tenant axis over a ``shards``-way
    'bank' mesh (:class:`~repro_torch.bank.ShardedGPBank`, made from the
    fitted bank with ``pad_capacity=True``, or from the tier's): serving and
    ingest run shard-local, the router tracks per-shard occupancy and
    backlog, and paged-in tenants land on the least-loaded shard.  The mesh
    follows ``device``: on "cuda" it takes ``shards`` visible cards and
    raises with fewer; on "cpu" the shards share the CPU.  A sharded fleet
    is homogeneous, so ``shards`` with ``reopt_every`` raises the JAX
    package's ``ValueError``; the records add ``shards`` and
    ``shard_occupancy``.  Times are host-clock seconds around work that
    ends in ``torch.cuda.synchronize()`` of every card used.
    """
    if engine not in ("pipelined", "sync"):
        raise ValueError(f"engine must be 'pipelined' or 'sync', got {engine!r}")
    if shards and reopt_every:
        raise ValueError(
            "a sharded fleet is homogeneous-only (one spec across all "
            "shards); per-tenant re-optimization (reopt_every) needs the "
            "resident bank")
    if cold_dir is not None and engine != "pipelined":
        raise ValueError(
            "a tiered fleet (cold_dir) needs the pipelined engine: the "
            "sync router fail-fasts on cold tenants instead of paging")
    if (capacity is not None or window) and cold_dir is None:
        raise ValueError("capacity/window need a cold tier; pass cold_dir")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    spec = GPSpec.create(n, eps=np.full((p,), 0.8, np.float32), rho=2.0,
                         noise=noise, backend=backend, device=dev)
    offsets, Xb, yb, pools = fleet_dataset(
        rng, tenants=tenants, n_train=n_train, p=p, rounds=rounds,
        observations_per_round=observations_per_round, noise=noise, seed=seed)
    pool_rows = pools[0][0].shape[0]
    metrics = NULL if metrics is None else metrics
    tracer = NULL_TRACER if tracer is None else tracer

    _sync(dev)
    t0 = time.perf_counter()
    tiered = None
    if cold_dir is not None:
        tiered = TieredBank.fit(torch.from_numpy(Xb), torch.from_numpy(yb), spec,
                                cold_dir=cold_dir, capacity=capacity, window=window,
                                metrics=metrics, tracer=tracer)
        bank = tiered.bank
    else:
        bank = GPBank.fit(torch.from_numpy(Xb), torch.from_numpy(yb), spec)
    devs = [dev]
    if shards:
        from .mesh import make_bank_mesh

        mesh = make_bank_mesh(shards, devices=None if dev.type == "cuda" else [dev] * shards)
        bank = ShardedGPBank.from_bank(bank, mesh, pad_capacity=True)
        devs = list(mesh.devices.reshape(-1))
        if tiered is not None:
            tiered.adopt(bank)
    _sync(*devs)
    t_fit = time.perf_counter() - t0

    router = BankRouter(bank, microbatch=microbatch, ingest_chunk=ingest_chunk,
                        metrics=metrics, tracer=tracer)
    eng = None
    if engine == "pipelined":
        eng = FleetEngine(router, max_in_flight=max_in_flight, queue_budget=queue_budget,
                          default_slo_s=slo_s, tiered=tiered, metrics=metrics,
                          tracer=tracer, watchdog=watchdog)
    front = eng if eng is not None else router
    consumed = [n_train] * tenants
    history = []
    for r in range(rounds):
        # -- ingest: each tenant streams a few fresh observations ----------
        for _ in range(observations_per_round):
            t = int(rng.integers(0, tenants))
            X_all, y_all = pools[t]
            i = consumed[t] % X_all.shape[0]
            consumed[t] += 1
            front.observe(t, X_all[i], y_all[i])
        rounds_before = router.ingest_rounds
        t0 = time.perf_counter()
        absorbed = front.ingest()
        _sync(*devs)
        t_ingest = time.perf_counter() - t0

        # -- periodic re-optimization of stale tenants ---------------------
        t_reopt, n_reopt, n_aged = 0.0, 0, 0
        if reopt_every and (r + 1) % reopt_every == 0:
            # cold tenants keep their drift counters (retain=): paging a
            # tenant out for capacity must not reset its staleness
            stale = (router.stale_tenants(reopt_min_rows, retain=tiered.tenants)
                     if tiered is not None else router.stale_tenants(reopt_min_rows))
            aged = tiered is not None and window > 0
            if stale and aged:
                # age BEFORE re-optimizing: forget rows outside each stale
                # tenant's window, so the re-learned hyperparameters fit the
                # current regime, then re-optimize on the retained window
                tiered.adopt(router.bank)
                n_aged = tiered.age(stale)["forgotten_rows"]
                router.bank = tiered.bank
            if stale:
                # the row axis padded to a FIXED size (the window, else the
                # pool) and masked, as in the JAX loop, so every round's
                # stale data has one shape
                n_max = window if aged else pool_rows
                Xo = np.zeros((len(stale), n_max, p), np.float32)
                yo = np.zeros((len(stale), n_max), np.float32)
                mo = np.zeros((len(stale), n_max), np.float32)
                for i, t in enumerate(stale):
                    if aged:
                        Xw, yw = tiered.window_rows(t)
                        rows = len(yw)
                    else:
                        X_all, y_all = pools[t]
                        rows = min(consumed[t], X_all.shape[0])
                        Xw, yw = X_all[:rows], y_all[:rows]
                    Xo[i, :rows], yo[i, :rows], mo[i, :rows] = Xw, yw, 1.0
                t0 = time.perf_counter()
                router.reoptimize(stale, torch.from_numpy(Xo), torch.from_numpy(yo),
                                  mask=torch.from_numpy(mo), restarts=reopt_restarts,
                                  steps=reopt_steps, seed=seed)
                _sync(dev)
                t_reopt = time.perf_counter() - t0
                n_reopt = len(stale)
                if tiered is not None:
                    tiered.adopt(router.bank)

        # -- queries: mixed-tenant traffic through the frontend ------------
        q_tenants = rng.integers(0, tenants, queries_per_round)
        Xq = rng.uniform(-1.0, 1.0, size=(queries_per_round, p)).astype(np.float32)
        truth = np.sum(np.cos(Xq), axis=1) + offsets[q_tenants]
        timeouts = 0
        if eng is not None:
            # pipelined: submission itself dispatches blocks ahead
            # (auto_pump), drain() overlaps packing with device execution
            t0 = time.perf_counter()
            tickets = [eng.submit(int(t), Xq[i]) for i, t in enumerate(q_tenants)]
            results = eng.drain()
            t_query = time.perf_counter() - t0
            served = [i for i, tk in enumerate(tickets) if not results[tk].timed_out]
            timeouts = len(tickets) - len(served)
            mu = np.array([results[tickets[i]].mu for i in served])
            var = np.array([results[tickets[i]].var for i in served])
            truth = truth[served]
        else:
            tickets = [router.submit(int(t), Xq[i]) for i, t in enumerate(q_tenants)]
            t0 = time.perf_counter()
            results = router.flush()
            t_query = time.perf_counter() - t0
            mu = np.array([results[tk][0] for tk in tickets])
            var = np.array([results[tk][1] for tk in tickets])
        nb = max(1, (queries_per_round + microbatch - 1) // microbatch)
        history.append({
            "round": r,
            "rows_absorbed": absorbed,
            "ingest_s": t_ingest,
            "query_s": t_query,
            # one aggregate flush/drain is timed: a per-microbatch MEAN
            "query_mean_s": t_query / nb,
            "queries_per_s": queries_per_round / t_query,
            # RMSE of each served query against its own tenant's
            # (noise-free) Eq. 21 target sum_j cos(x_j) + offset_t
            "rmse": float(np.sqrt(np.mean((mu - truth) ** 2))),
            "timeouts": timeouts,
            "ingest_rounds": router.ingest_rounds - rounds_before,
            "var_finite": bool(np.all(np.isfinite(var))),
            "reopt_s": t_reopt,
            "reopt_tenants": n_reopt,
            "aged_rows": n_aged,
        })
    out = {"fit_s": t_fit, "tenants": tenants, "rounds": history,
           "M": bank.n_features, "engine": engine, "device": str(dev)}
    if shards:
        out["shards"] = shards
        out["shard_occupancy"] = [int(c) for c in router.bank.shard_occupancy()]
    if eng is not None:
        out["latency"] = eng.metrics()
    elif metrics is not NULL:
        out["telemetry"] = metrics.snapshot()
    if tiered is not None:
        out["lifecycle"] = dict(tiered.stats, capacity=tiered.capacity,
                                hot=len(tiered.hot_tenants), cold=len(tiered.cold_tenants))
        out["tiered"] = tiered
    out["bank"] = router.bank
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="jnp", choices=fagp.available_backends())
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fleet", type=int, default=0, metavar="B",
                    help="serve a bank of B tenants instead of one session")
    ap.add_argument("--n-train", type=int, default=2048)
    ap.add_argument("--p", type=int, default=2)
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--update-size", type=int, default=64)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--microbatch", type=int, default=128)
    ap.add_argument("--reopt-every", type=int, default=0, metavar="K",
                    help="re-optimize stale tenants every K serving rounds")
    ap.add_argument("--engine", default="pipelined", choices=["pipelined", "sync"],
                    help="fleet serving frontend (pipelined FleetEngine vs the "
                         "strict synchronous loop)")
    ap.add_argument("--max-in-flight", type=int, default=4,
                    help="dispatch-ahead depth of the pipelined engine")
    ap.add_argument("--slo", type=float, default=None, metavar="SECONDS",
                    help="per-ticket deadline; expired tickets get the timeout "
                         "sentinel instead of a device slot")
    ap.add_argument("--capacity", type=int, default=None, metavar="C",
                    help="hot slots in a tiered fleet (< --fleet pages the rest "
                         "to the cold tier); needs --cold-dir")
    ap.add_argument("--cold-dir", default=None, metavar="DIR",
                    help="cold-tier checkpoint directory (enables the TieredBank "
                         "lifecycle; pipelined engine only)")
    ap.add_argument("--window", type=int, default=0, metavar="W",
                    help="sliding-window length: before each reopt, forget rows "
                         "older than each stale tenant's newest W (rank-k "
                         "downdate); needs --cold-dir")
    ap.add_argument("--shards", type=int, default=0, metavar="S",
                    help="shard the fleet's tenant axis over an S-way 'bank' mesh "
                         "(needs S visible cards with --device cuda; on the CPU the "
                         "shards share it)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve Prometheus text at http://127.0.0.1:PORT/metrics "
                         "while the fleet runs (0 = ephemeral port; fleet mode only)")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write pipeline spans as Chrome-trace JSONL to FILE on "
                         "exit (fleet mode only)")
    ap.add_argument("--watchdog", default=None, choices=["warn", "raise", "count"],
                    help="arm the recompile watchdog over the serving functions "
                         "(fleet mode only)")
    ap.add_argument("--noise", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.fleet:
        obs_on = args.metrics_port is not None or args.trace_out or args.watchdog
        reg = MetricsRegistry() if obs_on else None
        tracer = Tracer() if args.trace_out else None
        wd = serving_watchdog(mode=args.watchdog, metrics=reg) if args.watchdog else None
        server = None
        if reg is not None:
            # the checkpoint store's counters publish to the process
            # default: point it here so one scrape sees the whole fleet
            obs_metrics.set_default(reg)
        if args.metrics_port is not None:
            server = start_metrics_server(reg, port=args.metrics_port)
            print(f"metrics: {server.url}")
        try:
            out = serve_fleet(
                backend=args.backend, tenants=args.fleet, n_train=args.n_train,
                p=args.p, n=args.n, rounds=args.rounds,
                queries_per_round=args.queries,
                observations_per_round=args.update_size,
                microbatch=args.microbatch, noise=args.noise, seed=args.seed,
                reopt_every=args.reopt_every, engine=args.engine,
                max_in_flight=args.max_in_flight, slo_s=args.slo,
                capacity=args.capacity, cold_dir=args.cold_dir, window=args.window,
                shards=args.shards, metrics=reg, tracer=tracer, watchdog=wd,
                device=args.device,
            )
        finally:
            if tracer is not None:
                print(f"trace: {tracer.write_jsonl(args.trace_out)} events -> "
                      f"{args.trace_out}")
            if server is not None:
                server.shutdown()
            if reg is not None:
                obs_metrics.set_default(NULL)
        print(f"fleet of {out['tenants']} fitted in {out['fit_s'] * 1e3:.1f} ms "
              f"(M={out['M']} each; {out['engine']} engine; device={out['device']})")
        for h in out["rounds"]:
            reopt = (f"; reopt {h['reopt_tenants']} tenants {h['reopt_s'] * 1e3:.1f} ms"
                     if h["reopt_tenants"] else "")
            tmo = f"; {h['timeouts']} timeouts" if h["timeouts"] else ""
            print(f"round {h['round']}: ingest {h['rows_absorbed']} rows "
                  f"{h['ingest_s'] * 1e3:.1f} ms; query mean "
                  f"{h['query_mean_s'] * 1e3:.2f} ms/microbatch; "
                  f"{h['queries_per_s']:.0f} q/s; rmse {h['rmse']:.4f}{tmo}{reopt}")
        if "latency" in out:
            o = out["latency"]["overall"]
            print(f"engine: p50 {o['p50_s'] * 1e3:.2f} ms, p99 {o['p99_s'] * 1e3:.2f} ms "
                  f"per ticket; sustained {o['sustained_qps']:.0f} q/s; "
                  f"{o['expired']} expired; buckets "
                  f"{sorted(out['latency']['bucket_uses'].items())}")
        if "shards" in out:
            print(f"sharded across {out['shards']} devices; occupancy "
                  f"{out['shard_occupancy']}")
        if "lifecycle" in out:
            lc = out["lifecycle"]
            print(f"lifecycle: {lc['hot']}/{lc['capacity']} hot, {lc['cold']} cold; "
                  f"{lc['warm_restores']} restores, {lc['evictions']} evictions, "
                  f"{lc['cold_saves']} saves; {lc['downdated_rows']} rows forgotten "
                  f"({lc['refit_fallbacks']} refit fallbacks)")
        out.pop("bank")
        out.pop("tiered", None)
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
