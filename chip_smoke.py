#!/usr/bin/env python3
"""Prove on an NVIDIA card that the PyTorch/CUDA port starts and is right.

    python3 chip_smoke.py        # from the repository root; needs one card

Drives ``src/repro_torch`` only (no JAX, nothing of ``src/repro``):

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (printing
   each kernel's registers and spills, the fused fit's launch plans at
   the main path's, its RFF path's and the fleet's shapes, and the plans of
   the scaled Gram, float32 and bfloat16, at phase 6's shape and of the
   batched sweep at the fleet's, with their registers) and holds each
   one against its plain PyTorch version on the card, at the main path's
   shapes and at one ragged shape, with the tolerance stated; times kernel,
   plain version and (where one exists) a single PyTorch library call
   computing the same function (CUDA events, 2 warm-up runs, median of 20
   runs; the plain rank-K sweep is timed once, it takes over a minute);
   the RFF fused fit (M = 8,192) is timed on a line of its own.  Diag-quad
   also runs at the RFF path's M = 8,192, on 1 and 200 queries and with a
   C that is not symmetric (its plan, the split S of the k axis, printed); the
   single-system sweep (its grid printed) is held bitwise against the
   one-block kernel on a G = 2 batch of the same system, then at edge
   shapes (M < 32, M not a multiple of 32, K = 1, W swept in chunks,
   several row groups per block), and the latency of one anti-diagonal
   step is measured for its pivot-chain bound.  The features kernel is
   timed at each of the six shapes its paths give it (128 and 64 x 14,641
   here, 128 x 8,192 RFF, the fleet's two and phase 6's below), its launch
   plan and registers printed: ``kernel_ms`` is the device time of one
   launch (50 launches into one output captured in a CUDA graph, the
   replays timed with CUDA events), ``call_ms`` what a caller pays (CUDA
   events around ``ops.expansion_phi``, host checks and allocation
   included); at phase 6's shape torch.profiler's device time is read too;
3. runs the main path at paper scale: ``serve_gp(backend="pallas",
   device="cuda")`` with N = 10^4, p = 4, n = 11, full grid (M = 14,641),
   4 rounds of 64-row updates, 1,024 queries in microbatches of 128, then
   ``gp.nlml`` once; checks the rmse, the nlml and each kernel's launch
   count on that run; then a small session on the card (its launches
   counted too) against the same session on the CPU;
4. at N = 10^4, fits and serves 1,024 queries on the kernels (backend
   "pallas") and on the plain path (backend "jnp"), both on the card, for
   the Hermite expansion at M = 14,641 and for the RFF path (rff_se,
   R = 4,096, M = 8,192); holds u, the means and the variances of the two
   against each other at the JAX package's gates, and counts the launches
   of each run (the kernel path's exactly, the plain path's none);
5. the fleet: ``serve_fleet(engine="sync", backend="pallas",
   device="cuda")`` with 512 tenants of N = 10^4, p = 4, n = 5 (M = 625),
   4 rounds of 2,048 observations (chunks of 16) and 8,192 queries
   (microbatches of 256), its launch counts exact (one bank fit, a batched
   sweep per ingest round, a feature launch per microbatch and per ingest
   round); then on the same data the bank kernel (plain and ragged masks),
   the features kernel (a 256-query microbatch and an ingest round's
   8,192 rows, each timed beside its bound) and the batched sweep against
   their plain versions and the library refactor (the sweep also bitwise
   against the cooperative kernel system by system, its inputs untouched,
   its pivot-chain bound printed), a ragged bank fit against single fits,
   ``GPBank.update``'s launches and immutability, bank serving against
   single-session serving of the same states (16 tenants, 1e-5 abs), a
   mixed-tenant microbatch of the fitted fleet on the kernel path against
   the plain (``jnp``) path on the same states, an insert/evict round trip,
   and a small RFF fleet (rff_se, M = 512, 64 tenants of N = 2,000) through
   ``GPBank`` and ``BankRouter`` with its own launch counts.  Every plain
   version is checked to launch nothing;
6. the paper's materialized pipeline at ``MAIN``'s full width (N = 10^4,
   M = 14,641): ``GP.fit`` with ``store_train=True`` (one fused-fit and one
   features launch; u bitwise equal to a fit without stored features; the
   stored Phi, the features kernel's 8-column launch, against its plain
   version; the features kernel timed at that shape), then the scaled-Gram kernel on the
   stored Phi (one launch), held against
   its plain version and, bitwise, against the fused-fit kernel's B, the u
   solved from it against the state's; kernel, plain and ``Phi^T Phi``
   timed, and the two-pass materialized fit against the one-pass fused fit
   (time and peak memory); the kernel at a ragged shape, at the fleet's
   M = 625 and on a bfloat16 Phi; ``predict(mode="paper")`` on 1,024
   queries (timed, finite, its gap to the fused mode printed), the same
   chain in float64 against the float64 fused mode at full width, and, at
   N = 50, float32 paper mode equal to the fused mode; ``GP.save`` /
   ``GP.load`` of the full-width session, bitwise.

Prints the features kernel's times by shape on a ``[features]`` line, one
JSON line with every kernel's numbers (the features kernel's ``ms`` its
device time at 128 x 14,641, beside its ``call_ms``), then, as the last
line, ``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero.
Bounds use the H100 SXM's published float32 CUDA-core rate and memory
rate (67 TFLOP/s, 3.35 TB/s at 700 W); the power limit is printed beside.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_F32 = 67e12      # FLOP/s, H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # B/s, H100 SXM HBM3

MAIN = dict(n_train=10_000, p=4, n=11, rounds=4, update_size=64,
            queries=1024, microbatch=128, noise=0.05, seed=0)
# launches the main path makes: 1 fit + 1 nlml fused fit; a sweep per
# round; a diag-quad and a feature launch per microbatch (8 per round);
# a feature launch per update round
EXPECTED = {
    "phi_features": {"": 36},
    "phi_gram": {"scale": 1, "moments": 1},
    "diag_quad": {"": 32},
    "chol_update": {"": 4},
    "scaled_gram": {},
}
# the small session on the card: 1 fit; per round (2) one update (a
# feature launch and a sweep, K·8 = 48 <= M = 64) and 2 microbatches; then
# one mean_var of 300 rows
SMALL = dict(n_train=2000, p=2, n=8, rounds=2, update_size=6, queries=256,
             microbatch=128, noise=0.05, seed=3)
SMALL_EXPECTED = {
    "phi_features": {"": 7},
    "phi_gram": {"scale": 1},
    "diag_quad": {"": 5},
    "chol_update": {"": 2},
    "scaled_gram": {},
}
# phase 5, the fleet (serve_fleet(engine="sync")): 512 paper-scale tenants
# (benchmarks/fig1_time_vs_n_p.py grid point N = 10^4, p = 4, n = 5, M = 625)
FLEET = dict(tenants=512, n_train=10_000, p=4, n=5, rounds=4,
             observations_per_round=2048, ingest_chunk=16, queries_per_round=8192,
             microbatch=256, noise=0.05, seed=0)
# a small RFF fleet (rff_se, R = 256 -> M = 512) through GPBank and the router
RFF_FLEET = dict(tenants=64, n_train=2000, num_features=256, observations=512,
                 queries=2048, microbatch=256, seed=1)
# phase 4, kernel path: 1 fit, 8 microbatches of mean_var, no update
PATH_EXPECTED = {
    "phi_features": {"": 8},
    "phi_gram": {"scale": 1},
    "diag_quad": {"": 8},
    "chol_update": {},
    "scaled_gram": {},
}
# phase 6, the stored-features fit: one fused fit (the Gram) and one
# features launch (the stored Phi); then one scaled-Gram launch on it
PAPER_FIT_EXPECTED = {
    "phi_features": {"": 1},
    "phi_gram": {"scale": 1},
    "diag_quad": {},
    "chol_update": {},
    "scaled_gram": {},
}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def ptxas_functions(log: str):
    """(kernel, registers, spills) for each kernel ``-Xptxas -v`` reported,
    the kernel by its mangled name (its identifier is in it)."""
    out, fn, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn is not None:
            out.append((fn, line.split(":", 1)[1].strip(), spill))
            fn, spill = None, ""
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import fagp
    from repro_torch.core.expansions import get_expansion
    from repro_torch.core.gp import GP, GPSpec
    from repro_torch.data import make_gp_dataset
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import chol_update as kchol
    from repro_torch.kernels import diag_quad as kdq
    from repro_torch.kernels import gram as ksg
    from repro_torch.kernels import hermite_phi as kphi
    from repro_torch.kernels import phi_gram as kgram
    from repro_torch.bank import BankRouter, GPBank
    from repro_torch.launch.serve_gp import (
        fleet_dataset, microbatched_mean_var, serve_fleet, serve_gp,
    )

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # -- 2. build, then each kernel against its plain version ---------------
    t0 = time.perf_counter()
    _build.library("phi_features")
    print(f"[build] {len(_build.SOURCES)} kernels built in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in _build.ptxas_report().items():
        for fn, regs, spill in ptxas_functions(log):
            print(f"[ptxas {name}: {fn}] {regs}; {spill}")
    # the fused fit's launches: the main path's, its RFF path's (R = 4,096)
    # and the fleet's bank kernel
    for label, args in (
        ("phi_gram", (MAIN["n_train"], MAIN["n"] ** MAIN["p"], 1, "hermite", MAIN["p"],
                      MAIN["n"])),
        ("phi_gram rff", (MAIN["n_train"], 8192, 1, "rff", MAIN["p"], 1)),
        ("phi_gram.bank", (FLEET["n_train"], FLEET["n"] ** FLEET["p"], FLEET["tenants"],
                           "hermite", FLEET["p"], FLEET["n"])),
    ):
        print(f"[plan {label}] N={args[0]} M={args[1]} slots={args[2]}: "
              f"{json.dumps(kgram.phi_gram_plan(*args))}")
    # the scaled Gram's launches (phase 6's stored Phi, float32 and
    # bfloat16) and the batched sweep's (the fleet's ingest round), each
    # with its kernel's registers and spills
    kernel_regs = {fn: f"{regs}; {spill}" for log in _build.ptxas_report().values()
                   for fn, regs, spill in ptxas_functions(log)}

    def regs_of(ident):
        return "; ".join(v for fn, v in kernel_regs.items() if ident in fn)

    for label, bf16, ident in (("scaled_gram f32", False, "scaled_gram_kernelIf"),
                               ("scaled_gram bf16", True, "scaled_gram_kernelIt")):
        print(f"[plan {label}] N={MAIN['n_train']} M={MAIN['n'] ** MAIN['p']}: "
              f"{json.dumps(ksg.scaled_gram_plan(MAIN['n_train'], MAIN['n'] ** MAIN['p'], bf16))}"
              f"; {regs_of(ident)}")
    print(f"[plan chol_update.batched] G={FLEET['tenants']} M={FLEET['n'] ** FLEET['p']} "
          f"K={FLEET['ingest_chunk']}: "
          f"{json.dumps(kchol.chol_update_batch_plan(FLEET['n'] ** FLEET['p'], FLEET['ingest_chunk']))}"
          f"; {regs_of('chol_batch_kernel')}")

    def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def bound(flops: float, nbytes: float):
        t_ops, t_bytes = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    def compare(label, got, want, rtol, atol, why, scales=None):
        """Pass when |got - want| <= atol + rtol * max(|want|, scale)
        elementwise; ``scales`` (one tensor or None per output) holds the
        Cauchy-Schwarz magnitude of a sum's terms where the sum can cancel
        to far below them."""
        got, want = [g.float() for g in got], [w.float() for w in want]
        scales = scales or [None] * len(got)
        err, worst = 0.0, 0.0
        for g, w, sc in zip(got, want, scales):
            diff = (g - w).abs()
            ref = w.abs() if sc is None else torch.maximum(w.abs(), sc)
            err = max(err, float(diff.max()))
            worst = max(worst, float((diff / (atol + rtol * ref)).max()))
        ok = worst <= 1.0
        print(f"[check] {label}: max_abs_err={err:.3e} tol=rtol {rtol:g}, "
              f"atol {atol:g} ({why}); worst error/tolerance {worst:.3f} "
              f"-> {'ok' if ok else 'FAIL'}")
        check(ok, f"{label} disagrees with its plain version")
        return err

    def plain(fn):
        """Run a plain version and check that it launched no kernel."""
        before = ops.launch_counts()
        out = fn()
        check(ops.launch_counts() == before, "a plain version launched a kernel")
        return out

    def gram_scales(X, y, mask, tile, d, sig2, scale):
        """Cauchy-Schwarz magnitudes of the fused fit's sums:
        |G_ij| <= |phi_i| |phi_j| and |b_i| <= |phi_i| |y| over the masked
        rows (an f32 sum of N terms errs relative to these, not to a
        result that cancels)."""
        colsq = torch.zeros(tile.M, device=X.device)
        for lo in range(0, X.shape[0], 4096):
            ph = kphi.phi_features_plain(X[lo:lo + 4096], tile) * mask[lo:lo + 4096, None]
            colsq += (ph * ph).sum(0)
        cn = colsq.sqrt()
        sG = cn[:, None] * cn[None, :]
        if scale:
            sG = sG * (d[:, None] * d[None, :] / sig2)
        return [sG, cn * float((y * mask).norm())]

    def graph_ms(launch, reps: int = 50, replays: int = 10) -> float:
        """Device time of one launch: ``reps`` launches captured in a CUDA
        graph (a ctypes launch runs on the current stream, the capture
        stream inside ``torch.cuda.graph``), its replays timed with CUDA
        events, divided by ``reps``; median of ``replays``."""
        launch()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                launch()
        g.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(replays):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
        return statistics.median(times)

    def profiler_ms(launch, name: str, reps: int = 20):
        """The mean device time torch.profiler records for kernels whose
        name holds ``name`` over ``reps`` launches (None where it records
        none): a cross-check of graph_ms."""
        from torch.profiler import ProfilerActivity, profile

        launch()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                launch()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if name in e.key]
        total = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
                    for e in hits)
        count = sum(e.count for e in hits)
        return total / count / 1e3 if count and total else None

    features = {}

    def features_line(Xr, t, n_, profile=False):
        """The features kernel at Xr's shape: its launch plan and the
        registers of the instance it runs; its device time (graph_ms, the
        launches writing one preallocated output) and a caller's time
        (CUDA events around ops.expansion_phi), beside its bound and its
        plain version's time; with ``profile``, torch.profiler's device
        time too.  Kept in ``features`` by shape."""
        Xr = Xr.contiguous()
        Nr, pr = Xr.shape
        b = bound(Nr * t.M * (pr - 1) + Nr * pr * n_ * 6,
                  4 * (Xr.numel() + Nr * t.M + t.M * pr + pr * 3))
        plan = kphi.phi_features_plan(Nr, t.M, t.kind, pr, t.n_max)
        out = torch.empty((Nr, t.M), device=dev)
        r = dict(kernel_ms=graph_ms(lambda: kphi.phi_features_launch(Xr, t, out)),
                 call_ms=cuda_ms(lambda: ops.expansion_phi(Xr, t)),
                 plain_ms=cuda_ms(lambda: kphi.phi_features_plain(Xr, t), reps=5, warmup=1),
                 bound=b)
        label = f"{Nr}x{t.M}{' rff' if t.kind == 'rff' else ''}"
        ident = (f"phi_features_kernelILi{kphi.KINDS[t.kind]}ELi{pr if pr <= 8 else 0}"
                 f"ELi{plan['cols_per_thread']}E")
        print(f"[plan phi_features {label}] {json.dumps(plan)}; {regs_of(ident)}")
        extra = ""
        if profile:
            try:
                pm = profiler_ms(lambda: kphi.phi_features_launch(Xr, t, out), "phi_features")
            except Exception as e:  # a cross-check only: the graph's time stands
                pm, extra = None, f" (torch.profiler failed: {type(e).__name__}: {e})"
            r["profiler_ms"] = pm
            extra = (f" profiler_ms={pm:.4f}" if pm is not None else
                     extra or " (torch.profiler recorded no device time)")
        cold = " (output > 50 MB L2: every launch cold)" if 4 * Nr * t.M > 50e6 else ""
        print(f"[kernel] phi_features ({label}): kernel_ms={r['kernel_ms']:.4f} "
              f"call_ms={r['call_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={b[0]:.4f} ({b[1]}){extra}{cold}")
        features[label] = r
        del out
        return r

    def spec_for(expansion, p, n=1, R=None, noise=0.05):
        if expansion == "hermite":
            return GPSpec.create(n, eps=np.full((p,), 0.8, np.float32), rho=2.0,
                                 noise=noise, backend="pallas", device=dev)
        return GPSpec.create_rff(np.full((p,), 0.8, np.float32), noise,
                                 num_features=R, seed=0, backend="pallas",
                                 device=dev)

    def tile_of(spec):
        idx = fagp._idx_tensor(spec)
        exp = get_expansion(spec.expansion)
        return (exp.tile_args(spec, idx),
                torch.exp(0.5 * exp.log_eigenvalues(idx, spec)),
                float(spec.noise**2))

    rows = {}
    N, p, n = MAIN["n_train"], MAIN["p"], MAIN["n"]
    total = N + MAIN["rounds"] * MAIN["update_size"]
    X_all, y_all, Xs, ys = make_gp_dataset(total, p, noise=MAIN["noise"],
                                           seed=MAIN["seed"], device=dev)
    X0, y0 = X_all[:N].contiguous(), y_all[:N].contiguous()
    spec = spec_for("hermite", p, n)
    tile, sqrtlam, sig2 = tile_of(spec)
    M = tile.M
    print(f"[shapes] main path: N={N} p={p} n={n} M={M}")
    gen = torch.Generator(device="cpu").manual_seed(1)

    # features (TPU #2): a query microbatch (128 rows) and an update (64)
    Xq = Xs[:MAIN["microbatch"]].contiguous()
    Xn = X_all[N:N + MAIN["update_size"]].contiguous()
    tol_phi = dict(rtol=4e-5 * max(4, n), atol=1e-5,
                   why="tests/test_kernels.py:48 gate, two f32 recurrences")
    err = max(compare(f"phi_features ({r.shape[0]}x{M})",
                      [ops.expansion_phi(r, tile)], [kphi.phi_features_plain(r, tile)],
                      **tol_phi) for r in (Xq, Xn))
    fq = features_line(Xq, tile, n)
    features_line(Xn, tile, n)
    rows["phi_features"] = dict(
        source="src/repro_torch/kernels/csrc/phi_features.cu",
        replaces="src/repro/kernels/hermite_phi.py:102", max_abs_err=err,
        ms=fq["kernel_ms"], call_ms=fq["call_ms"], plain_ms=fq["plain_ms"],
        library_ms=None, bound=fq["bound"])

    # fused fit (TPU #1): scale=True (GP.fit), scale=False + mask (GP.nlml)
    # a tenth of the tests/test_streaming_fit.py:55 gate (1e-3), relative to
    # the sums' Cauchy-Schwarz magnitude: TF32 inputs (rounded by 2^-11)
    # may err by up to 9.8e-4 of it, float32 FMA by ~1e-5 at N = 10^4
    tol_fit = dict(rtol=1e-4, atol=1e-5, why="1e-4 of the sums' Cauchy-Schwarz "
                   "magnitude, below TF32's 9.8e-4")
    ones = torch.ones(N, device=dev)
    mask = (torch.rand(N, generator=gen) > 0.1).float().to(dev)
    B, b = ops.fused_fit_moments(X0, y0, tile, sqrtlam, sig2)
    err = compare(f"phi_gram scale=True ({N}x{M})", [B, b],
                  kgram.phi_gram_plain(X0, y0, ones, tile, sqrtlam, sig2, True),
                  scales=gram_scales(X0, y0, ones, tile, sqrtlam, sig2, True), **tol_fit)
    check(bool(torch.equal(B, B.T)), "the fused fit's B is not exactly symmetric")
    G, bm = ops.fused_fit_moments(X0, y0, tile, None, 1.0, mask, scale=False)
    err = max(err, compare(f"phi_gram scale=False masked ({N}x{M})", [G, bm],
                           kgram.phi_gram_plain(X0, y0, mask, tile, torch.ones_like(sqrtlam),
                                                1.0, False),
                           scales=gram_scales(X0, y0, mask, tile, None, 1.0, False),
                           **tol_fit))
    del G, bm
    Phi0 = kphi.phi_features_plain(X0, tile)
    g_flops = N * M * (M + 1) + 2 * N * M
    g_bytes = 4 * (X0.numel() + 2 * N + M * p + M + M * M + M)
    rows["phi_gram"] = dict(
        source="src/repro_torch/kernels/csrc/phi_gram.cu",
        replaces="src/repro/kernels/phi_gram.py:123", max_abs_err=err,
        ms=cuda_ms(lambda: ops.fused_fit_moments(X0, y0, tile, sqrtlam, sig2)),
        plain_ms=cuda_ms(lambda: kgram.phi_gram_plain(X0, y0, ones, tile, sqrtlam,
                                                      sig2, True)),
        library_ms=cuda_ms(lambda: Phi0.T @ Phi0), bound=bound(g_flops, g_bytes))
    del Phi0

    # RFF fused fit at its path's width (R = 4,096, M = 8,192)
    rspec = spec_for("rff_se", p, R=4096)
    rtile, rsq, rsig2 = tile_of(rspec)
    Br, br = ops.fused_fit_moments(X0, y0, rtile, rsq, rsig2)
    rows["phi_gram"]["max_abs_err"] = max(rows["phi_gram"]["max_abs_err"], compare(
        f"phi_gram rff scale=True ({N}x{rtile.M})", [Br, br],
        kgram.phi_gram_plain(X0, y0, ones, rtile, rsq, rsig2, True),
        scales=gram_scales(X0, y0, ones, rtile, rsq, rsig2, True), **tol_fit))
    compare(f"phi_features rff ({Xq.shape[0]}x{rtile.M})",
            [ops.expansion_phi(Xq, rtile)], [kphi.phi_features_plain(Xq, rtile)],
            rtol=1e-5, atol=2e-5, why="f32 cosf of the same sums")
    features_line(Xq, rtile, 1)
    # the RFF fused fit's own time (the same kernel, a cosine per feature)
    RM = rtile.M
    Phir = kphi.phi_features_plain(X0, rtile)
    rff_fit = dict(
        ms=cuda_ms(lambda: ops.fused_fit_moments(X0, y0, rtile, rsq, rsig2)),
        plain_ms=cuda_ms(lambda: kgram.phi_gram_plain(X0, y0, ones, rtile, rsq, rsig2, True)),
        library_ms=cuda_ms(lambda: Phir.T @ Phir),
        bound=bound(N * RM * (RM + 1) + 2 * N * RM,
                    4 * (X0.numel() + 2 * N + (p + 1) * RM + RM + RM * RM + RM)))
    del Phir
    print(f"[kernel] phi_gram rff ({N}x{RM}): ms={rff_fit['ms']:.4f} "
          f"plain_ms={rff_fit['plain_ms']:.4f} library_ms={rff_fit['library_ms']:.4f} "
          f"bound_ms={rff_fit['bound'][0]:.4f} ({rff_fit['bound'][1]})")
    C_rff = torch.cholesky_inverse(torch.linalg.cholesky(Br))
    del Br, br

    # diag-quad (TPU #3): A = Phi* D, C = B^-1 of the fitted system
    chol = torch.linalg.cholesky(B)
    del B
    C = torch.cholesky_inverse(chol)
    A = (ops.expansion_phi(Xq, tile) * sqrtlam[None, :]).contiguous()
    err = compare(f"diag_quad ({A.shape[0]}x{M})", [ops.diag_quad(A, C)],
                  [kdq.diag_quad_plain(A, C)], rtol=2e-3, atol=1e-5,
                  why="tests/test_kernels.py:168 variance gate")
    q_flops = 2 * A.shape[0] * M * M + 2 * A.shape[0] * M
    q_bytes = 4 * (A.numel() + M * M + A.shape[0])
    rows["diag_quad"] = dict(
        source="src/repro_torch/kernels/csrc/diag_quad.cu",
        replaces="src/repro/kernels/diag_quad.py:44", max_abs_err=err,
        ms=cuda_ms(lambda: ops.diag_quad(A, C)),
        plain_ms=cuda_ms(lambda: kdq.diag_quad_plain(A, C)),
        library_ms=cuda_ms(lambda: ((A @ C) * A).sum(1)), bound=bound(q_flops, q_bytes))
    print(f"[diag_quad] plan at {A.shape[0]} x {M}: {json.dumps(kdq.diag_quad_plan(*A.shape))}")
    # the other shapes the kernel meets: the RFF path's C (M = 8,192), one
    # query, 200 queries (two row tiles), and a C that is not symmetric
    Ar = (ops.expansion_phi(Xq, rtile) * rsq[None, :]).contiguous()
    # (B^-1 from torch.cholesky_inverse is column-major: the wrapper reads
    # it as its transpose; this C is row-major, read as it is)
    Cn = (C + torch.randn(M, M, generator=torch.Generator(device=dev).manual_seed(2),
                          device=dev) * (1e-3 / M ** 0.5)).contiguous()
    check(not bool(torch.equal(Cn, Cn.T)), "the non-symmetric C is symmetric")
    A200 = (ops.expansion_phi(Xs[:200].contiguous(), tile) * sqrtlam[None, :]).contiguous()
    for what, Aq, Cq in (("rff", Ar, C_rff), ("", A[:1].contiguous(), C), ("", A200, C),
                         ("C not symmetric", A, Cn)):
        label = f"{what} {Aq.shape[0]}x{Aq.shape[1]}".strip()
        print(f"[diag_quad] plan at {label}: {json.dumps(kdq.diag_quad_plan(*Aq.shape))}")
        rows["diag_quad"]["max_abs_err"] = max(rows["diag_quad"]["max_abs_err"], compare(
            f"diag_quad {label}", [ops.diag_quad(Aq, Cq)], [kdq.diag_quad_plain(Aq, Cq)],
            rtol=2e-3, atol=1e-5, why="tests/test_kernels.py:168 variance gate"))
    del C, Cn, C_rff, Ar, A200

    # rank-K sweep: L = chol(B), W = Phi_new D / sigma (K = 64)
    W = (ops.expansion_phi(Xn, tile) * sqrtlam[None, :] / spec.noise).contiguous()
    K = W.shape[0]
    L1 = ops.chol_update(chol, W)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Lp = kchol.chol_update_plain(chol, W)
    torch.cuda.synchronize()
    plain_sweep_ms = (time.perf_counter() - t0) * 1e3
    tol_chol = dict(rtol=5e-3, atol=1e-3, why="tests/test_streaming_fit.py:214 chol gate")
    err = compare(f"chol_update vs plain sweep (M={M}, K={K})", [L1], [Lp], **tol_chol)
    del Lp
    lib_L = torch.linalg.cholesky(chol @ chol.T + W.T @ W)
    compare(f"chol_update vs chol(LL^T + W^TW) (M={M}, K={K})", [L1], [lib_L], **tol_chol)
    del lib_L, L1
    s_flops = 6 * K * M * (M - 1) / 2
    s_bytes = 4 * (2 * M * (M + 1) / 2 + K * M)
    rows["chol_update"] = dict(
        source="src/repro_torch/kernels/csrc/chol_update.cu",
        replaces="src/repro/core/fagp.py:1052", max_abs_err=err,
        ms=cuda_ms(lambda: ops.chol_update(chol, W), reps=20, warmup=1),
        plain_ms=plain_sweep_ms,
        library_ms=cuda_ms(lambda: torch.linalg.cholesky(chol @ chol.T + W.T @ W),
                           reps=20, warmup=1),
        bound=bound(s_flops, s_bytes))
    print(f"[chol_update] plan at M={M}, K={K}: {json.dumps(kchol.chol_update_plan(M, K))}")
    # the cooperative sweep against the one-block kernel on a G = 2 batch of
    # the same system: the same rotations, rounded alike, so equal bits
    L1 = ops.chol_update(chol, W)
    Lb = ops.chol_update(torch.stack([chol, chol]), torch.stack([W, W]))
    diff = float((L1 - Lb[0]).abs().max())
    print(f"[check] chol_update (cooperative) vs the one-block kernel (M={M}, K={K}): "
          f"max_abs_diff={diff:.3e}")
    check(bool(torch.equal(L1, Lb[0])) and bool(torch.equal(Lb[0], Lb[1])),
          f"chol_update M={M}, K={K}: the cooperative sweep is not bitwise equal to "
          f"the one-block kernel (max abs diff {diff:.3e})")
    # a batch of one system, L (1, M, M), takes the cooperative sweep too
    ops.reset_launch_counts()
    L1b = ops.chol_update(chol[None], W[None])
    check(ops.launch_counts()["chol_update"] == {"": 1},
          f"chol_update on a batch of one launched {ops.launch_counts()['chol_update']}")
    check(bool(torch.equal(L1b[0], L1)),
          f"chol_update M={M}, K={K}: a batch of one differs from the 2-D call")
    print(f"[check] chol_update bitwise equal to the one-block kernel and on a batch "
          f"of one (M={M}, K={K}) -> ok")
    del L1, Lb, L1b
    del chol, W
    torch.cuda.empty_cache()

    # sweep edge shapes through the cooperative kernel: M < 32, M not a
    # multiple of 32, K = 1, K large enough that W is swept in chunks
    # (against the plain version), and the same chunking at M = 4,096,
    # K = 512 and a grid with several row groups per block (against the
    # one-block kernel and the refactor: the plain version would take
    # minutes there)
    for Me, Ke, vs_plain in ((20, 4, True), (1000, 16, True), (300, 1, True),
                             (96, 400, True), (4096, 512, False), (8192, 200, False)):
        Re = torch.randn(Me, Me, generator=gen).to(dev)
        Le = torch.linalg.cholesky(torch.eye(Me, device=dev) + Re @ Re.T / Me)
        We = (torch.randn(Ke, Me, generator=gen) * 0.3).to(dev)
        plan = kchol.chol_update_plan(Me, Ke)
        got = ops.chol_update(Le, We)
        one = ops.chol_update(torch.stack([Le, Le]), torch.stack([We, We]))[0]
        want = (plain(lambda: kchol.chol_update_plain(Le, We)) if vs_plain
                else torch.linalg.cholesky(Le @ Le.T + We.T @ We))
        compare(f"chol_update M={Me}, K={Ke} (plan {json.dumps(plan)}) vs "
                f"{'plain sweep' if vs_plain else 'chol(LL^T + W^TW)'}", [got], [want], **tol_chol)
        check(bool(torch.equal(got, one)),
              f"chol_update M={Me}, K={Ke}: not bitwise equal to the one-block kernel")
        check(bool((torch.triu(got, 1) == 0).all()), f"chol_update M={Me}: upper triangle written")
        del Re, Le, We, got, one, want
    print("[check] chol_update edge shapes bitwise equal to the one-block kernel -> ok")
    # the latency of one anti-diagonal step (a pivot, its exchange and the
    # rotations): one 32-row panel alone, K = 2,048 updates in chunks
    Ls = torch.linalg.cholesky(torch.eye(32, device=dev) * 4.0)
    Ws = (torch.randn(2048, 32, generator=gen) * 0.01).to(dev)
    ps = kchol.chol_update_plan(32, 2048)
    nchunks = -(-2048 // ps["w_chunk"])
    step_us = cuda_ms(lambda: ops.chol_update(Ls, Ws)) * 1e3 / (2048 + nchunks * 31)
    panels = -(-M // 32)
    print(f"[chol_update] one anti-diagonal step: {step_us:.4f} us (one panel, K=2048 in "
          f"{nchunks} chunks); pivot-chain bounds at M={M}, K={K}: (K + M - 1) steps "
          f"{(K + M - 1) * step_us / 1e3:.3f} ms; this design's {panels} panels x "
          f"(K + 31) steps {panels * (K + 31) * step_us / 1e3:.3f} ms")
    del Ls, Ws

    # one ragged shape: N not a tile multiple, M = 125 (p = 3, n = 5)
    gspec = spec_for("hermite", 3, 5)
    gtile, gsq, gsig2 = tile_of(gspec)
    Xg = torch.rand(1037, 3, generator=gen).mul(2).sub(1).to(dev)
    yg = torch.randn(1037, generator=gen).to(dev)
    mg = (torch.rand(1037, generator=gen) > 0.25).float().to(dev)
    compare("ragged phi_features (1037x125)", [ops.expansion_phi(Xg, gtile)],
            [kphi.phi_features_plain(Xg, gtile)], **tol_phi)
    og = torch.ones_like(yg)
    compare("ragged phi_gram scale=True (1037x125)",
            list(ops.fused_fit_moments(Xg, yg, gtile, gsq, gsig2)),
            list(kgram.phi_gram_plain(Xg, yg, og, gtile, gsq, gsig2, True)),
            scales=gram_scales(Xg, yg, og, gtile, gsq, gsig2, True), **tol_fit)
    compare("ragged phi_gram scale=False masked (1037x125)",
            list(ops.fused_fit_moments(Xg, yg, gtile, None, 1.0, mg, scale=False)),
            list(kgram.phi_gram_plain(Xg, yg, mg, gtile, torch.ones_like(gsq), 1.0, False)),
            scales=gram_scales(Xg, yg, mg, gtile, None, 1.0, False), **tol_fit)
    Ag = torch.randn(77, 125, generator=gen).to(dev)
    Rg = torch.randn(125, 125, generator=gen).to(dev)
    Cg = Rg @ Rg.T / 125 + torch.eye(125, device=dev)
    compare("ragged diag_quad (77x125)", [ops.diag_quad(Ag, Cg)],
            [kdq.diag_quad_plain(Ag, Cg)], rtol=2e-3, atol=1e-5,
            why="tests/test_kernels.py:168 variance gate")
    Lg = torch.linalg.cholesky(Cg)
    Wg = torch.randn(8, 125, generator=gen).to(dev)
    compare("ragged chol_update (M=125, K=8)", [ops.chol_update(Lg, Wg)],
            [kchol.chol_update_plain(Lg, Wg)], **tol_chol)

    for name, r in rows.items():
        call = f" call_ms={r['call_ms']:.4f}" if "call_ms" in r else ""
        print(f"[kernel] {name}: ms={r['ms']:.4f}{call} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} "
              f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}) max_abs_err={r['max_abs_err']:.3e}")

    # -- 3. the main path at paper scale ------------------------------------
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = serve_gp(backend="pallas", device="cuda", **MAIN)
    gp = out.pop("gp")
    nl = float(gp.nlml(X_all, y_all))
    counts = ops.launch_counts()
    print(f"[main] M={out['M']} fit_s={out['fit_s']:.4f}")
    for h in out["rounds"]:
        print(f"[main] round {h['round']}: update_s={h['update_s']:.4f} "
              f"predict_p50_s={h['predict_p50_s']:.5f} "
              f"queries_per_s={h['queries_per_s']:.1f} rmse={h['rmse']:.5f}")
    print(f"[main] nlml={nl:.3f} launches={json.dumps(counts)}")
    check(out["M"] == M, f"main path ran at M={out['M']}, expected {M}")
    check(all(h["rmse"] < 0.1 for h in out["rounds"]), "rmse >= 0.1 on the cos target")
    check(all(h["var_finite"] for h in out["rounds"]), "non-finite variances")
    check(np.isfinite(nl), "nlml is not finite")
    check(counts == EXPECTED, f"launch counts {counts} != expected {EXPECTED}")
    del gp
    torch.cuda.empty_cache()

    # the same small session on the card and on the CPU
    ops.reset_launch_counts()
    on_card = serve_gp(backend="pallas", device="cuda", **SMALL)
    Xc = make_gp_dataset(300, 2, seed=9, device="cpu")[0]
    mu_g, var_g = on_card["gp"].mean_var(Xc.to(dev))
    small_counts = ops.launch_counts()
    print(f"[small] launches={json.dumps(small_counts)}")
    check(small_counts == SMALL_EXPECTED,
          f"small session launch counts {small_counts} != expected {SMALL_EXPECTED}")
    on_cpu = serve_gp(backend="pallas", device="cpu", **SMALL)
    mu_c, var_c = on_cpu["gp"].mean_var(Xc)
    compare("small session mean, card vs CPU", [mu_g.cpu()], [mu_c], rtol=1e-3, atol=1e-4,
            why="tests/test_kernels.py:168 mean gate")
    compare("small session variance, card vs CPU", [var_g.cpu()], [var_c], rtol=2e-3,
            atol=1e-5, why="tests/test_kernels.py:168 variance gate")
    del on_card, on_cpu

    # -- 4. kernel path against plain path at full width: Hermite and RFF --
    Xq_all = Xs[:MAIN["queries"]]
    ysq = ys[:Xq_all.shape[0]].cpu().numpy()

    def serve_once(sp):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = GP.fit(X0, y0, sp)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        mu, var, times = microbatched_mean_var(g, Xq_all, microbatch=MAIN["microbatch"])
        times.sort()
        print(f"[{sp.expansion} {sp.backend}] M={g.n_features} fit_s={fit_s:.4f} "
              f"predict_p50_s={times[len(times) // 2]:.5f} "
              f"queries_per_s={Xq_all.shape[0] / sum(times):.1f} "
              f"rmse={float(np.sqrt(np.mean((mu - ysq) ** 2))):.5f}")
        check(np.all(np.isfinite(mu)) and np.all(np.isfinite(var)),
              f"{sp.expansion} {sp.backend} path not finite")
        check(np.sqrt(np.mean((mu - ysq) ** 2)) < 0.1,
              f"{sp.expansion} {sp.backend} rmse >= 0.1 on the cos target")
        return g, torch.from_numpy(mu), torch.from_numpy(var)

    # gates: tests/test_streaming_fit.py:214 (u); tests/test_kernels.py:168
    # (Hermite mean and variance); tests/test_expansions.py:181-183 (RFF
    # mean and variance; RFF u is not held: at cond(B) ~1e6 the f32 plain
    # path's u alone sits far outside the u gate from the float64 solution)
    for sp, mean_why, var_gate in (
        (spec, "tests/test_kernels.py:168 mean gate",
         dict(rtol=2e-3, atol=1e-5, why="tests/test_kernels.py:168 variance gate")),
        (rspec, "tests/test_expansions.py:181 RFF mean gate",
         dict(rtol=5e-3, atol=1e-6, why="tests/test_expansions.py:183 RFF variance gate")),
    ):
        ops.reset_launch_counts()
        gk, mu_k, var_k = serve_once(sp)
        path_counts = ops.launch_counts()
        gj, mu_j, var_j = serve_once(sp.replace(backend="jnp"))
        print(f"[{sp.expansion}] kernel path launches={json.dumps(path_counts)}")
        check(path_counts == PATH_EXPECTED,
              f"{sp.expansion} kernel path launch counts {path_counts} != {PATH_EXPECTED}")
        check(ops.launch_counts() == path_counts,
              f"the {sp.expansion} plain path launched a kernel")
        if sp.expansion == "hermite":
            compare("hermite u, kernel path vs plain path", [gk.state.u], [gj.state.u],
                    rtol=5e-3, atol=1e-4, why="tests/test_streaming_fit.py:214 u gate")
        compare(f"{sp.expansion} mean, kernel path vs plain path", [mu_k], [mu_j],
                rtol=1e-3, atol=1e-4, why=mean_why)
        compare(f"{sp.expansion} variance, kernel path vs plain path", [var_k], [var_j],
                **var_gate)
        del gk, gj
        torch.cuda.empty_cache()

    # -- 5. the fleet: serve_fleet(engine="sync") at full width -------------
    fleet_t0 = time.perf_counter()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    fout = serve_fleet(engine="sync", backend="pallas", device="cuda", **FLEET)
    fcounts = ops.launch_counts()
    fbank = fout.pop("bank")
    F = FLEET
    B, N, p, FM = F["tenants"], F["n_train"], F["p"], fout["M"]
    print(f"[fleet] tenants={B} N={N} M={FM} fit_s={fout['fit_s']:.4f}")
    for h in fout["rounds"]:
        print(f"[fleet] round {h['round']}: rows_absorbed={h['rows_absorbed']} "
              f"ingest_rounds={h['ingest_rounds']} ingest_s={h['ingest_s']:.4f} "
              f"query_s={h['query_s']:.4f} query_mean_s={h['query_mean_s']:.5f} "
              f"queries_per_s={h['queries_per_s']:.1f} rmse={h['rmse']:.5f}")
    ingest_rounds = sum(h["ingest_rounds"] for h in fout["rounds"])
    blocks = -(-F["queries_per_round"] // F["microbatch"])
    # 1 bank fit; per ingest round a feature launch and a batched sweep
    # (K * 8 = 128 <= M = 625); per query microbatch a feature launch (the
    # bank's variance is the gathered product, no diag-quad)
    fleet_expected = {
        "phi_features": {"": F["rounds"] * blocks + ingest_rounds},
        "phi_gram": {"bank": 1},
        "diag_quad": {},
        "chol_update": {"batched": ingest_rounds},
        "scaled_gram": {},
    }
    print(f"[fleet] launches={json.dumps(fcounts)}")
    check(FM == 625, f"the fleet ran at M={FM}, expected 625")
    check(fcounts == fleet_expected,
          f"fleet launch counts {fcounts} != expected {fleet_expected}")
    check(all(h["rmse"] < 0.1 for h in fout["rounds"]),
          "fleet rmse >= 0.1 against the tenants' targets")
    check(all(h["var_finite"] for h in fout["rounds"]), "non-finite fleet variances")

    def bank_scales(Xb, yb, maskb, tile):
        """Cauchy-Schwarz magnitudes of every slot's sums (gram_scales, slot
        by slot)."""
        sG = torch.empty((Xb.shape[0], tile.M, tile.M), device=Xb.device)
        sb = torch.empty((Xb.shape[0], tile.M), device=Xb.device)
        for s in range(Xb.shape[0]):
            sG[s], sb[s] = gram_scales(Xb[s], yb[s], maskb[s], tile, None, 1.0, False)
        return [sG, sb]

    # the bank kernel (TPU #4) against its plain version on the fleet's data
    _, Xb_np, yb_np, pools = fleet_dataset(
        np.random.default_rng(F["seed"]), tenants=B, n_train=N, p=p,
        rounds=F["rounds"], observations_per_round=F["observations_per_round"],
        noise=F["noise"], seed=F["seed"])
    Xd, yd = torch.from_numpy(Xb_np).to(dev), torch.from_numpy(yb_np).to(dev)
    fspec = fbank.spec
    ftile, fsq, fsig2 = tile_of(fspec)
    fones = torch.ones((B, N), device=dev)
    G, bG = ops.bank_fused_fit_moments(Xd, yd, ftile, fones)
    check(bool(torch.equal(G, G.mT)), "the bank kernel's G is not exactly symmetric")
    err = compare(f"bank phi_gram ({B} x {N} x {FM})", [G, bG],
                  plain(lambda: kgram.bank_phi_gram_plain(Xd, yd, fones, ftile)),
                  scales=bank_scales(Xd, yd, fones, ftile), **tol_fit)
    del G, bG
    # ragged fleet: per-tenant real N drawn from N/2..N (5,000..10,000) by masks
    true_n = np.random.default_rng(5).integers(N // 2, N + 1, size=B)
    rmask = (torch.arange(N)[None, :] < torch.from_numpy(true_n)[:, None]).float().to(dev)
    err = max(err, compare(f"bank phi_gram ragged N 5,000-10,000 ({B} x {N} x {FM})",
                           list(ops.bank_fused_fit_moments(Xd, yd, ftile, rmask)),
                           plain(lambda: kgram.bank_phi_gram_plain(Xd, yd, rmask, ftile)),
                           scales=bank_scales(Xd, yd, rmask, ftile), **tol_fit))
    rbank = GPBank.fit(Xd, yd, fspec, mask=rmask)
    Xq16 = torch.rand(256, p, generator=gen).mul(2).sub(1).to(dev)
    for t in range(4):
        cut = int(true_n[t])
        m1, v1 = GP.fit(Xd[t, :cut], yd[t, :cut], fspec).mean_var(Xq16)
        m2, v2 = rbank.mean_var([t] * Xq16.shape[0], Xq16)
        compare(f"ragged bank fit vs single fit on its {cut} rows (tenant {t}) mean",
                [m2], [m1], rtol=5e-3, atol=2e-4, why="tests/test_gp_bank.py:230 gate")
        compare(f"ragged bank fit vs single fit on its {cut} rows (tenant {t}) variance",
                [v2], [v1], rtol=5e-3, atol=2e-4, why="tests/test_gp_bank.py:233 gate")
    del rbank, rmask
    bf_flops = B * N * FM * (FM + 1) + 2 * B * N * FM
    bf_bytes = 4 * (Xd.numel() + 2 * B * N + B * FM * FM + B * FM + FM * p + p * 3)
    bank_ms = cuda_ms(lambda: ops.bank_fused_fit_moments(Xd, yd, ftile, fones), reps=5, warmup=1)
    bank_plain_ms = cuda_ms(lambda: kgram.bank_phi_gram_plain(Xd, yd, fones, ftile),
                            reps=2, warmup=1)
    Phi_all = torch.empty((B, N, FM), device=dev)   # 12.8 GB, for the library call
    for s in range(B):
        Phi_all[s] = kphi.phi_features_plain(Xd[s], ftile)
    bank_lib_ms = cuda_ms(lambda: torch.bmm(Phi_all.mT, Phi_all), reps=5, warmup=1)
    del Phi_all
    torch.cuda.empty_cache()
    rows["phi_gram.bank"] = dict(
        source="src/repro_torch/kernels/csrc/phi_gram.cu",
        replaces="src/repro/kernels/phi_gram.py:212", max_abs_err=err,
        launches=fcounts["phi_gram"]["bank"], ms=bank_ms, plain_ms=bank_plain_ms,
        library_ms=bank_lib_ms, bound=bound(bf_flops, bf_bytes))

    # the features kernel (TPU #2) at the fleet's shapes: a query
    # microbatch (256 rows of mixed tenants) and an ingest round's rows
    # (every slot's 16-row group, 8,192 rows)
    K = F["ingest_chunk"]
    Xk = torch.from_numpy(np.stack([pool[0][N:N + K] for pool in pools])).to(dev)
    yk = torch.from_numpy(np.stack([pool[1][N:N + K] for pool in pools])).to(dev)
    tol_fphi = dict(tol_phi, rtol=4e-5 * max(4, F["n"]))
    for r in (Xq16, Xk.reshape(-1, p)):
        compare(f"fleet phi_features ({r.shape[0]}x{FM})", [ops.expansion_phi(r, ftile)],
                [plain(lambda: kphi.phi_features_plain(r, ftile))], **tol_fphi)
        features_line(r, ftile, F["n"])

    # the batched sweep: every slot's factor, 16 fresh rows per tenant
    Lg = fbank.stack.chol.clone()
    Wg = (ops.expansion_phi(Xk.reshape(-1, p), ftile).reshape(B, K, FM)
          * fbank.stack.sqrtlam[:, None, :] / fspec.noise).contiguous()
    Lg0, Wg0 = Lg.clone(), Wg.clone()
    Lk = ops.chol_update(Lg, Wg)
    check(torch.equal(Lg, Lg0) and torch.equal(Wg, Wg0), "the batched sweep wrote its inputs")
    del Lg0, Wg0
    # system by system, the bits of the cooperative kernel
    diff = max(float((Lk[s] - ops.chol_update(Lg[s], Wg[s])).abs().max()) for s in range(B))
    print(f"[check] batched chol_update vs the cooperative kernel, system by system "
          f"(G={B}, M={FM}, K={K}): max_abs_diff={diff:.3e} -> {'ok' if diff == 0 else 'FAIL'}")
    check(diff == 0.0 and bool(torch.all(torch.triu(Lk, 1) == 0)),
          "the batched sweep is not bitwise the cooperative kernel system by system")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Lp = plain(lambda: kchol.chol_update_plain(Lg, Wg))
    torch.cuda.synchronize()
    sweep_plain_ms = (time.perf_counter() - t0) * 1e3
    err = compare(f"batched chol_update vs plain sweep (G={B}, M={FM}, K={K})",
                  [Lk], [Lp], **tol_chol)
    compare(f"batched chol_update vs chol(LL^T + W^TW) (G={B}, M={FM}, K={K})",
            [Lk], [torch.linalg.cholesky(Lg @ Lg.mT + Wg.mT @ Wg)], **tol_chol)
    del Lk, Lp
    bs_flops = B * 6 * K * FM * (FM - 1) / 2
    bs_bytes = B * 4 * (2 * FM * (FM + 1) / 2 + K * FM)
    rows["chol_update.batched"] = dict(
        source="src/repro_torch/kernels/csrc/chol_update.cu",
        replaces="src/repro/bank/bank.py:115", max_abs_err=err,
        launches=fcounts["chol_update"]["batched"],
        ms=cuda_ms(lambda: ops.chol_update(Lg, Wg), reps=20, warmup=2),
        plain_ms=sweep_plain_ms,
        library_ms=cuda_ms(lambda: torch.linalg.cholesky(Lg @ Lg.mT + Wg.mT @ Wg),
                           reps=20, warmup=2),
        bound=bound(bs_flops, bs_bytes))
    del Lg, Wg

    # GPBank.update launches the batched sweep once and leaves the old bank
    # unchanged
    before = {f: getattr(fbank.stack, f).clone() for f in ("chol", "u", "b")}
    ops.reset_launch_counts()
    ubank = fbank.update(list(range(16)), Xk[:16], yk[:16])
    ucounts = ops.launch_counts()
    check(ucounts["chol_update"] == {"batched": 1} and ucounts["phi_features"] == {"": 1},
          f"GPBank.update launches {ucounts} != one batched sweep and one feature launch")
    check(all(torch.equal(getattr(fbank.stack, f), v) for f, v in before.items()),
          "GPBank.update wrote into the old bank's tensors")
    check(not torch.equal(ubank.stack.chol[0], fbank.stack.chol[0])
          and torch.equal(ubank.stack.chol[16], fbank.stack.chol[16]),
          "GPBank.update did not write exactly its slots")
    # one tenant: a batch of one system, swept by the cooperative kernel
    ops.reset_launch_counts()
    one_bank = fbank.update([0], Xk[:1], yk[:1])
    ocounts = ops.launch_counts()
    check(ocounts["chol_update"] == {"": 1},
          f"GPBank.update of one tenant launches {ocounts['chol_update']} != one cooperative sweep")
    check(torch.equal(one_bank.stack.chol[1], fbank.stack.chol[1]),
          "GPBank.update of one tenant wrote another slot")
    compare("GPBank.update of one tenant vs its slot in the 16-tenant update",
            [one_bank.stack.chol[0]], [ubank.stack.chol[0]], **tol_chol)
    del ubank, one_bank

    # bank serving against per-tenant single-session serving of the same
    # states, 16 tenants (tests/test_gp_bank.py:90 gate, 1e-5 abs)
    q_ten = [int(t) for t in np.random.default_rng(6).integers(0, 16, 256)]
    mu_b, var_b = fbank.mean_var(q_ten, Xq16)
    for t in sorted(set(q_ten)):
        sel = torch.tensor([i for i, x in enumerate(q_ten) if x == t], device=dev)
        m1, v1 = GP.from_state(fbank.state(t)).mean_var(Xq16[sel])
        compare(f"bank vs single-session serving, tenant {t} mean", [mu_b[sel]], [m1],
                rtol=0.0, atol=1e-5, why="tests/test_gp_bank.py:90 gate")
        compare(f"bank vs single-session serving, tenant {t} variance", [var_b[sel]], [v1],
                rtol=0.0, atol=1e-5, why="tests/test_gp_bank.py:91 gate")

    # one mixed-tenant microbatch of the whole fleet: the kernel path
    # against the plain path (backend "jnp") on the same states, which
    # differ only in the feature map (the fleet's serving gate, 1e-5 abs)
    q_all = [int(t) for t in np.random.default_rng(8).integers(0, B, F["microbatch"])]
    mu_k, var_k = fbank.mean_var(q_all, Xq16)
    jbank = dataclasses.replace(fbank, stack=fbank.stack.with_spec(backend="jnp"))
    mu_j, var_j = plain(lambda: jbank.mean_var(q_all, Xq16))
    compare("fleet microbatch mean, kernel path vs plain path", [mu_k], [mu_j],
            rtol=0.0, atol=1e-5, why="tests/test_gp_bank.py:90 gate")
    compare("fleet microbatch variance, kernel path vs plain path", [var_k], [var_j],
            rtol=0.0, atol=1e-5, why="tests/test_gp_bank.py:91 gate")
    del jbank

    # layer times of the fleet path (CUDA events, for PERF.md's breakdown):
    # the fit's batched Cholesky, the whole bank's B^-1 cache, and one
    # 256-query mean_var microbatch against a warm cache
    Bs = fbank.stack.chol @ fbank.stack.chol.mT
    layer_ms = {
        "batched_cholesky_ms": cuda_ms(lambda: torch.linalg.cholesky(Bs), reps=5, warmup=1),
        "bank_binv_ms": cuda_ms(lambda: fagp._bank_binv(fbank.stack.chol), reps=5, warmup=1),
        "mean_var_256_ms": cuda_ms(lambda: fbank.mean_var(q_ten, Xq16), reps=20, warmup=2),
    }
    del Bs
    print(f"[fleet layers] {json.dumps(layer_ms)}")

    # insert / evict round trip: slot reuse, the new tenant serves like its
    # own session, eviction restores the prior, the old bank is untouched
    Xn, yn, _, _ = make_gp_dataset(N, p, noise=F["noise"], seed=10_000, device=dev)
    b1 = fbank.evict(0)
    b2 = b1.insert("new", (Xn, yn))
    check(b2.slot_of("new") == 0 and len(b2) == B, "insert did not reuse the free slot")
    m1, v1 = GP.fit(Xn, yn, fspec).mean_var(Xq16)
    m2, v2 = b2.mean_var(["new"] * Xq16.shape[0], Xq16)
    compare("inserted tenant vs its own session, mean", [m2], [m1], rtol=0.0, atol=1e-5,
            why="tests/test_gp_bank.py:90 gate")
    compare("inserted tenant vs its own session, variance", [v2], [v1], rtol=0.0,
            atol=1e-5, why="tests/test_gp_bank.py:91 gate")
    b3 = b2.evict("new")
    check(torch.equal(b3.stack.chol[0], torch.eye(FM, device=dev))
          and not torch.any(b3.stack.u[0]) and "new" not in b3,
          "evict did not restore the prior state")
    check(all(torch.equal(getattr(fbank.stack, f), v) for f, v in before.items()),
          "insert/evict wrote into the old bank's tensors")
    del b1, b2, b3, before, fbank, Xd, yd
    torch.cuda.empty_cache()

    # a small RFF fleet: the RFF tile of the bank kernel on its own path
    R = RFF_FLEET
    roff, rXb, ryb, rpools = fleet_dataset(
        np.random.default_rng(R["seed"]), tenants=R["tenants"], n_train=R["n_train"],
        p=p, rounds=1, observations_per_round=R["observations"], noise=F["noise"],
        seed=R["seed"])
    rfspec = spec_for("rff_se", p, R=R["num_features"])
    rftile, _, _ = tile_of(rfspec)
    rXd, ryd = torch.from_numpy(rXb).to(dev), torch.from_numpy(ryb).to(dev)
    rones = torch.ones(rXd.shape[:2], device=dev)
    compare(f"bank phi_gram rff ({R['tenants']} x {R['n_train']} x {rftile.M})",
            list(ops.bank_fused_fit_moments(rXd, ryd, rftile, rones)),
            plain(lambda: kgram.bank_phi_gram_plain(rXd, ryd, rones, rftile)),
            scales=bank_scales(rXd, ryd, rones, rftile), **tol_fit)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    router = BankRouter(GPBank.fit(rXd, ryd, rfspec), microbatch=R["microbatch"],
                        ingest_chunk=F["ingest_chunk"])
    orng = np.random.default_rng(7)
    for i in range(R["observations"]):
        t = int(orng.integers(0, R["tenants"]))
        router.observe(t, rpools[t][0][R["n_train"] + i], rpools[t][1][R["n_train"] + i])
    router.ingest()
    rq_ten = orng.integers(0, R["tenants"], R["queries"])
    rXq = orng.uniform(-1.0, 1.0, size=(R["queries"], p)).astype(np.float32)
    tickets = [router.submit(int(t), rXq[i]) for i, t in enumerate(rq_ten)]
    res = router.flush()
    rcounts = ops.launch_counts()
    r_mu = np.array([res[tk][0] for tk in tickets])
    r_var = np.array([res[tk][1] for tk in tickets])
    r_rmse = float(np.sqrt(np.mean((r_mu - np.sum(np.cos(rXq), axis=1) - roff[rq_ten]) ** 2)))
    rff_expected = {
        "phi_features": {"": R["queries"] // R["microbatch"] + router.ingest_rounds},
        "phi_gram": {"bank": 1},
        "diag_quad": {},
        "chol_update": {"batched": router.ingest_rounds},
        "scaled_gram": {},
    }
    print(f"[rff fleet] M={router.bank.n_features} rmse={r_rmse:.5f} "
          f"ingest_rounds={router.ingest_rounds} launches={json.dumps(rcounts)}")
    check(rcounts == rff_expected, f"rff fleet launch counts {rcounts} != {rff_expected}")
    check(np.all(np.isfinite(r_var)) and r_rmse < 0.1, "rff fleet: non-finite or rmse >= 0.1")
    del router, rXd, ryd
    torch.cuda.empty_cache()
    for name in ("phi_gram.bank", "chol_update.batched"):
        r = rows[name]
        print(f"[kernel] {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} bound_ms={r['bound'][0]:.4f} "
              f"({r['bound'][1]}) max_abs_err={r['max_abs_err']:.3e}")
    # the batched sweep's pivot chain at one anti-diagonal step's latency
    # (phase 2): K + M - 1 steps at best, this design's panels x (K + 31)
    fpanels = -(-FM // 32)
    print(f"[kernel] chol_update.batched chain bound (G={B}, M={FM}, K={K}, one step "
          f"{step_us:.4f} us): (K + M - 1) steps {(K + FM - 1) * step_us / 1e3:.4f} ms; "
          f"{fpanels} panels x (K + 31) steps {fpanels * (K + 31) * step_us / 1e3:.4f} ms; "
          f"bytes {rows['chol_update.batched']['bound'][0]:.4f} ms")
    print(f"[fleet] phase took {time.perf_counter() - fleet_t0:.1f} s")

    # -- 6. the paper's materialized pipeline at full width -------------------
    paper_t0 = time.perf_counter()
    N, p, n = MAIN["n_train"], MAIN["p"], MAIN["n"]
    sig2 = float(spec.noise**2)

    def gram_cs(Phi, d, s2):
        """Cauchy-Schwarz magnitudes |phi_i| |phi_j| d_i d_j / sig2 of the
        scaled Gram's sums (gram_scales, from a materialized Phi)."""
        cn = Phi.float().norm(dim=0) * d
        return [cn[:, None] * cn[None, :] / s2]

    # the path: GP.fit with store_train, then the scaled Gram of its Phi
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    pgp = GP.fit(X0, y0, spec.replace(store_train=True))
    fit_counts = ops.launch_counts()
    st = pgp.state
    Phi, sq = st.Phi, st.sqrtlam
    B_mat = ops.scaled_gram(Phi, sq, sig2)
    pcounts = ops.launch_counts()
    print(f"[paper] store_train fit launches={json.dumps(fit_counts)}; "
          f"with scaled_gram {json.dumps(pcounts)}")
    check(fit_counts == PAPER_FIT_EXPECTED,
          f"store_train fit launch counts {fit_counts} != {PAPER_FIT_EXPECTED}")
    check(pcounts == dict(PAPER_FIT_EXPECTED, scaled_gram={"": 1}),
          f"scaled_gram on the stored Phi: launch counts {pcounts}")
    check(tuple(Phi.shape) == (N, M) and Phi.dtype == torch.float32 and Phi.is_cuda,
          f"stored Phi is {tuple(Phi.shape)} {Phi.dtype} on {Phi.device}")
    check(torch.equal(st.y, y0), "the stored y is not the fitted y")
    # the path's own launch at this shape (the 8-column instance) against
    # the plain version
    rows["phi_features"]["max_abs_err"] = max(
        rows["phi_features"]["max_abs_err"],
        compare(f"phi_features ({N}x{M}, the stored Phi)", [Phi],
                [plain(lambda: kphi.phi_features_plain(X0, tile))], **tol_phi))
    ref_state = GP.fit(X0, y0, spec).state
    check(torch.equal(st.u, ref_state.u) and torch.equal(st.chol, ref_state.chol),
          "store_train changed the fit (u or chol not bitwise equal)")
    del ref_state

    # the features kernel at the stored Phi's shape (its one launch here),
    # its time also read from torch.profiler (once a run: a second profiler
    # session in one process may record no device time)
    features_line(X0, tile, n, profile=True)
    torch.cuda.empty_cache()
    # the scaled-Gram kernel (TPU #5) against its plain version and against
    # the fused-fit kernel's B of the same X: two independent kernels
    sB = gram_cs(Phi, sq, sig2)
    err = compare(f"scaled_gram vs plain ({N}x{M})", [B_mat],
                  [plain(lambda: ksg.scaled_gram_plain(Phi, sq, sig2))], scales=sB, **tol_fit)
    check(bool(torch.equal(B_mat, B_mat.T)), "scaled_gram's B is not exactly symmetric")
    B_f, _ = ops.fused_fit_moments(X0, y0, tile, sq, sig2)
    err = max(err, compare(f"scaled_gram vs the fused-fit kernel's B ({N}x{M})", [B_mat],
                           [B_f], scales=sB, **tol_fit))
    # both kernels sum the same float32 products in the same row order
    check(bool(torch.equal(B_mat, B_f)),
          "scaled_gram's B is not bitwise equal to the fused-fit kernel's B")
    print("[check] scaled_gram's B is bitwise equal to the fused-fit kernel's B -> ok")
    del B_f
    u_mat = fagp._solve_mean_weights(torch.linalg.cholesky(B_mat), sq, Phi.T @ st.y, sig2)
    compare("u from cholesky(B_mat) vs the state's u", [u_mat], [st.u], rtol=5e-3,
            atol=1e-4, why="tests/test_streaming_fit.py:214 u gate")
    del B_mat, u_mat
    torch.cuda.empty_cache()
    sg_flops = N * M * (M + 1) + 3 * M * M
    sg_bytes = 4 * (N * M + M + M * M)
    rows["scaled_gram"] = dict(
        source="src/repro_torch/kernels/csrc/scaled_gram.cu",
        replaces="src/repro/kernels/gram.py:64", max_abs_err=err,
        launches=pcounts["scaled_gram"][""],
        ms=cuda_ms(lambda: ops.scaled_gram(Phi, sq, sig2)),
        plain_ms=cuda_ms(lambda: ksg.scaled_gram_plain(Phi, sq, sig2)),
        library_ms=cuda_ms(lambda: torch.matmul(Phi.T, Phi)),
        bound=bound(sg_flops, sg_bytes))

    # the JAX benchmark's comparison (benchmarks/streaming_fit.py:40-51):
    # the two-pass materialized fit against the one-pass fused fit
    def materialized():
        Ph = ops.expansion_phi(X0, tile)
        return ops.scaled_gram(Ph, sq, sig2), Ph.T @ y0

    fits = {}
    for label, fn in (("materialized_2pass", materialized),
                      ("fused_1pass", lambda: ops.fused_fit_moments(X0, y0, tile, sq, sig2))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        torch.cuda.synchronize()
        fits[label] = {"peak_bytes": torch.cuda.max_memory_allocated() - base}
        del res
        fits[label]["ms"] = cuda_ms(fn, reps=5, warmup=1)
    print(f"[paper] fit statistics (N={N}, M={M}): {json.dumps(fits)}")

    # other shapes: ragged (N = 300, M = 257), the fleet's M = 625 at
    # N = 10^4, and a bfloat16 Phi at full width
    Pr = torch.randn(300, 257, generator=gen).to(dev)
    dr = torch.linspace(1.0, 1e-3, 257).to(dev)
    compare("ragged scaled_gram (300x257)", [ops.scaled_gram(Pr, dr, 0.01)],
            [plain(lambda: ksg.scaled_gram_plain(Pr, dr, 0.01))],
            scales=gram_cs(Pr, dr, 0.01), **tol_fit)
    f625, fsq625, fsig625 = tile_of(spec_for("hermite", p, 5))
    P625 = plain(lambda: kphi.phi_features_plain(X0, f625))
    compare(f"scaled_gram at the fleet's M ({N}x{f625.M})",
            [ops.scaled_gram(P625, fsq625, fsig625)],
            [plain(lambda: ksg.scaled_gram_plain(P625, fsq625, fsig625))],
            scales=gram_cs(P625, fsq625, fsig625), **tol_fit)
    del P625
    # bfloat16: kernel and plain version widen the same values, so the
    # float32 gate holds (far inside tests/test_kernels.py:104's 5e-2)
    Pbf = Phi.to(torch.bfloat16)
    Bbf = ops.scaled_gram(Pbf, sq, sig2)
    check(Bbf.dtype == torch.float32, "scaled_gram of a bfloat16 Phi is not float32")
    compare(f"scaled_gram bfloat16 Phi ({N}x{M})", [Bbf],
            [plain(lambda: ksg.scaled_gram_plain(Pbf, sq, sig2))],
            scales=gram_cs(Pbf, sq, sig2), **tol_fit)
    print(f"[paper] scaled_gram bfloat16 Phi: ms="
          f"{cuda_ms(lambda: ops.scaled_gram(Pbf, sq, sig2), reps=5, warmup=1):.4f}")
    del Pbf, Bbf
    torch.cuda.empty_cache()

    # predict(mode="paper"): the literal Eqs. 11-12 chain on 1,024 queries
    # (its float32 N x N inverse cancels at this N, ROADMAP.md section C:
    # timed and held finite, its gap to the fused mode printed, no gate)
    Xq_all = Xs[:MAIN["queries"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mu_p, cov_p = pgp.predict(Xq_all, mode="paper")
    torch.cuda.synchronize()
    paper_pred_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mu_f, cov_f = pgp.predict(Xq_all)
    torch.cuda.synchronize()
    fused_pred_s = time.perf_counter() - t0
    Q = Xq_all.shape[0]
    check(tuple(mu_p.shape) == (Q,) and tuple(cov_p.shape) == (Q, Q),
          f"paper mode shapes {tuple(mu_p.shape)} {tuple(cov_p.shape)}")
    check(bool(torch.isfinite(mu_p).all() and torch.isfinite(cov_p).all()),
          "paper mode is not finite at full width")
    print(f"[paper] predict(mode='paper') {Q} queries: {paper_pred_s:.4f} s "
          f"(fused {fused_pred_s:.4f} s); gap to fused: mean "
          f"{float((mu_p - mu_f).abs().max()):.3e}, covariance "
          f"{float((cov_p - cov_f).abs().max()):.3e} (largest covariance entry "
          f"{float(cov_f.abs().max()):.3e}); rmse paper "
          f"{float(((mu_p - ys[:Q]) ** 2).mean().sqrt()):.5f}, fused "
          f"{float(((mu_f - ys[:Q]) ** 2).mean().sqrt()):.5f}")
    # a second witness at full width: the same chain (fagp._paper_chain) in
    # float64, from the stored Phi and y cast up with B rebuilt and factored
    # in float64, against the float64 fused mode of that factor
    f64 = torch.float64
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Phi64, y64, D64 = Phi.to(f64), st.y.to(f64), sq.to(f64)
    Phis64 = fagp.build_features(Xq_all, pgp.spec, st.idx).to(f64)
    chol64 = torch.linalg.cholesky(torch.eye(M, dtype=f64, device=dev)
                                   + D64[:, None] * (Phi64.T @ Phi64) * D64[None, :] / sig2)
    mu_p64, cov_p64 = fagp._paper_chain(Phi64, y64, Phis64, D64 * D64, D64, chol64, sig2)
    u64 = fagp._solve_mean_weights(chol64, D64, Phi64.T @ y64, sig2)
    V64 = torch.linalg.solve_triangular(chol64, (Phis64 * D64[None, :]).T, upper=False)
    mu_f64, cov_f64 = Phis64 @ u64, V64.T @ V64
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t0
    del Phi64, chol64, V64
    compare("float64 paper chain vs float64 fused mode at full width (mean)", [mu_p64],
            [mu_f64], rtol=0.0, atol=5e-3, why="tests/test_fagp.py:57-59 gate")
    cov_atol = 5e-3 * float(cov_f64.abs().max())
    compare("float64 paper chain vs float64 fused mode at full width (covariance)",
            [cov_p64], [cov_f64], rtol=0.0, atol=cov_atol,
            why="5e-3 of the largest covariance entry")
    print(f"[paper] float64 witness ({f64_s:.3f} s): paper vs fused mean "
          f"{float((mu_p64 - mu_f64).abs().max()):.3e}, covariance "
          f"{float((cov_p64 - cov_f64).abs().max()):.3e}; float64 paper vs float32 "
          f"fused mean {float((mu_p64 - mu_f.to(f64)).abs().max()):.3e}, covariance "
          f"{float((cov_p64 - cov_f.to(f64)).abs().max()):.3e}; rmse float64 paper "
          f"{float(((mu_p64 - ys[:Q].to(f64)) ** 2).mean().sqrt()):.5f}")
    del mu_p, cov_p, mu_f, cov_f, mu_p64, cov_p64, mu_f64, cov_f64, y64, D64, Phis64, u64
    # on the JAX test's data (tests/test_fagp.py:12-16, 49-60: N = 50, p = 2,
    # n = 8, queries from seed 3) paper mode equals the fused mode
    def fagp_test_data(N, seed):
        rng = np.random.default_rng(seed)
        X = rng.uniform(-1, 1, size=(N, 2)).astype(np.float32)
        y = (np.sum(np.cos(X), axis=1) + 0.05 * rng.standard_normal(N)).astype(np.float32)
        return torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)

    X50, y50 = fagp_test_data(50, 0)
    X17, _ = fagp_test_data(17, 3)
    g50 = GP.fit(X50, y50, spec_for("hermite", 2, 8).replace(store_train=True))
    for got, want, what in zip(g50.predict(X17, mode="paper"), g50.predict(X17),
                               ("mean", "covariance")):
        compare(f"paper mode vs fused mode at N = 50 ({what})", [got], [want], rtol=0.0,
                atol=5e-3, why="tests/test_fagp.py:57-59 gate")

    # checkpoints: GP.save / GP.load of the full-width stored-features session
    with tempfile.TemporaryDirectory() as ckdir:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v0 = pgp.save(ckdir)
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(ckdir).rglob("*") if f.is_file())
        t0 = time.perf_counter()
        lgp = GP.load(ckdir)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        check(v0 == 0, f"the first save wrote version {v0}")
        for f in ("idx", "lam", "sqrtlam", "chol", "u", "b", "Phi", "y"):
            check(torch.equal(getattr(lgp.state, f), getattr(st, f)),
                  f"GP.load: leaf {f} is not bitwise equal")
        for f in ("eps", "rho", "noise"):
            check(torch.equal(getattr(lgp.spec, f), getattr(pgp.spec, f)),
                  f"GP.load: spec leaf {f} is not bitwise equal")
        check(lgp.spec.omega is None and lgp.spec.store_train
              and lgp.spec.backend == "pallas" and lgp.spec.n == n,
              f"GP.load rebuilt {lgp.spec.describe()}")
        check(lgp.state.chol.is_cuda and lgp.state.Phi.is_cuda and lgp.spec.device.type == "cuda",
              "GP.load did not place the session on the card")
        Xq128 = Xs[:128]
        for a, b_, what in zip(lgp.mean_var(Xq128), pgp.mean_var(Xq128), ("mean", "variance")):
            check(torch.equal(a, b_), f"the loaded session's {what} is not bitwise equal")
        v1 = pgp.save(ckdir)
        check(v1 == 1, f"the second save wrote version {v1}")
    print(f"[paper] checkpoint of the full-width session: {nbytes} bytes, "
          f"save {save_s:.3f} s, load {load_s:.3f} s; round trip bitwise")
    del pgp, lgp, st, Phi
    torch.cuda.empty_cache()
    r = rows["scaled_gram"]
    print(f"[kernel] scaled_gram: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
          f"library_ms={r['library_ms']:.4f} bound_ms={r['bound'][0]:.4f} "
          f"({r['bound'][1]}) max_abs_err={r['max_abs_err']:.3e}")
    print(f"[paper] phase took {time.perf_counter() - paper_t0:.1f} s")

    # -- results --------------------------------------------------------------
    kernels = []
    for name, r in rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": r["source"],
            "replaces": r["replaces"],
            "launches": r["launches"] if "launches" in r else sum(counts[name].values()),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
        if "call_ms" in r:
            kernels[-1]["call_ms"] = r["call_ms"]
    print("[features] " + json.dumps({
        label: {k: (v[0] if k == "bound" else v) for k, v in r.items()}
        for label, r in features.items()}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
