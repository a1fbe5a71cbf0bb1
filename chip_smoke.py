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
   runs); the single-system sweep (K = 64) is held against its plain
   version on W's first 8 rows (K = 8, the plain sweep timed once there:
   the kernels line's ``plain_ms``; at K = 64 it took 85-125 s) and at K =
   64 against chol(LL^T + W^TW);
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
   ``GP.load`` of the full-width session, bitwise;
7. ``GP.optimize`` (the differentiable NLML and the lane engine): at
   ``MAIN``'s full width (M = 14,641) 3 steps from the spec, its fused-fit
   launches exact (one a step, one for the final lane value, one for the
   fit at the winner), the NLML per row lower than at the init, the
   optimized GP's rmse on 1,024 queries; the value, the Cholesky, the
   backward pass, its streamed blocks and one step timed (CUDA events),
   the step's peak memory; the value and its gradient in (log eps,
   log rho, log noise) on the pallas backend against the jnp backend at
   the JAX package's gates; then ``optimize_fleet`` over 8 tenants x 4
   restarts at the fleet's per-tenant shape (M = 625), 5 steps, its
   launches exact, tenants 0 and 1 alone bitwise equal to their lanes, a
   step's and a lane's time;
8. re-optimizing fleets, the downdate and ``refit_window`` (ROADMAP A2,
   A3) at the fleet's width (512 tenants, N = 10^4, M = 625): (a)
   ``serve_fleet(engine="sync", reopt_every=2)``, 2 rounds, stale tenants
   (>= 12 new rows) re-optimized by ``GPBank.optimize`` (3 steps, 1
   restart: depth cut from 25 and 2), its launches exact (the lanes' fused
   fits, one bank fused fit with per-slot constants for the refit, one
   features launch with per-row constants per heterogeneous microbatch),
   rmse < 0.1, two re-optimized tenants served as their own sessions
   (1e-5), the per-slot bank launch and the per-row features launch against
   their plain versions and bitwise against the shared launches, both
   timed beside the shared ones; (b) ``GPBank.downdate`` of every tenant's
   first 16 rows (G = 512, K = 16): every ``ok``, the batched downdate
   kernel against its plain version and the batched refactor, its inputs
   untouched, timed (median of 20) beside its bound and pivot chain;
   ``refit_window`` on the retained rows (one bank launch) against the
   downdated bank on mixed-tenant queries, both against a float64 refit for
   8 tenants; a mixed call whose bogus groups report ``ok=False`` and keep
   their slots bitwise; (c) the JAX package's own downdate gate
   (benchmarks/tenant_churn.py's shape) on both backends;
9. pipelined fleet serving and the tiered bank (ROADMAP A4) at the fleet's
   width: (a) ``serve_fleet(engine="pipelined", max_in_flight=4,
   queue_budget=16384)`` on phase 5's fleet and traffic with a metrics
   registry, a tracer and a recompile watchdog (``"count"``, armed after
   every serving shape was warmed on a bank of the same shapes), its
   launches exact (one bank fit, a features launch per dispatched block and
   per ingest round, a batched sweep per ingest round), rmse < 0.1, no
   ticket dropped or timed out, no watchdog growth over rounds 1-3, the
   trace through ``tools/check_trace.py``; q/s, ``query_mean_s``, the
   engine's p50/p99 and bucket usage beside phase 5's sync run; then on the
   fitted bank 4 blocks through ``submit``/``pump`` under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host-device barrier on
   the dispatch path), their results against direct ``GPBank.mean_var``
   (1e-5), the peak bytes with 4 top-rung blocks in flight, a burst under a
   1 us SLO answered with the timeout sentinel, and an ingest with
   ``donate_updates=True`` against the plain one (1e-6; written in place,
   the donor raising on use; both timed); (b) the same data over a cold tier
   (``cold_dir``, capacity 448, window 10^4, 2 rounds, re-optimizing after
   round 1 as phase 8a does): 64 cold saves at fit, page-ins paired with
   evictions, ``aged_rows`` the rows beyond each stale tenant's window (a
   replay of the fleet's draws), the downdate's ok count and refit
   fallbacks, a paged-in tenant served as its own checkpoint's session
   (1e-5), rmse < 0.1; ``TieredBank.fit``, a page-in and ``age`` timed;
10. the Vecchia family (ROADMAP A6; ``phase10()``) at the JAX package's
   own benchmark width (clustered 2-D data, k = 32, the se kernel, eps =
   4.714, noise 0.02), with TF32 checked off: (a) N = 20,000 and 2,000
   queries: fit + ``mean_var`` (first call and warm), ``nlml``, an
   ``update`` of the last 256 rows then ``mean_var`` (bitwise the fit on
   all rows), no kernel launched, the k-NN and the k x k lanes of each
   timed apart (CUDA events), the peak bytes of ``mean_var`` and ``nlml``
   under bounds reckoned from the block sizes, the card against the port's
   CPU run on 256 queries (1e-4); (b) N = 256 at k = 255 against the
   exact GP for both kernels (1e-4); (c) N = 10^4: Vecchia's rmse against
   hermite n = 12 and both RFF families (R = 256) on the kernel path (their
   launches exact), ``global_over_vecchia_rmse`` >= 1, the seconds ratio
   printed; (d) the ordered NLML at N = 10^5 under the same bound;
11. the sharded paths (ROADMAP A5; ``phase11()``), every shard on this
   card unless more are visible: (a) ``serve_fleet(shards=1)`` on phase
   9a's fleet and traffic, its final answers against 9a's (1e-5); (b) the
   same fleet over ``make_bank_mesh(4, devices=[cuda:0] * 4)``:
   ``ShardedGPBank.fit`` (one bank launch a shard) against ``GPBank.fit``
   (1e-4) and a (bank 4, data 2) fit (one a cell) held at the same 1e-4 at
   the fleet's width (the fused fit's 1,024-row strips, ROADMAP.md section
   C, C9), each fit's distance from a float64 fit printed, both also held
   at 1e-4 on the JAX test's own fleet, ``from_bank`` serving
   (1e-5), a mixed-tenant update, engine drain and ingest parity, the
   fleet's rounds as ``serve_fleet`` drives them (launches exact, read off
   the trace's ``shard_dispatch`` / ``shard_ingest`` instants), 4 blocks
   under sync-debug "error", ``rebalance`` after emptying shard 0, a
   page-out and page-in onto the least-loaded shard; (c)
   ``fit_distributed`` / ``predict_distributed`` at MAIN's width over 4
   row shards (one fused fit, one features and one diag-quad launch a
   shard) at tests/test_distributed.py's gates, beside a float64 fit, and
   at that test's own shape; its peak beside the 4 partial G reckoned; (d)
   with two or more cards, (b) and (c) over distinct cards and
   tests/test_torch_multicard.py, else one line saying it was skipped;
12. the LM half's dense serving path (ROADMAP A8; ``phase12()``) at
   qwen2-1.5b's full width, random weights from a seed: (a) cut to 2
   layers, the card against the port's CPU run (prefill logits and 8
   decode steps fed the CPU's greedy tokens; gate twice the CPU's own
   bfloat16-vs-float32 distance); (b) the 28 layers through
   ``repro_torch.launch.serve.serve`` at batch 4, prompt 64, 32 tokens:
   prefill ms (first and warm), decode ms a token, tok/s and peak bytes
   beside the bounds (parameter bytes at 3.35 TB/s, prefill FLOPs at 989
   TFLOP/s bf16), prefill(S) + decode(S) = prefill(S + 1) at
   tests/test_arch_smoke.py's 0.15, finite logits; (c) a 4,096-token
   prompt through the flash route in every layer (counted), layer 0's
   flash attention against the simple route in float32 (2e-4 / 2e-5).
   No kernel of this repository runs there: the LM half reaches no
   ``pallas_call``;
13. the LM half's training path (ROADMAP A8; ``phase13()``) at qwen2-1.5b's
   full width: (a) cut to 2 layers, 3 train steps at batch 1 x 128 on the
   card and on the CPU from the same weights, each step's loss and grad
   norm printed, every parameter after step 3 gated at twice the CPU's
   own bfloat16-vs-float32 distance; (b) the 28 layers through
   ``launch.train.build(smoke=False)`` and ``runtime.train_loop``, 20
   steps at batch 4 x 1,024 (first step, warm median, tokens/s, peak bytes
   above what earlier phases hold, beside the step's bound: its bfloat16
   products at 989 TFLOP/s and its float32 attention products at 67
   TFLOP/s), every loss and grad norm finite, the parameters moved; (c)
   checkpoint and restart on (a)'s cut: 5 steps with an async write at
   step 3 and a synchronous one at step 5, a fresh model restored from
   step 5 and 5 more steps, against 10 straight (two straight runs give
   the gate: bitwise equal, the reference test's 1e-6 / 1e-7; else their
   spread), the step-3 checkpoint against a straight 3-step run.  No
   kernel of this repository runs there (launch counts checked);
14. the LM half's MoE family (ROADMAP A8; ``phase14()``) at olmoe-1b-7b's
   full size (16 layers, 64 experts top-8, capacity factor 1.25, bf16),
   random weights from a seed: (a) cut to 2 layers, the card against the
   port's CPU run (prefill logits and 8 decode steps on the CPU's greedy
   tokens, then every parameter after 2 train steps at 1 x 128; gates
   twice the CPU's own bfloat16-vs-float32 distance), the top-k flips a
   layer between card and CPU and the dropped share printed; (b) the 16
   layers through ``serve`` at batch 4, prompt 256, 32 tokens (prefill,
   decode, tok/s, peak bytes above the weights, a decode step's and a
   prefill's device time from a CUDA graph and the idle share, beside
   the bounds: every weight read a decode step; the prefill's products
   with 64 x C expert rows a layer, and its bytes), prefill(S) + decode(S)
   against prefill(S + 1) at 0.15 on the rows whose last position kept
   its experts and, on every row, at capacity factor 8 where nothing
   drops; (c) ``launch.train.build(smoke=False)`` + ``train_loop``, 20
   steps at 4 x 1,024 (the memory reckoned first), every loss, aux and
   grad norm finite, aux > 0, the parameters moved, beside the step's
   bound; (d) on (a)'s cut, straight runs, a restart from an async
   checkpoint and the checkpoint itself, all bitwise.  No kernel of this
   repository runs there (launch counts checked);
15. the LM half's MLA family (ROADMAP A8; ``phase15()``) at deepseek-v3's
   published widths (d_model 7,168, 128 heads, MLA kv_lora 512 + rope 64,
   256 routed experts top-8 and a shared one, MTP depth 1, vocab 129,280,
   bf16), random weights from a seed, the depth cut: (a) 2 layers with 16
   experts, the card against the port's CPU run (prefill logits and 8
   decode steps on the CPU's greedy tokens; the loss with its MTP term and
   its gradients' global norm on 1 x 128 tokens; gates twice the CPU's own
   bfloat16-vs-float32 distance); (b) 4 layers (3 dense, 1 MoE) with all
   256 experts through ``launch.serve.generate`` at batch 4, prompt 256,
   32 tokens (prefill, decode, tok/s, peak above the weights, the latent
   cache beside the expanded K/V, a decode step's and a prefill's device
   time from a CUDA graph and the idle share, beside the bounds),
   prefill(S) + decode(S) against prefill(S + 1) at 0.15 (capacity factor
   8 on the rows whose last position kept its experts; E / k on one row),
   a 4,096-token prompt through the flash route (Dqk 192, Dv 128) in every
   layer, layer 0's flash against the simple route on 16 heads; (c) 4
   layers with 32 experts, 20 steps at 4 x 1,024 (memory reckoned first)
   through ``train_loop``, every loss (MTP in), aux and grad norm finite,
   the parameters moved, beside the bound; (d) on the SMOKE config,
   straight runs, a restart from an async checkpoint and the checkpoint
   itself, bitwise.  TF32 checked off; no kernel of this repository runs
   there (launch counts checked);
16. the LM half's SSM and hybrid families (ROADMAP A8; ``phase16()``):
   mamba2-130m and zamba2-7b at their published configurations, bf16,
   random weights from a seed: (a) the card against the port's CPU run at
   full width with the depth cut (mamba2 at 2 layers; zamba2 at 2 groups
   of 1 mamba layer and a tail of 1, the shared block run twice): the
   prefill of a 300-token prompt (two SSD chunks, the second padded) and 8
   decode steps on the CPU's greedy tokens, then the loss and every
   gradient entry at 1 x 128; gates twice the CPU's own bfloat16-vs-float32
   distance; (b) both uncut (zamba2's 81 layers, 6.75e9 parameters)
   through ``launch.serve.generate`` at batch 4, prompt 256, 32 tokens
   (prefill, decode, tok/s, peak above the weights, the cache's bytes, a
   decode step's and a prefill's device time from a CUDA graph and the
   idle share, beside the bounds), prefill(256) + decode against
   prefill(257) at 0.15 on the same weights in float32 (the bfloat16
   distances printed beside: the reference's bfloat16 SSD, ROADMAP C10),
   a 32,768-token mamba2 prompt whose cache has the 256-token prompt's
   bytes; (c) both uncut through
   ``launch.train.build(smoke=False)`` and ``train_loop`` at 4 x 1,024
   (mamba2 20 steps, zamba2 8; memory reckoned first, the batch halved
   until it fits and the cut printed), a falling loss, beside the step's
   bound; (d) on both SMOKE configs, straight runs, a restart from an
   async checkpoint and the checkpoint itself, bitwise.  TF32 checked
   off; no kernel of this repository runs there (launch counts checked);
17. the LM half's audio and VLM families (ROADMAP A8; ``phase17()``):
   whisper-small and llama-3.2-vision-11b at their published
   configurations, bf16, random weights from a seed, the cross blocks'
   gates set off zero (``GATES``): (a) the card against the port's CPU run
   at full width with the depth cut (whisper at 2 encoder + 2 decoder
   layers on the published 1,500 frames; the VLM at one group of 1 cross
   + 4 self blocks on the published 1,601 image tokens): the prefill of a
   64-token prompt and 8 decode steps on the CPU's greedy tokens, then the
   loss and every gradient entry at 1 x 128; gates twice the CPU's own
   bfloat16-vs-float32 distance; (b) both uncut through
   ``launch.serve.generate`` at batch 4, prompt 64, 32 tokens (prefill,
   decode, tok/s, peak above the weights, the cache's and the cross /
   image K/V's bytes, a decode step's and a prefill's device time from a
   CUDA graph and the idle share, beside the bounds), prefill(64) +
   decode against prefill(65) at 0.15 in bfloat16; (c) both through
   ``launch.train.build(smoke=False)`` and ``train_loop`` at 4 x 1,024
   (whisper uncut, 20 steps; the VLM 8 steps, whole groups cut until the
   reckoned memory fits, the cut printed), a falling loss, beside the
   step's bound; (d) on both SMOKE configs, straight runs, a restart from
   an async checkpoint and the checkpoint itself, bitwise.  TF32 checked
   off; no kernel of this repository runs there (launch counts checked);
18. the production mesh and ``parallel/`` (ROADMAP A8.7; ``phase18()``),
   on meshes of four cells over the one card (``devices=[cuda:0] * 4``;
   the port shards on a single controller, the cells run in turn): (a)
   olmoe-1b-7b uncut served through ``generate`` under a (data 2, model 2)
   mesh, its weights as pieces by ``param_shardings`` (the bytes reckoned
   first), a 4 x 256 prompt (the MoE layers' gather-at-use branch) and 32
   decode steps of 4 tokens (their serve mode), the cache placed by
   ``cache_shardings``, the dropped share beside phase 14's; the same
   mesh at 2 layers against the CPU's at phase 14's gate; (b) qwen2-1.5b
   uncut: one unsharded step at 4 x 1,024 checkpointed, restored into a
   (2, 2) mesh's pieces through ``train_loop(shardings=)`` (bitwise), then
   the sharded step of ``build(mesh=)`` against the unsharded step from
   the same state (loss and every parameter at twice the unsharded step's
   bfloat16-vs-float32 distance), its warm time and peak beside phase
   13's; (c) ``gpipe`` over qwen2's 28 blocks, 4 stages of 7, 8
   microbatches of 1 x 1,024: forward and gradients bitwise the stages in
   sequence, the logits within 0.15 of the unpipelined forward, the bubble
   share 3/11; (d) ``compress_allreduce`` of (b)'s gradient over its two
   data members, within blockmax / 127 * 0.51 of the plain mean and
   bitwise equal across members, timed.  No kernel of this repository
   runs there (launch counts checked).

Prints the features kernel's times by shape on a ``[features]`` line, one
JSON line with every kernel's numbers (the features kernel's ``ms`` its
device time at 128 x 14,641, beside its ``call_ms``), then, as the last
line, ``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero.
Bounds use the H100 SXM's published float32 CUDA-core rate and memory
rate (67 TFLOP/s, 3.35 TB/s at 700 W); the power limit is printed beside.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
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
# phase 7, GP.optimize at MAIN's full width: a fused fit (scale=False) for
# the value of each step and for the final lane value, and one (scale=True)
# for the fit at the winner; the backward pass launches nothing
OPT = dict(steps=3)
OPT_EXPECTED = {
    "phi_features": {},
    "phi_gram": {"moments": OPT["steps"] + 1, "scale": 1},
    "diag_quad": {},
    "chol_update": {},
    "scaled_gram": {},
}
# the case of tests/test_gp_hyperopt.py:108-128, where float32 holds the
# JAX package's gates between the two backends (ROADMAP.md section C, C5)
OPT_GATE = dict(n_train=200, p=2, n=6, seed=3)
# the lane engine at the fleet's per-tenant shape (phase 5)
OPT_FLEET = dict(tenants=8, restarts=4, n_train=10_000, p=4, n=5, steps=5, noise=0.05,
                 seed=0)
# phase 6, the stored-features fit: one fused fit (the Gram) and one
# features launch (the stored Phi); then one scaled-Gram launch on it
PAPER_FIT_EXPECTED = {
    "phi_features": {"": 1},
    "phi_gram": {"scale": 1},
    "diag_quad": {},
    "chol_update": {},
    "scaled_gram": {},
}
# phase 8, the re-optimizing fleet: FLEET's width and data, 2 rounds, a
# re-optimization after round 1's ingest of the tenants with >= 12 new rows
# (~57 of 512: Binomial(4,096, 1/512) >= 12), 3 steps and 1 restart (depth
# cut from the JAX defaults 25 and 2, as phase 7 cut its steps)
REOPT_FLEET = dict(FLEET, rounds=2, reopt_every=2, reopt_min_rows=12, reopt_steps=3,
                   reopt_restarts=1)
# the downdate at full width: every tenant forgets its first 16 rows
FORGET = 16
# benchmarks/tenant_churn.py:48-53, the JAX package's own downdate gate
CHURN = dict(tenants=16, n_train=40, p=2, n=6, noise=0.1, forget=6)
# phase 9, ROADMAP A4: phase 5's fleet and traffic through the pipelined
# engine (queue budget raised past a round's 8,192 queries: submit never
# harvests, so the default 4,096 refuses the round's second half); then the
# same data over a cold tier of 64 of the 512 tenants, a window of 10^4
# rows, aged and re-optimized after round 1 (phase 8a's cuts: 2 rounds, 3
# steps, 1 restart, 12 rows)
PIPE = dict(FLEET, max_in_flight=4, queue_budget=16384)
TIER = dict(PIPE, rounds=2, capacity=448, window=10_000, reopt_every=2, reopt_steps=3,
            reopt_restarts=1, reopt_min_rows=12)
# phase 10, ROADMAP A6: the Vecchia family at the JAX package's own
# benchmark width (benchmarks/vecchia.py:40-47, 94-98 with --full): clustered
# 2-D data, k = 32, the se kernel, eps = 4.714 on both axes, noise 0.02;
# (a) N = 20,000 (seed 1) with 2,000 queries and an update of 256 rows; (b)
# N = 256 at k = 255; (c) N = 10^4 (seed 0) against hermite n = 12 and both
# RFF families at R = 256 on the kernel path; (d) the ordered NLML at 10^5
VECCHIA = dict(n_train=20_000, k=32, eps=4.714, noise=0.02, update=256, subsample=256,
               agree_n=256, accuracy_n=10_000, scale_n=100_000, R=256, hermite_n=12)
VECCHIA_DATA = dict(extent=6.0, length_scale=0.15, noise=0.02, n_bumps=120)
# the Vecchia path launches none of the kernels; each global baseline of
# (c) one fused fit, and one features and one diag-quad launch for its
# 1,000 queries
NO_LAUNCHES = {"phi_features": {}, "phi_gram": {}, "diag_quad": {}, "chol_update": {},
               "scaled_gram": {}}
GLOBAL_EXPECTED = dict(NO_LAUNCHES, phi_features={"": 1}, phi_gram={"scale": 1},
                       diag_quad={"": 1})
# the plain rank-K sweep (a Python loop of K x M rotations, ~1.5 s a row of
# W at M = 14,641) runs on W's first rows only: the kernel is held against
# it there, and at the main path's K = 64 against chol(LL^T + W^TW)
PLAIN_SWEEP_K = 8
# phase 11, ROADMAP A5: phase 9a's fleet and traffic over 4 shards of this
# card, and the row-sharded fit at MAIN's width (the Figure 1 point) over 4
# row shards; nothing cut but the shards sharing one card
SHARDS = 4


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


def phase9(dev, fspec, fout, compare, Xq16):
    """Phase 9 (ROADMAP A4): pipelined fleet serving and the tiered bank at
    the fleet's width.  ``fout`` is phase 5's sync run of the same fleet,
    ``fspec`` its spec, ``Xq16`` its 256 mixed queries.  Returns the numbers
    it printed on its ``[phase 9]`` line, and the pipelined fleet's final
    answers to 1,024 mixed queries with its rounds (phase 11's
    reference)."""
    import numpy as np
    import torch

    from repro_torch.bank import BankRouter, FleetEngine, GPBank
    from repro_torch.checkpoint import gpstate
    from repro_torch.core.gp import GP
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_gp import fleet_dataset, serve_fleet
    from repro_torch.obs import MetricsRegistry, RecompileWatchdog, Tracer, serving_watchdog

    P, T = PIPE, TIER
    B, N, p = P["tenants"], P["n_train"], P["p"]
    t_phase = time.perf_counter()
    report: dict = {}

    class RoundWatchdog(RecompileWatchdog):
        """Stamps each growth with the tracer's clock (microseconds), so
        growth after round 0 can be told from round 0's."""

        stamps: list

        def check(self, context=""):
            grew = super().check(context)
            if grew:
                self.stamps.append((time.perf_counter_ns() // 1000, sum(grew.values())))
            return grew

    # (a) warm the serving shapes (every rung of the ladder, one ingest
    # round of the fleet's bucket) on a bank of the fleet's data, then arm
    _, Xb_np, yb_np, pools = fleet_dataset(
        np.random.default_rng(P["seed"]), tenants=B, n_train=N, p=p, rounds=P["rounds"],
        observations_per_round=P["observations_per_round"], noise=P["noise"], seed=P["seed"])
    wbank = GPBank.fit(torch.from_numpy(Xb_np), torch.from_numpy(yb_np), fspec)
    wd = RoundWatchdog(mode="count")
    wd.stamps = []
    serving_watchdog(watchdog=wd)
    weng = FleetEngine(BankRouter(wbank, microbatch=P["microbatch"],
                                  ingest_chunk=P["ingest_chunk"]), auto_pump=False)
    call = wbank._serving_entry()
    for rung in weng.buckets:
        call(np.zeros(rung, np.int64), np.zeros((rung, p), np.float32))
    for t in range(B):
        weng.observe(t, pools[t][0][0], float(pools[t][1][0]))
    weng.ingest()
    del weng, wbank, call
    torch.cuda.synchronize()
    wd.arm()

    # the pipelined fleet: phase 5's data and traffic through the JAX
    # package's default engine, with a registry, a tracer and the watchdog
    reg, tracer = MetricsRegistry(), Tracer()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pout = serve_fleet(engine="pipelined", backend="pallas", device=dev, metrics=reg,
                       tracer=tracer, watchdog=wd, **P)
    run_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    run_peak = torch.cuda.max_memory_allocated() - mem0
    pbank = pout.pop("bank")
    lat = pout["latency"]
    blocks = sum(lat["bucket_uses"].values())
    irounds = sum(h["ingest_rounds"] for h in pout["rounds"])
    for h, s in zip(pout["rounds"], fout["rounds"]):
        print(f"[pipelined] round {h['round']}: rows_absorbed={h['rows_absorbed']} "
              f"ingest_s={h['ingest_s']:.4f} query_s={h['query_s']:.4f} "
              f"query_mean_s={h['query_mean_s']:.5f} queries_per_s={h['queries_per_s']:.1f} "
              f"rmse={h['rmse']:.5f} timeouts={h['timeouts']}; phase 5 sync: "
              f"query_mean_s={s['query_mean_s']:.5f} queries_per_s={s['queries_per_s']:.1f}")
    o = lat["overall"]
    print(f"[pipelined] engine p50={o['p50_s'] * 1e3:.3f} ms p99={o['p99_s'] * 1e3:.3f} ms "
          f"sustained_qps={o['sustained_qps']:.1f} completed={o['completed']} "
          f"expired={o['expired']} buckets={sorted(lat['bucket_uses'].items())}; "
          f"serve_fleet {run_s:.2f} s, peak {run_peak / 1e9:.3f} GB above the "
          f"{mem0 / 1e9:.3f} GB held")
    # 1 bank fit; per ingest round a features launch and a batched sweep;
    # per dispatched block a features launch
    expected = {"phi_features": {"": blocks + irounds}, "phi_gram": {"bank": 1},
                "diag_quad": {}, "chol_update": {"batched": irounds}, "scaled_gram": {}}
    print(f"[pipelined] launches={json.dumps(counts)}")
    check(counts == expected, f"pipelined fleet launches {counts} != expected {expected}")
    check(all(h["rmse"] < 0.1 and h["var_finite"] for h in pout["rounds"]),
          "pipelined fleet: rmse >= 0.1 or non-finite variances")
    check(all(h["timeouts"] == 0 for h in pout["rounds"]) and o["expired"] == 0
          and o["completed"] == P["rounds"] * P["queries_per_round"],
          f"pipelined fleet dropped or timed out tickets: {o}")
    spans = tracer.events()
    ingests = sorted(e["ts"] for e in spans if e["name"] == "ingest")
    round1 = ingests[pout["rounds"][0]["ingest_rounds"]]
    later = sum(n for ts, n in wd.stamps if ts >= round1)
    print(f"[pipelined] watchdog (count, armed after the warm-up): {wd.recompiles} growths "
          f"in all, {later} over rounds 1-{P['rounds'] - 1}; events={wd.events}")
    check(later == 0, f"the serving path grew a shape after round 0: {wd.events}")
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "trace.jsonl"
        n_ev = tracer.write_jsonl(path)
        want = ("bucket_select", "coalesce", "dispatch", "device_wait", "harvest", "ingest")
        r = subprocess.run([sys.executable, str(ROOT / "tools" / "check_trace.py"), str(path),
                            "--expect", *want], capture_output=True, text=True)
    names = sorted({e["name"] for e in spans})
    print(f"[pipelined] trace: {n_ev} events, spans {names}; tools/check_trace.py rc="
          f"{r.returncode} {r.stdout.strip()} {r.stderr.strip()}")
    check(r.returncode == 0, "the pipelined fleet's trace failed tools/check_trace.py")
    snap = reg.snapshot()["counters"]
    print(f"[pipelined] registry counters: {json.dumps(snap)}")

    # on the fitted bank: a stream of 4 blocks of the top rung (serve_fleet's
    # engine, max_coalesce 4: 1,024 rows) through submit / pump under
    # sync-debug "error" (no host-device barrier on the dispatch path), its
    # results against direct GPBank.mean_var
    mb = P["microbatch"]
    seng = FleetEngine(BankRouter(pbank, microbatch=mb), auto_pump=False, max_in_flight=4)
    top = seng.buckets[-1]
    qrng = np.random.default_rng(21)
    ids9 = qrng.integers(0, B, 4 * top)
    X9 = qrng.uniform(-1.0, 1.0, (4 * top, p)).astype(np.float32)

    def stream():
        tks = []
        for blk in range(4):
            tks += [seng.submit(int(ids9[i]), X9[i]) for i in range(blk * top, (blk + 1) * top)]
            seng.pump(max_blocks=1)
        return tks

    stream()
    seng.drain()                  # warm: the pinned host blocks, the bank's B^-1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tks = stream()
        in_flight = seng.in_flight_blocks
    finally:
        torch.cuda.set_sync_debug_mode(0)
    res = seng.drain()
    stream_buckets = dict(seng.bucket_uses)
    print(f"[check] 4 blocks of {top} through submit/pump under set_sync_debug_mode('error'): "
          f"no host-device sync; {in_flight} blocks in flight before the drain; "
          f"buckets {stream_buckets}")
    check(in_flight == 4, f"{in_flight} blocks in flight, expected 4")
    check(stream_buckets == {top: 8}, f"the stream's blocks were {stream_buckets}, "
          f"expected 8 of {top} rows (warm-up and checked stream)")
    # the direct calls take the same 1,024-row batches the engine dispatched
    direct = [pbank.mean_var([int(t) for t in ids9[i:i + top]],
                             torch.from_numpy(X9[i:i + top]).to(dev))
              for i in range(0, 4 * top, top)]
    ref = dict(ids=ids9, X=X9, mu=torch.cat([m for m, _ in direct]).cpu(),
               var=torch.cat([v for _, v in direct]).cpu(), rounds=pout["rounds"])
    compare(f"pipelined vs direct GPBank.mean_var (4 x {top} mixed queries)",
            [torch.tensor([res[t].mu for t in tks]), torch.tensor([res[t].var for t in tks])],
            [ref["mu"], ref["var"]], rtol=0.0, atol=1e-5,
            why="benchmarks/serve_latency.py gate")
    del direct

    # peak bytes with max_in_flight blocks of the top rung dispatched, and
    # the time to dispatch them, for the device to finish them and to
    # harvest them, 5 times, with the device allocator's cudaMalloc calls
    # and free-and-retry passes in each and the host's garbage collections
    # (ms in all, full passes)
    peng = FleetEngine(BankRouter(pbank, microbatch=mb), auto_pump=False, max_in_flight=4)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dispatch_ms, device_ms, harvest_ms, allocs, gcs = [], [], [], [], []
    gc_now = {"t": 0.0, "ms": 0.0, "full": 0}

    def gc_timer(phase, info):
        if phase == "start":
            gc_now["t"] = time.perf_counter()
        else:
            gc_now["ms"] += (time.perf_counter() - gc_now["t"]) * 1e3
            gc_now["full"] += info["generation"] == 2

    def alloc_stats():
        st = torch.cuda.memory_stats()
        return st.get("num_device_alloc", -1), st.get("num_alloc_retries", -1)

    gc.callbacks.append(gc_timer)
    try:
        for _ in range(5):
            for i in range(4 * top):
                peng.submit(int(ids9[i]), X9[i])
            torch.cuda.synchronize()
            a0 = alloc_stats()
            gc_now.update(ms=0.0, full=0)
            t0 = time.perf_counter()
            peng.pump()
            pumped = peng.in_flight_blocks
            dispatch_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            device_ms.append((time.perf_counter() - t0) * 1e3)
            peng.drain()
            harvest_ms.append((time.perf_counter() - t0) * 1e3)
            allocs.append([b - a for a, b in zip(a0, alloc_stats())])
            gcs.append([round(gc_now["ms"], 2), gc_now["full"]])
    finally:
        gc.callbacks.remove(gc_timer)
    in_flight_peak = torch.cuda.max_memory_allocated() - held
    print(f"[pipelined] {pumped} blocks of {top} in flight, 5 times: dispatched in "
          f"{[round(v, 2) for v in dispatch_ms]} ms, device done after "
          f"{[round(v, 2) for v in device_ms]} ms, harvested after "
          f"{[round(v, 2) for v in harvest_ms]} ms; (cudaMalloc calls, allocator retries) "
          f"{allocs}; (host gc ms, full gc passes) {gcs}; peak "
          f"{in_flight_peak / 1e9:.3f} GB above the {held / 1e9:.3f} GB held")

    # a burst under a 1 us SLO: every ticket expires before its dispatch
    teng = FleetEngine(BankRouter(pbank, microbatch=mb), auto_pump=False, default_slo_s=1e-6)
    ttk = [teng.submit(int(ids9[i]), X9[i]) for i in range(2 * mb)]
    tres = teng.drain()
    sentinel = all(tres[t].timed_out and math.isnan(tres[t].mu) and tres[t].var == math.inf
                   for t in ttk)
    expired = teng.metrics()["overall"]["expired"]
    print(f"[check] burst of {len(ttk)} under slo 1e-6 s: {expired} expired, every one the "
          f"timeout sentinel {sentinel}")
    check(sentinel and expired == len(ttk), "the SLO burst did not answer with the sentinel")

    # ingest with donate_updates=True against the plain ingest of the same
    # rows; the donor bank raises on use
    donor = dataclasses.replace(pbank, stack=dataclasses.replace(
        pbank.stack, **{f: getattr(pbank.stack, f).clone() for f in ("chol", "u", "b")}))
    donor._binv                   # the cache is donated with the stack
    chol_ptr = donor.stack.chol.data_ptr()
    orng = np.random.default_rng(22)
    plain_r = BankRouter(pbank, ingest_chunk=P["ingest_chunk"])
    don_r = BankRouter(donor, ingest_chunk=P["ingest_chunk"], donate_updates=True)
    for _ in range(P["observations_per_round"]):
        t = int(orng.integers(0, B))
        x, yv = pools[t][0][N + 64], float(pools[t][1][N + 64])
        plain_r.observe(t, x, yv)
        don_r.observe(t, x, yv)
    ing = {}
    for name, router in (("plain", plain_r), ("donated", don_r)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        router.ingest()
        torch.cuda.synchronize()
        ing[name] = (time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base)
    dm = don_r.bank.mean_var([int(t) for t in ids9[:mb]], Xq16)
    pm = plain_r.bank.mean_var([int(t) for t in ids9[:mb]], Xq16)
    compare("donated vs plain ingest, mean and variance (256 mixed queries)", list(dm), list(pm),
            rtol=0.0, atol=1e-6, why="tests/test_serve_engine.py:308-328 gate")
    try:
        donor.mean_var([0], Xq16[:1])
        donor_raises = False
    except RuntimeError:
        donor_raises = True
    print(f"[check] donated ingest wrote in place "
          f"{don_r.bank.stack.chol.data_ptr() == chol_ptr}, the donor raises on use "
          f"{donor_raises}; ingest_s plain {ing['plain'][0]:.4f} (peak "
          f"{ing['plain'][1] / 1e9:.3f} GB), donated {ing['donated'][0]:.4f} (peak "
          f"{ing['donated'][1] / 1e9:.3f} GB)")
    check(donor_raises and don_r.bank.stack.chol.data_ptr() == chol_ptr,
          "the donated ingest did not write in place, or its donor still serves")
    report["pipelined"] = {
        "queries_per_s": [h["queries_per_s"] for h in pout["rounds"]],
        "query_mean_s": [h["query_mean_s"] for h in pout["rounds"]],
        "sync_queries_per_s": [h["queries_per_s"] for h in fout["rounds"]],
        "sync_query_mean_s": [h["query_mean_s"] for h in fout["rounds"]],
        "p50_s": o["p50_s"], "p99_s": o["p99_s"], "sustained_qps": o["sustained_qps"],
        "bucket_uses": lat["bucket_uses"], "fit_s": pout["fit_s"],
        "ingest_s": [h["ingest_s"] for h in pout["rounds"]], "run_peak_bytes": run_peak,
        "in_flight_peak_bytes": in_flight_peak, "in_flight_dispatch_ms": dispatch_ms,
        "in_flight_device_ms": device_ms, "in_flight_harvest_ms": harvest_ms,
        "in_flight_allocs": allocs, "in_flight_gc": gcs, "watchdog_growth_after_round0": later,
        "ingest_plain_s": ing["plain"][0], "ingest_donated_s": ing["donated"][0],
        "ingest_plain_peak_bytes": ing["plain"][1],
        "ingest_donated_peak_bytes": ing["donated"][1]}
    del pbank, donor, plain_r, don_r, seng, peng, teng, dm, pm
    torch.cuda.empty_cache()

    # (b) the tiered fleet: the same data over a cold tier with capacity for
    # 448 of the 512 tenants, a window of 10^4 rows, aged and re-optimized
    # after round 1
    reg_b, tr_b = MetricsRegistry(), Tracer()
    with tempfile.TemporaryDirectory() as cold:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        tout = serve_fleet(engine="pipelined", backend="pallas", device=dev, cold_dir=cold,
                           metrics=reg_b, tracer=tr_b, **T)
        tier_run_s = time.perf_counter() - t0
        tcounts = ops.launch_counts()
        tier = tout.pop("tiered")
        tout.pop("bank")
        lc = tout["lifecycle"]
        for h in tout["rounds"]:
            print(f"[tiered] round {h['round']}: rows_absorbed={h['rows_absorbed']} "
                  f"ingest_s={h['ingest_s']:.4f} query_mean_s={h['query_mean_s']:.5f} "
                  f"queries_per_s={h['queries_per_s']:.1f} rmse={h['rmse']:.5f} "
                  f"timeouts={h['timeouts']} aged_rows={h['aged_rows']} "
                  f"reopt_tenants={h['reopt_tenants']} reopt_s={h['reopt_s']:.3f}")
        print(f"[tiered] TieredBank.fit (in fit_s) {tout['fit_s']:.3f} s; lifecycle "
              f"{json.dumps(lc)}; serve_fleet {tier_run_s:.1f} s")
        fit_saves = lc["cold_saves"] - lc["evictions"]
        check(fit_saves == T["tenants"] - T["capacity"],
              f"{fit_saves} cold saves at fit, expected {T['tenants'] - T['capacity']}")
        check(lc["warm_restores"] > 0 and lc["evictions"] == lc["warm_restores"],
              f"page-ins and evictions do not pair up in a full tier: {lc}")
        check(all(h["rmse"] < 0.1 and h["timeouts"] == 0 for h in tout["rounds"]),
              "tiered fleet: rmse >= 0.1 or timeouts")
        # aged rows: replay the fleet's observation draws; a stale tenant
        # (re-optimized, so aged) keeps exactly its window, every other
        # observed tenant more, so the aged set is read off the windows
        rng = np.random.default_rng(T["seed"])
        rng.uniform(-1.0, 1.0, size=T["tenants"])
        seen = np.zeros(T["tenants"], np.int64)
        for _ in range(T["rounds"]):
            for _ in range(T["observations_per_round"]):
                seen[int(rng.integers(0, T["tenants"]))] += 1
            rng.integers(0, T["tenants"], T["queries_per_round"])
            rng.uniform(-1.0, 1.0, size=(T["queries_per_round"], T["p"]))
        W = T["window"]
        aged = [t for t in range(T["tenants"])
                if seen[t] and len(tier.window_rows(t)[1]) == W]
        aged_rows = sum(h["aged_rows"] for h in tout["rounds"])
        reopt_n = sum(h["reopt_tenants"] for h in tout["rounds"])
        want_rows = int(sum(seen[t] for t in aged))
        print(f"[check] aged_rows={aged_rows}: the rows beyond each stale tenant's window "
              f"({len(aged)} tenants at exactly {W} rows, {want_rows} rows; "
              f"{reopt_n} re-optimized; all had >= {T['reopt_min_rows']} new rows "
              f"{bool(all(seen[t] >= T['reopt_min_rows'] for t in aged))}); downdate ok "
              f"for {len(aged) - lc['refit_fallbacks']} of {len(aged)}, "
              f"{lc['refit_fallbacks']} refit fallbacks")
        check(aged_rows == want_rows and len(aged) == reopt_n > 0
              and all(seen[t] >= T["reopt_min_rows"] for t in aged),
              "aged_rows is not the rows beyond the stale tenants' windows")
        # launches: the hot bank's fit and the cold chunk's (one bank launch
        # each); per ingest round (the router's counter: a page-in at full pin
        # coverage may ingest early) a features launch and a batched sweep;
        # one downdate of every aged tenant, with its features launch, and a
        # per-slot refit for its lost pivots; per re-optimized lane a fused fit
        # a step and one for its final value, and the per-slot refit; per
        # dispatched block a features launch, per-row once re-optimized (the
        # blocks dispatched after the reopt span)
        ev_b = tr_b.events()
        reopt_ts = min(e["ts"] for e in ev_b if e["name"] == "reopt")
        dispatched = [e["ts"] for e in ev_b if e["name"] == "dispatch"]
        pre = sum(ts < reopt_ts for ts in dispatched)
        irounds_b = reg_b.snapshot()["counters"]["router_ingest_rounds_total"]
        fallback = 1 if lc["refit_fallbacks"] else 0
        tier_expected = {
            "phi_features": {k: v for k, v in (("", pre + irounds_b + 1),
                                               ("slots", len(dispatched) - pre)) if v},
            "phi_gram": {"bank": 2, "bank_slots": 1 + fallback,
                         "moments": reopt_n * T["reopt_restarts"] * (T["reopt_steps"] + 1)},
            "diag_quad": {},
            "chol_update": {"batched": irounds_b, "downdate": 1},
            "scaled_gram": {},
        }
        print(f"[tiered] launches={json.dumps(tcounts)} ({len(dispatched)} blocks, {pre} "
              f"before the reopt; {irounds_b} ingest rounds)")
        check(tcounts == tier_expected,
              f"tiered fleet launch counts {tcounts} != expected {tier_expected}")
        age_ms = [e["dur"] / 1e3 for e in tr_b.events() if e["name"] == "age"]
        # a page-in: restore (load_state) and insert, evicting the LRU tenant
        cold_t = tier.cold_tenants[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, st_c, _ = gpstate.load_state(tier._cold_path(cold_t), like_spec=tier.spec, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tier.page_in(cold_t)
        torch.cuda.synchronize()
        page_in_s = time.perf_counter() - t0
        m1, v1 = GP.from_state(st_c).mean_var(Xq16)
        m2, v2 = tier.bank.mean_var([cold_t] * Xq16.shape[0], Xq16)
        compare(f"paged-in tenant {cold_t} vs its own checkpoint's session", [m2, v2], [m1, v1],
                rtol=0.0, atol=1e-5, why="tests/test_lifecycle.py:277 gate")
        print(f"[tiered] page-in of tenant {cold_t}: {page_in_s * 1e3:.2f} ms (restore alone "
              f"{restore_s * 1e3:.2f} ms; insert and the LRU eviction the rest); age "
              f"{age_ms} ms (trace)")
        report["tiered"] = {
            "fit_s": tout["fit_s"], "lifecycle": lc, "aged_rows": aged_rows,
            "reopt_tenants": reopt_n, "page_in_s": page_in_s, "restore_s": restore_s,
            "age_ms": age_ms, "launches": tcounts, "rmse": [h["rmse"] for h in tout["rounds"]],
            "query_mean_s": [h["query_mean_s"] for h in tout["rounds"]],
            "reopt_s": [h["reopt_s"] for h in tout["rounds"]], "run_s": tier_run_s}
        del tier, st_c
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    print("[phase 9] " + json.dumps(report))
    print(f"[phase 9] took {report['seconds']:.1f} s")
    return report, ref


def phase10(dev, compare, cuda_ms) -> dict:
    """Phase 10 (ROADMAP A6): the Vecchia family on the card, at the JAX
    package's own benchmark width (``VECCHIA``).  (a) The session path
    (fit, ``mean_var``, ``update``, ``nlml``) at N = 20,000: times, the
    top-k and the lanes apart, peak bytes against a bound reckoned from the
    block sizes, no kernel launched, the card against the port's CPU run;
    (b) the exact GP at full conditioning sets; (c) the clustered accuracy
    against the global expansions on the kernel path, their launches
    exact; (d) the ordered NLML at N = 10^5.  Returns the numbers it
    printed on its ``[phase 10]`` line."""
    import numpy as np
    import torch

    from repro_torch.core import exact_gp, vecchia
    from repro_torch.core.gp import GP, GPSpec
    from repro_torch.data import make_clustered_dataset
    from repro_torch.kernels import knn, ops

    V = VECCHIA
    k, eps, noise = V["k"], [V["eps"]] * 2, V["noise"]
    t_phase = time.perf_counter()
    report: dict = {}

    # the distances are summed element by element (kernels/knn.py); the
    # lanes' batched products and the exact GP's must run in full float32
    prec = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    print(f"[vecchia] float32 matmul precision {prec[0]!r}, allow_tf32 {prec[1]}")
    check(prec == ("highest", False), f"float32 products would run in TF32: {prec}")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def median_s(fn, reps: int = 3) -> float:
        return statistics.median(timed(fn)[1] for _ in range(reps))

    def peak(fn):
        """(out, bytes the call held at its peak beyond what was live)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    slack = 32 << 20          # the caching allocator's rounding

    def bounds(Q, N, bq, bt, p=2, T=1):
        """Peak bytes of mean_var (Q queries) and nlml (N rows), reckoned
        here from the block sizes and the budgets the modules document, not
        from their helpers: a k-NN pass takes whole query blocks up to 2^23
        floats of (rows, bt) distance tile, and holds five such tiles and
        twelve four-byte words a (rows, k + bt) candidate (distances, int64
        indices, the sort's outputs and scratch); a lane pass takes whole
        query blocks up to 2^22 floats of k x k lanes, and holds 3p + 12
        words a lane element and 4 (p + T) a neighbour.  The two passes
        never overlap, so the larger one counts, with the (rows, k)
        neighbour tables; never N x N or Q x N."""
        knn_rows = max(bq, (1 << 23) // bt // bq * bq)
        lane_rows = max(bq, (1 << 22) // (k * k) // bq * bq)

        def knn_pass(rows):
            r = min(rows, knn_rows)
            return r * (5 * bt + 12 * (k + bt))

        def lane_pass(rows):
            r = min(rows, lane_rows)
            return r * (k * k * (3 * p + 12) + 4 * k * (p + T))

        mv = 4 * (max(knn_pass(Q), lane_pass(Q)) + 3 * Q * k + 2 * Q * (T + 1)) + slack
        nl = 4 * (max(knn_pass(N), lane_pass(N)) + 10 * N * k + 2 * N * (p + T)) + slack
        return mv, nl

    # -- (a) the session path at N = 20,000 ---------------------------------
    X, y, Xs, ys = make_clustered_dataset(V["n_train"], seed=1, device=dev, **VECCHIA_DATA)
    N, Q = X.shape[0], Xs.shape[0]
    spec = GPSpec.create_vecchia(eps, noise, neighbors=k, device=dev)
    bq, bt = vecchia._block_q(k), min(spec.block_rows, N)
    ops.reset_launch_counts()
    (mu, var), cold_s = timed(lambda: GP.fit(X, y, spec).mean_var(Xs))
    fit_mv_s = median_s(lambda: GP.fit(X, y, spec).mean_var(Xs))
    gp = GP.fit(X, y, spec)
    mv_s = median_s(lambda: gp.mean_var(Xs))
    nlml, nlml_cold_s = timed(lambda: gp.nlml(X, y))
    nlml_s = median_s(lambda: gp.nlml(X, y))
    u = V["update"]
    up = GP.fit(X[:-u], y[:-u], spec)
    (upd, up_s) = timed(lambda: up.update(X[-u:], y[-u:]).mean_var(Xs))
    # a checkpoint round trip onto the card: leaves, spec and answers bitwise
    with tempfile.TemporaryDirectory() as ckdir:
        gp.save(ckdir)
        (ld, ld_mv), load_s = timed(lambda: (lambda g: (g, g.mean_var(Xs)))(
            GP.load(ckdir, device="cuda")))
    counts = ops.launch_counts()
    print(f"[vecchia] N={N} k={k} Q={Q} block_q={bq} block_t={bt}: first fit + mean_var "
          f"{cold_s:.3f} s; warm fit + mean_var {fit_mv_s * 1e3:.2f} ms, mean_var alone "
          f"{mv_s * 1e3:.2f} ms; nlml {nlml_s * 1e3:.2f} ms (first {nlml_cold_s:.3f} s); "
          f"update of {u} rows + mean_var {up_s * 1e3:.2f} ms; GP.load(device='cuda') + "
          f"mean_var {load_s * 1e3:.2f} ms; launches {json.dumps(counts)}")
    check(ld.state.X.device.type == "cuda" and torch.equal(ld.state.X, gp.state.X)
          and torch.equal(ld.state.y, gp.state.y), "the loaded Vecchia leaves differ")
    check(ld.spec.describe() == gp.spec.describe()
          and torch.equal(ld.spec.eps, gp.spec.eps) and float(ld.spec.noise) == float(gp.spec.noise),
          "the loaded Vecchia spec differs")
    check(torch.equal(ld_mv[0], mu) and torch.equal(ld_mv[1], var),
          "the loaded Vecchia session answers differently")
    del ld, ld_mv
    check(counts == NO_LAUNCHES, f"the Vecchia path launched a kernel: {counts}")
    check(tuple(mu.shape) == (Q,) and tuple(var.shape) == (Q,), "mean_var shapes")
    check(bool(torch.isfinite(mu).all() and torch.isfinite(var).all() and (var >= 0).all()),
          "mean_var not finite")
    check(bool(torch.isfinite(nlml)), "nlml not finite")
    check(torch.equal(upd[0], mu) and torch.equal(upd[1], var),
          "update of the last rows differs from the fit on all of them")
    rmse = float(torch.sqrt(torch.mean((mu - ys) ** 2)))
    print(f"[vecchia] rmse {rmse:.5f}, nlml {float(nlml):.2f} ({float(nlml) / N:.4f} a row)")

    # the top-k and the lanes apart (CUDA events, median of 5)
    se = exact_gp.KERNELS["se"]
    y2 = y[:, None]
    _, idx = knn.knn_search(Xs, X, k, block_q=bq, block_t=bt)
    nbr, msk = knn.ordered_topk(X, k, block_q=bq, block_t=bt)
    step = vecchia.lane_rows(k)
    sig2 = spec.noise ** 2

    def mv_lanes():
        for lo in range(0, Q, step):
            vecchia._mean_var_lanes(X, y2, Xs[lo:lo + step], idx[lo:lo + step], spec.eps,
                                    sig2, se)

    def nll_lanes():
        for lo in range(0, N, step):
            vecchia._nll_lanes(X, y2, y2[lo:lo + step], X[lo:lo + step], nbr[lo:lo + step],
                               msk[lo:lo + step], spec.eps, sig2, se)

    parts = {
        "knn_ms": cuda_ms(lambda: knn.knn_search(Xs, X, k, block_q=bq, block_t=bt), reps=5),
        "mean_var_lanes_ms": cuda_ms(mv_lanes, reps=5),
        "ordered_topk_ms": cuda_ms(lambda: knn.ordered_topk(X, k, block_q=bq, block_t=bt),
                                   reps=5),
        "nlml_lanes_ms": cuda_ms(nll_lanes, reps=5),
    }
    print("[vecchia] parts (CUDA events): " + ", ".join(f"{n} {v:.3f}" for n, v in parts.items()))
    del idx, nbr, msk

    # peak bytes against the reckoned bounds
    mv_bound, nl_bound = bounds(Q, N, bq, bt)
    _, mv_peak = peak(lambda: gp.mean_var(Xs))
    _, nl_peak = peak(lambda: gp.nlml(X, y))
    print(f"[vecchia] peak bytes: mean_var {mv_peak:,} (bound {mv_bound:,}), nlml "
          f"{nl_peak:,} (bound {nl_bound:,}); a dense Q x N float32 {4 * Q * N:,}, "
          f"N x N {4 * N * N:,}")
    check(mv_peak <= mv_bound and nl_peak <= nl_bound, "a Vecchia call exceeded its bound")
    # the bounds have teeth: one dense tile more than was measured breaks them
    check(mv_peak + 4 * Q * N > mv_bound and nl_peak + 4 * N * N > nl_bound,
          "a Vecchia bound would admit a dense Q x N or N x N tile")

    # the card against the port's CPU run on a subsample of the queries,
    # on the rows whose conditioning sets are one set on both devices
    S = V["subsample"]
    cspec = GPSpec.create_vecchia(eps, noise, neighbors=k, device="cpu")
    mu_c, var_c = GP.fit(X.cpu(), y.cpu(), cspec).mean_var(Xs[:S].cpu())
    _, i_d = knn.knn_search(Xs[:S], X, k, block_q=bq, block_t=bt)
    _, i_c = knn.knn_search(Xs[:S].cpu(), X.cpu(), k, block_q=bq, block_t=bt)
    same = torch.tensor([set(a) == set(b) for a, b in zip(i_d.cpu().tolist(), i_c.tolist())])
    print(f"[vecchia] card vs CPU: {int(same.sum())} of {S} conditioning sets equal")
    check(int(same.sum()) >= S - 2, "the card's conditioning sets differ from the CPU's")
    compare("vecchia card vs CPU mean", [mu[:S].cpu()[same]], [mu_c[same]], rtol=0.0,
            atol=1e-4, why="tests/test_vecchia.py:148-156 gate")
    compare("vecchia card vs CPU variance", [var[:S].cpu()[same]], [var_c[same]], rtol=0.0,
            atol=1e-4, why="tests/test_vecchia.py:148-156 gate")
    report["session"] = {
        "N": N, "Q": Q, "k": k, "first_fit_mean_var_s": cold_s, "fit_mean_var_s": fit_mv_s,
        "mean_var_s": mv_s, "load_mean_var_s": load_s, "nlml_s": nlml_s, "update_mean_var_s": up_s, "rmse": rmse, **parts,
        "mean_var_peak_bytes": mv_peak, "mean_var_bound_bytes": mv_bound,
        "nlml_peak_bytes": nl_peak, "nlml_bound_bytes": nl_bound}
    del gp, up, upd, X, y, Xs, ys, mu, var

    # -- (b) the exact GP at full conditioning sets (benchmarks/vecchia.py:140-160)
    Xa, ya, Xsa, _ = make_clustered_dataset(V["agree_n"], seed=0, device=dev, **VECCHIA_DATA)
    agree = {}
    for kernel in ("se", "matern52"):
        sp = GPSpec.create_vecchia(eps, noise, kernel=kernel, neighbors=V["agree_n"] - 1,
                                   device=dev)
        mu_v, var_v = GP.fit(Xa, ya, sp).mean_var(Xsa)
        mu_e, var_e = exact_gp.mean_var(exact_gp.fit(Xa, ya, sp.eps, sp.noise, kernel), Xsa)
        agree[kernel] = [
            compare(f"vecchia k = N - 1 vs exact GP ({kernel}) mean", [mu_v], [mu_e],
                    rtol=0.0, atol=1e-4, why="benchmarks/vecchia.py:156 gate"),
            compare(f"vecchia k = N - 1 vs exact GP ({kernel}) variance", [var_v], [var_e],
                    rtol=0.0, atol=1e-4, why="benchmarks/vecchia.py:157 gate")]
    report["agreement"] = agree

    # -- (c) the clustered accuracy at N = 10^4 (benchmarks/vecchia.py:98-139)
    Xc, yc, Xsc, ysc = make_clustered_dataset(V["accuracy_n"], seed=0, device=dev,
                                              **VECCHIA_DATA)

    def fit_serve(sp):
        return GP.fit(Xc, yc, sp).mean_var(Xsc)[0]

    def rmse_of(m):
        return float(torch.sqrt(torch.mean((m - ysc) ** 2)))

    vspec = GPSpec.create_vecchia(eps, noise, neighbors=k, device=dev)
    ops.reset_launch_counts()
    r_v = rmse_of(fit_serve(vspec))
    check(ops.launch_counts() == NO_LAUNCHES, "the Vecchia path launched a kernel")
    t_v = median_s(lambda: fit_serve(vspec))
    globals_ = {
        "hermite": GPSpec.create(V["hermite_n"], eps, noise=noise, backend="pallas",
                                 device=dev),
        "rff_se": GPSpec.create_rff(eps, noise=noise, num_features=V["R"], seed=0,
                                    backend="pallas", device=dev),
        "rff_matern52": GPSpec.create_rff(eps, noise=noise, kernel="matern52",
                                          num_features=V["R"], seed=0, backend="pallas",
                                          device=dev),
    }
    g_rmse, g_s, g_counts = {}, {}, {}
    for name, sp in globals_.items():
        ops.reset_launch_counts()
        g_rmse[name] = rmse_of(fit_serve(sp))
        g_counts[name] = ops.launch_counts()
        check(g_counts[name] == GLOBAL_EXPECTED,
              f"{name} launches {g_counts[name]} != {GLOBAL_EXPECTED}")
        g_s[name] = median_s(lambda: fit_serve(sp))
    best = min(g_rmse, key=g_rmse.get)
    accuracy = {
        "vecchia_rmse": r_v, "vecchia_s": t_v, "global_rmse": g_rmse, "global_s": g_s,
        "best_global": best, "global_over_vecchia_rmse": g_rmse[best] / r_v,
        "vecchia_over_best_global_seconds": t_v / g_s[best], "launches": g_counts}
    print(f"[vecchia accuracy] N={Xc.shape[0]}: vecchia rmse {r_v:.5f} in {t_v * 1e3:.2f} ms; "
          + "; ".join(f"{n} {g_rmse[n]:.5f} in {g_s[n] * 1e3:.2f} ms" for n in g_rmse)
          + f"; global_over_vecchia_rmse {accuracy['global_over_vecchia_rmse']:.3f}, "
          f"vecchia_over_best_global_seconds {accuracy['vecchia_over_best_global_seconds']:.3f}")
    check(accuracy["global_over_vecchia_rmse"] >= 1.0,
          "a global expansion beat Vecchia on the clustered data")
    report["accuracy"] = accuracy
    del Xc, yc, Xsc, ysc

    # -- (d) the scale point: the ordered NLML at N = 10^5 -------------------
    Xd, yd, _, _ = make_clustered_dataset(V["scale_n"], seed=2, device=dev, **VECCHIA_DATA)
    Nd = Xd.shape[0]
    dspec = GPSpec.create_vecchia(eps, noise, neighbors=k, device=dev)
    gd = GP.fit(Xd, yd, dspec)
    ops.reset_launch_counts()
    (nd, nd_peak), nd_s = timed(lambda: peak(lambda: gd.nlml(Xd, yd)))
    check(ops.launch_counts() == NO_LAUNCHES, "the Vecchia path launched a kernel")
    _, nd_bound = bounds(1, Nd, bq, min(dspec.block_rows, Nd))
    print(f"[vecchia scale] N={Nd}: nlml {float(nd):.1f} ({float(nd) / Nd:.4f} a row) in "
          f"{nd_s:.3f} s; peak {nd_peak:,} bytes (bound {nd_bound:,}; a dense N x N float32 "
          f"{4 * Nd * Nd:,})")
    check(bool(torch.isfinite(nd)), "the N = 10^5 nlml is not finite")
    check(nd_peak <= nd_bound, "the N = 10^5 nlml exceeded its bound")
    report["scale"] = {"N": Nd, "nlml_s": nd_s, "nlml_per_row": float(nd) / Nd,
                       "peak_bytes": nd_peak, "bound_bytes": nd_bound}
    del gd, Xd, yd
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    print("[phase 10] " + json.dumps(report))
    print(f"[phase 10] took {report['seconds']:.1f} s")
    return report


def phase11(dev, fspec, compare, cuda_ms, ref9, main) -> dict:
    """Phase 11 (ROADMAP A5): the sharded paths on the card.  (a)
    ``serve_fleet(shards=1)`` on phase 9a's fleet and traffic, its final
    answers against phase 9a's resident fleet's (``ref9``); (b) the same
    fleet over 4 shards of this card (``make_bank_mesh(4, devices=[cuda:0]
    * 4)``) through ``ShardedGPBank``, ``BankRouter`` and ``FleetEngine`` as
    ``serve_fleet`` drives them; (c) ``fit_distributed`` /
    ``predict_distributed`` at MAIN's width (``main``: phase 3's data, spec
    and fit_s) over ``make_local_mesh(data=4, devices=[cuda:0] * 4)``; (d)
    (b) and (c) over distinct cards, and the launch guard's card tests,
    where two or more cards are visible.  Launch counts exact throughout.
    Returns the numbers it printed on its ``[phase 11]`` line."""
    import numpy as np
    import torch

    from repro_torch.bank import BankRouter, FleetEngine, GPBank, ShardedGPBank, TieredBank
    from repro_torch.core import distributed as dgp
    from repro_torch.core import fagp
    from repro_torch.core.expansions import get_expansion
    from repro_torch.core.gp import GP, GPSpec
    from repro_torch.data import make_gp_dataset
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_bank_mesh, make_local_mesh
    from repro_torch.launch.serve_gp import fleet_dataset, serve_fleet
    from repro_torch.obs import MetricsRegistry, Tracer

    P, S = PIPE, SHARDS
    B, N, p = P["tenants"], P["n_train"], P["p"]
    t_phase = time.perf_counter()
    report: dict = {}
    ten9 = [int(t) for t in ref9["ids"]]
    Xq9 = torch.from_numpy(ref9["X"]).to(dev)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def counted(fn):
        ops.reset_launch_counts()
        out = fn()
        return out, ops.launch_counts()

    def launches(phi_features=None, phi_gram=None, diag_quad=None, chol_update=None):
        return {"phi_features": phi_features or {}, "phi_gram": phi_gram or {},
                "diag_quad": diag_quad or {}, "chol_update": chol_update or {},
                "scaled_gram": {}}

    def from_trace(events, C_l, phi_gram=None):
        """A sharded serving run's launches, read off its trace: a features
        launch per shard touched per dispatched block (``shard_dispatch``)
        and per ingest round (``shard_ingest``), and per shard touched per
        round a sweep, batched unless that shard's group bucket is 1."""
        disp = [e for e in events if e["name"] == "shard_dispatch"]
        ing = [e for e in events if e["name"] == "shard_ingest"]
        sweeps: dict = {}
        for e in ing:
            g = e["args"]["groups"]
            v = "batched" if min(C_l, 1 << (g - 1).bit_length()) > 1 else ""
            sweeps[v] = sweeps.get(v, 0) + 1
        return launches({"": len(disp) + len(ing)}, phi_gram, None, sweeps)

    # (a) serve_fleet(shards=1): phase 9a's fleet and traffic, one shard
    tr_a = Tracer()
    (aout, a_counts), a_s = timed(lambda: counted(lambda: serve_fleet(
        engine="pipelined", backend="pallas", device=dev, shards=1, tracer=tr_a, **P)))
    abank = aout.pop("bank")
    want = from_trace(tr_a.events(), abank.shard_capacity, {"bank": 1})
    for h, r9 in zip(aout["rounds"], ref9["rounds"]):
        print(f"[shards=1] round {h['round']}: ingest_s={h['ingest_s']:.4f} "
              f"query_mean_s={h['query_mean_s']:.5f} queries_per_s={h['queries_per_s']:.1f} "
              f"rmse={h['rmse']:.5f}; phase 9a resident: query_mean_s="
              f"{r9['query_mean_s']:.5f} queries_per_s={r9['queries_per_s']:.1f} "
              f"rmse={r9['rmse']:.5f}")
    print(f"[shards=1] launches={json.dumps(a_counts)}; occupancy {aout['shard_occupancy']}; "
          f"serve_fleet {a_s:.2f} s")
    check(a_counts == want, f"serve_fleet(shards=1) launches {a_counts} != {want}")
    check(aout["shard_occupancy"] == [B] and all(
        h["timeouts"] == 0 and h["rmse"] < 0.1 for h in aout["rounds"]),
        "serve_fleet(shards=1): occupancy, timeouts or rmse")
    mu_a, var_a = abank.mean_var(ten9, Xq9)
    compare("serve_fleet(shards=1) vs phase 9a's resident pipelined fleet, final answers "
            "(1,024 mixed queries)", [mu_a.cpu(), var_a.cpu()], [ref9["mu"], ref9["var"]],
            rtol=0.0, atol=1e-5, why="tests/test_shard_bank.py:262 gate")
    report["shards1"] = {
        "queries_per_s": [h["queries_per_s"] for h in aout["rounds"]],
        "query_mean_s": [h["query_mean_s"] for h in aout["rounds"]],
        "ingest_s": [h["ingest_s"] for h in aout["rounds"]], "fit_s": aout["fit_s"],
        "launches": a_counts}
    del abank, aout
    torch.cuda.empty_cache()

    # (b) the fleet over 4 shards of this card
    rng = np.random.default_rng(P["seed"])
    offsets, Xb_np, yb_np, pools = fleet_dataset(
        rng, tenants=B, n_train=N, p=p, rounds=P["rounds"],
        observations_per_round=P["observations_per_round"], noise=P["noise"], seed=P["seed"])
    Xb, yb = torch.from_numpy(Xb_np).to(dev), torch.from_numpy(yb_np).to(dev)
    mesh = make_bank_mesh(S, devices=[dev] * S)
    mesh2 = make_bank_mesh(S, 2, devices=[dev] * 2 * S)
    (rb, r_counts), t_res = timed(lambda: counted(lambda: GPBank.fit(Xb, yb, fspec)))
    (sb, s_counts), t_sh = timed(lambda: counted(lambda: ShardedGPBank.fit(Xb, yb, fspec, mesh)))
    (s2, s2_counts), t_2d = timed(lambda: counted(
        lambda: ShardedGPBank.fit(Xb, yb, fspec, mesh2)))
    print(f"[sharded] fit: resident GPBank.fit {t_res:.4f} s {json.dumps(r_counts)}; "
          f"ShardedGPBank.fit over {S} shards {t_sh:.4f} s {json.dumps(s_counts)}; "
          f"(bank {S}, data 2) {t_2d:.4f} s {json.dumps(s2_counts)}")
    check(s_counts == launches(phi_gram={"bank": S}) and s2_counts == launches(
        phi_gram={"bank": 2 * S}), "sharded fits: one bank launch per shard (per cell in 2-D)")
    mu_r, var_r = rb.mean_var(ten9, Xq9)
    fit_err = {"1-D": compare(
        "ShardedGPBank.fit vs resident GPBank.fit (1,024 mixed queries)",
        list(sb.mean_var(ten9, Xq9)), [mu_r, var_r], rtol=0.0, atol=1e-4,
        why="tests/test_shard_bank.py:93-95 gate")}
    # the (bank, data) fit sums each tenant's rows in two halves of 5,000
    # and the resident fit in one, each in strips of 1,024 rows added in
    # order, the reference kernel's two-level sum (ROADMAP.md section C,
    # C9): the JAX test's 1e-4 holds at this width, and each fit's distance
    # from a float64 fit of 8 tenants is printed beside it
    m2, v2 = s2.mean_var(ten9, Xq9)
    fit_err["2-D"] = compare(
        f"ShardedGPBank.fit (bank {S}, data 2) vs resident GPBank.fit (1,024 mixed queries)",
        [m2, v2], [mu_r, var_r], rtol=0.0, atol=1e-4,
        why="tests/test_shard_bank.py:134-136 gate")
    eight = sorted(set(ten9))[:8]
    rows8 = [i for i, t in enumerate(ten9) if t in eight]
    t8 = [ten9[i] for i in rows8]
    idx8 = fagp._idx_tensor(fspec)
    sp64 = dataclasses.replace(fspec, eps=fspec.eps.double(), rho=fspec.rho.double(),
                               noise=fspec.noise.double())
    d64 = torch.exp(0.5 * get_expansion("hermite").log_eigenvalues(idx8, sp64))
    m64 = torch.zeros(len(rows8), dtype=torch.float64, device=dev)
    for t in eight:
        Ph = get_expansion("hermite").features(Xb[t].double(), idx8, sp64)
        L64 = torch.linalg.cholesky(torch.eye(len(idx8), dtype=torch.float64, device=dev)
                                    + d64[:, None] * (Ph.T @ Ph) * d64[None, :] / sp64.noise**2)
        u64 = d64 * torch.cholesky_solve((d64 * (Ph.T @ yb[t].double()))[:, None],
                                         L64)[:, 0] / sp64.noise**2
        mine = [j for j, tt in enumerate(t8) if tt == t]
        m64[mine] = get_expansion("hermite").features(Xq9[[rows8[j] for j in mine]].double(),
                                                      idx8, sp64) @ u64
    from64 = {name: float((bank.mean_var(t8, Xq9[rows8])[0].double() - m64).abs().max())
              for name, bank in (("resident", rb), ("1-D", sb), ("2-D", s2))}
    print(f"[sharded] max |fit - resident fit| on 1,024 mixed queries: 1-D "
          f"{fit_err['1-D']:.3e}, (bank {S}, data 2) {fit_err['2-D']:.3e} (gate 1e-4; "
          f"benchmarks/shard_scaling.py:242-243's 5e-5 beside); each mean from a float64 fit "
          f"(8 tenants, {len(rows8)} queries): "
          f"{json.dumps(from64)}")
    del sb, s2, m2, v2
    # the JAX test's own shape (tests/test_shard_bank.py:32-56, 120-136): 16
    # tenants of 8 rows, p = 2, n = 8, on (4) and (4, 2) meshes of this card
    jspec = GPSpec.create(8, eps=np.full(2, 0.8, np.float32), rho=2.0, noise=0.05,
                          backend="pallas", device=dev)
    jdata = [make_gp_dataset(8, 2, seed=t, device=dev)[:2] for t in range(16)]
    jX, jy = torch.stack([x for x, _ in jdata]), torch.stack([y for _, y in jdata])
    jrng = np.random.default_rng(0)
    jq = torch.from_numpy(jrng.uniform(-1, 1, size=(64, 2)).astype(np.float32)).to(dev)
    jt = [int(t) for t in jrng.integers(0, 16, 64)]
    jres = GPBank.fit(jX, jy, jspec).mean_var(jt, jq)
    for label, m in (("(bank 4)", mesh), ("(bank 4, data 2)", mesh2)):
        compare(f"ShardedGPBank.fit {label} vs resident at the JAX test's shape (16 x 8 rows, "
                f"M = 64)", list(ShardedGPBank.fit(jX, jy, jspec, m).mean_var(jt, jq)),
                list(jres), rtol=0.0, atol=1e-4,
                why="tests/test_shard_bank.py:93-95, 134-136 gate")
    sh, from_s = timed(lambda: ShardedGPBank.from_bank(rb, mesh, pad_capacity=True))
    (mv_s, mv_counts) = counted(lambda: sh.mean_var(ten9, Xq9))
    check(mv_counts == launches({"": S}), f"sharded mean_var launches {mv_counts}")
    compare("ShardedGPBank.from_bank serving the resident states (1,024 mixed queries)",
            list(mv_s), [mu_r, var_r], rtol=0.0, atol=1e-5,
            why="tests/test_shard_bank.py:82-84 gate")
    C_l = sh.shard_capacity
    urng = np.random.default_rng(31)
    upd = [0, 1, C_l + 1, 2 * C_l + 2, 3 * C_l + 3]      # shard 0 twice, each other once
    Xk = torch.from_numpy(urng.uniform(-1, 1, (len(upd), 2, p)).astype(np.float32)).to(dev)
    yk = torch.from_numpy(urng.normal(size=(len(upd), 2)).astype(np.float32)).to(dev)
    sh_u, u_counts = counted(lambda: sh.update(upd, Xk, yk))
    check(u_counts == launches({"": S}, chol_update={"batched": 1, "": S - 1}),
          f"mixed-tenant sharded update launches {u_counts}")
    compare("mixed-tenant update, sharded vs resident (mean, 1,024 mixed queries)",
            [sh_u.mean_var(ten9, Xq9)[0]], [rb.update(upd, Xk, yk).mean_var(ten9, Xq9)[0]],
            rtol=0.0, atol=1e-4, why="tests/test_shard_bank.py:109-111 gate (pallas)")
    del sh_u

    # engine drain and ingest parity (tests/test_shard_bank.py:262, 282)
    deng = FleetEngine(BankRouter(sh, microbatch=P["microbatch"]), queue_budget=P["queue_budget"])
    dt = [deng.submit(t, ref9["X"][i]) for i, t in enumerate(ten9)]
    dres = deng.drain()
    compare("sharded engine drain vs resident mean_var (1,024 mixed queries)",
            [torch.tensor([dres[t].mu for t in dt])], [mu_r.cpu()], rtol=0.0, atol=1e-5,
            why="tests/test_shard_bank.py:262 gate")
    irng = np.random.default_rng(32)
    ir_s = BankRouter(sh, ingest_chunk=P["ingest_chunk"])
    ir_r = BankRouter(rb, ingest_chunk=P["ingest_chunk"])
    for _ in range(P["observations_per_round"]):
        t = int(irng.integers(0, B))
        x, yv = pools[t][0][N + 80], float(pools[t][1][N + 80])
        ir_s.observe(t, x, yv)
        ir_r.observe(t, x, yv)
    ir_s.ingest()
    ir_r.ingest()
    compare(f"sharded ingest vs resident ingest ({P['observations_per_round']} observations; "
            "mean, 1,024 mixed queries)", [ir_s.bank.mean_var(ten9, Xq9)[0]],
            [ir_r.bank.mean_var(ten9, Xq9)[0]], rtol=0.0, atol=1e-4,
            why="tests/test_shard_bank.py:282 gate")
    del deng, ir_s, ir_r, rb
    torch.cuda.empty_cache()

    # the fleet's rounds over the 4 shards, as serve_fleet drives them
    # (serve_fleet's own mesh takes one card a shard): the same draws
    reg, tr = MetricsRegistry(), Tracer()
    router = BankRouter(sh, microbatch=P["microbatch"], ingest_chunk=P["ingest_chunk"],
                        metrics=reg, tracer=tr)
    eng = FleetEngine(router, max_in_flight=P["max_in_flight"], queue_budget=P["queue_budget"],
                      metrics=reg, tracer=tr)
    consumed = [N] * B
    rounds = []
    ops.reset_launch_counts()
    for r in range(P["rounds"]):
        for _ in range(P["observations_per_round"]):
            t = int(rng.integers(0, B))
            i = consumed[t] % pools[t][0].shape[0]
            consumed[t] += 1
            eng.observe(t, pools[t][0][i], pools[t][1][i])
        _, ingest_s = timed(eng.ingest)
        q_t = rng.integers(0, B, P["queries_per_round"])
        Xq = rng.uniform(-1.0, 1.0, size=(P["queries_per_round"], p)).astype(np.float32)
        truth = np.sum(np.cos(Xq), axis=1) + offsets[q_t]
        t0 = time.perf_counter()
        tks = [eng.submit(int(t), Xq[i]) for i, t in enumerate(q_t)]
        res = eng.drain()
        query_s = time.perf_counter() - t0
        mu = np.array([res[t].mu for t in tks])
        nb = -(-P["queries_per_round"] // P["microbatch"])
        rounds.append(dict(ingest_s=ingest_s, query_s=query_s, query_mean_s=query_s / nb,
                           queries_per_s=P["queries_per_round"] / query_s,
                           rmse=float(np.sqrt(np.mean((mu - truth) ** 2))),
                           timeouts=sum(res[t].timed_out for t in tks)))
    loop_counts = ops.launch_counts()
    for r, (h, r9) in enumerate(zip(rounds, ref9["rounds"])):
        print(f"[sharded] round {r}: ingest_s={h['ingest_s']:.4f} "
              f"query_mean_s={h['query_mean_s']:.5f} queries_per_s={h['queries_per_s']:.1f} "
              f"rmse={h['rmse']:.5f}; phase 9a resident: query_mean_s={r9['query_mean_s']:.5f} "
              f"queries_per_s={r9['queries_per_s']:.1f} rmse={r9['rmse']:.5f}")
    want = from_trace(tr.events(), C_l)
    print(f"[sharded] launches={json.dumps(loop_counts)} (expected from the trace "
          f"{json.dumps(want)}); buckets {sorted(eng.bucket_uses.items())}")
    check(loop_counts == want, f"sharded fleet launches {loop_counts} != {want}")
    check(all(h["timeouts"] == 0 and abs(h["rmse"] - r9["rmse"]) < 1e-4
              for h, r9 in zip(rounds, ref9["rounds"])),
          "the sharded fleet's rmse drifts from the resident fleet's, or it timed out")
    gauges = {k.split("{")[0] for k in reg.snapshot()["gauges"]}
    check({"bank_shard_occupancy", "bank_shard_backlog"} <= gauges, "per-shard gauges missing")
    compare("sharded fleet vs phase 9a's resident fleet, final answers (1,024 mixed queries)",
            list(router.bank.mean_var(ten9, Xq9)), [ref9["mu"].to(dev), ref9["var"].to(dev)],
            rtol=0.0, atol=1e-4, why="tests/test_shard_bank.py:282 gate")

    # no host-device sync on the sharded dispatch path: 4 top-rung blocks
    seng = FleetEngine(BankRouter(router.bank, microbatch=P["microbatch"]), auto_pump=False,
                       max_in_flight=4)
    top = seng.buckets[-1]

    def stream():
        tks = []
        for blk in range(4):
            tks += [seng.submit(ten9[i], ref9["X"][i]) for i in range(blk * top, (blk + 1) * top)]
            seng.pump(max_blocks=1)
        return tks

    stream()
    seng.drain()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tks = stream()
        in_flight = seng.in_flight_blocks
    finally:
        torch.cuda.set_sync_debug_mode(0)
    res = seng.drain()
    print(f"[check] 4 sharded blocks of {top} through submit/pump under "
          f"set_sync_debug_mode('error'): no host-device sync; {in_flight} in flight")
    check(in_flight == 4, f"{in_flight} sharded blocks in flight, expected 4")
    direct = router.bank.mean_var(ten9, Xq9)
    compare("sharded pipelined vs direct ShardedGPBank.mean_var (1,024 mixed queries)",
            [torch.tensor([res[t].mu for t in tks]), torch.tensor([res[t].var for t in tks])],
            [direct[0].cpu(), direct[1].cpu()], rtol=0.0, atol=1e-5,
            why="benchmarks/serve_latency.py gate")
    del seng, direct

    # rebalance after emptying shard 0; a page-out and a page-in
    bb = router.bank
    for t in [t for t in bb.tenants if bb.shard_of(t) == 0]:
        bb = bb.evict(t)
    rrouter = BankRouter(bb, metrics=reg)
    moves, reb_s = timed(lambda: rrouter.rebalance(threshold=1))
    occ = rrouter.bank.shard_occupancy()
    print(f"[sharded] rebalance after emptying shard 0: {moves} moves in {reb_s * 1e3:.1f} ms, "
          f"occupancy {occ.tolist()}")
    check(moves > 0 and occ.max() - occ.min() <= 1, f"rebalance left occupancy {occ}")
    with tempfile.TemporaryDirectory() as cold:
        tb = TieredBank(rrouter.bank, cold)
        t_out = tb.hot_tenants[0]
        before = GP.from_state(tb.bank.state(t_out))
        tb.evict_to_cold(t_out)
        least = int(np.argmin(tb.bank.shard_occupancy()))
        _, page_s = timed(lambda: tb.page_in(t_out))
        mu_p, var_p = tb.bank.mean_var([t_out] * 256, Xq9[:256])
        mu_c, var_c = before.mean_var(Xq9[:256])
        print(f"[sharded] page-in of tenant {t_out}: {page_s * 1e3:.2f} ms, onto shard "
              f"{tb.bank.shard_of(t_out)} (least loaded: {least})")
        check(tb.bank.shard_of(t_out) == least, "the page-in missed the least-loaded shard")
        compare("paged-in tenant vs its session before the page-out", [mu_p, var_p],
                [mu_c, var_c],
                rtol=0.0, atol=1e-5, why="tests/test_lifecycle.py:277 gate")
    report["sharded"] = {
        "fit_s": t_sh, "fit_2d_s": t_2d, "resident_fit_s": t_res, "from_bank_s": from_s,
        "fit_err": fit_err, "from_float64": from64, "rounds": rounds,
        "launches": loop_counts,
        "rebalance_moves": moves, "rebalance_ms": reb_s * 1e3, "page_in_ms": page_s * 1e3,
        "bucket_uses": dict(eng.bucket_uses)}
    del sh, router, eng, bb, rrouter, tb, Xb, yb
    torch.cuda.empty_cache()

    # (c) fit_distributed / predict_distributed at the Figure 1 point
    X0, y0, spec, Xq = main["X"], main["y"], main["spec"], main["Xq"]
    lmesh = make_local_mesh(data=S, devices=[dev] * S)
    M = fagp._idx_tensor(spec).shape[0]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (dst, d_counts), d_fit_s = timed(lambda: counted(lambda: dgp.fit_distributed(
        X0, y0, spec, lmesh)))
    d_peak = torch.cuda.max_memory_allocated() - held
    reckoned = S * M * M * 4
    (dmv, p_counts), d_pred_s = timed(lambda: counted(lambda: dgp.predict_distributed(
        Xq, dst, lmesh)))
    check(d_counts == launches(phi_gram={"moments": S}),
          f"fit_distributed launches {d_counts}: one fused fit per row shard")
    check(p_counts == launches({"": S}, diag_quad={"": S}),
          f"predict_distributed launches {p_counts}: a features and a diag-quad launch a shard")
    rst, r_fit_s = timed(lambda: fagp.fit(X0, y0, spec))
    mu_r, var_r = fagp.predict_mean_var(rst, Xq)
    backend = fagp.get_backend("pallas")
    idx = fagp._idx_tensor(spec)
    N_l = X0.shape[0] // S
    moments_ms = cuda_ms(lambda: [backend.moments(X0[s * N_l:(s + 1) * N_l],
                                                  y0[s * N_l:(s + 1) * N_l], spec, idx,
                                                  N_l // 16, None) for s in range(S)],
                         reps=3, warmup=1)
    print(f"[distributed] N={X0.shape[0]} M={M} over {S} row shards: fit_distributed "
          f"{d_fit_s:.4f} s (its {S} moment launches {moments_ms:.2f} ms, CUDA events); "
          f"resident fagp.fit {r_fit_s:.4f} s here, phase 3's fit_s {main['fit_s']:.4f} s; "
          f"predict_distributed {Xq.shape[0]} queries {d_pred_s:.4f} s; peak "
          f"{d_peak / 1e9:.3f} GB above the {held / 1e9:.3f} GB held ({S} partial G of "
          f"{M * M * 4 / 1e6:.0f} MB reckoned: {reckoned / 1e9:.3f} GB)")
    check(d_peak >= reckoned, "fit_distributed's peak is below its partial moments'")
    compare("fit_distributed u vs resident fit", [dst.u], [rst.u], rtol=5e-3, atol=1e-4,
            why="tests/test_distributed.py:51 u gate")
    compare("predict_distributed mean vs resident", [dmv[0]], [mu_r], rtol=1e-3, atol=1e-4,
            why="tests/test_distributed.py:55 mean gate")
    compare("predict_distributed variance vs resident", [dmv[1]], [var_r], rtol=5e-3,
            atol=1e-6, why="tests/test_distributed.py:57 variance gate")
    # a float64 fit of the same rows: where each float32 fit's u and mean sit
    sp64 = dataclasses.replace(spec, eps=spec.eps.double(), rho=spec.rho.double(),
                               noise=spec.noise.double())
    exp = get_expansion(spec.expansion)
    d64 = torch.exp(0.5 * exp.log_eigenvalues(idx, sp64))
    G64 = torch.zeros((M, M), dtype=torch.float64, device=dev)
    b64 = torch.zeros(M, dtype=torch.float64, device=dev)
    for lo in range(0, X0.shape[0], 2500):
        Ph = exp.features(X0[lo:lo + 2500].double(), idx, sp64)
        G64 += Ph.T @ Ph
        b64 += Ph.T @ y0[lo:lo + 2500].double()
        del Ph
    G64 = torch.eye(M, dtype=torch.float64, device=dev) + d64[:, None] * G64 * d64[None, :] \
        / sp64.noise**2
    L64 = torch.linalg.cholesky(G64)
    del G64
    u64 = d64 * torch.cholesky_solve((d64 * b64)[:, None], L64)[:, 0] / sp64.noise**2
    m64 = exp.features(Xq.double(), idx, sp64) @ u64
    f64 = {name: {"u": float((st.u.double() - u64).abs().max()),
                  "mean": float((m.double() - m64).abs().max())}
           for name, st, m in (("resident", rst, mu_r), ("distributed", dst, dmv[0]))}
    print(f"[distributed] from a float64 fit of the same rows: {json.dumps(f64)}")
    del L64, u64, m64, b64
    report["distributed"] = {
        "fit_s": d_fit_s, "moments_ms": moments_ms, "resident_fit_s": r_fit_s,
        "phase3_fit_s": main["fit_s"], "predict_s": d_pred_s, "peak_bytes": d_peak,
        "reckoned_partial_bytes": reckoned, "from_float64": f64}
    del dst, rst, dmv
    torch.cuda.empty_cache()
    # and at tests/test_distributed.py's own shape: N = 512, p = 2, n = 8 over
    # 8 row shards (a (data 2, model 4) mesh of this card)
    Xj, yj, Xsj, _ = make_gp_dataset(512, 2, seed=0, device=dev)
    sj = GPSpec.create(8, eps=np.full(2, 0.8, np.float32), rho=2.0, noise=0.05,
                       backend="pallas", device=dev)
    jmesh = make_local_mesh(data=2, model=4, devices=[dev] * 8)
    stj, dstj = fagp.fit(Xj, yj, sj), dgp.fit_distributed(Xj, yj, sj, jmesh)
    mj, vj = dgp.predict_distributed(Xsj, dstj, jmesh)
    mr, vr = fagp.predict_mean_var(stj, Xsj)
    compare("fit_distributed u vs resident at the JAX test's shape (512 x 2, n = 8, 8 shards)",
            [dstj.u], [stj.u], rtol=5e-3, atol=1e-4, why="tests/test_distributed.py:51 u gate")
    compare("predict_distributed mean vs resident at the JAX test's shape", [mj],
            [mr], rtol=1e-3, atol=1e-4, why="tests/test_distributed.py:55 mean gate")
    compare("predict_distributed variance vs resident at the JAX test's shape", [vj], [vr],
            rtol=5e-3, atol=1e-6, why="tests/test_distributed.py:57 variance gate")

    # (d) distinct cards
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"[phase 11d] skipped: the shards on distinct cards and the launch guard's "
              f"card tests need 2 or more cards, {n_cards} visible")
    else:
        report["distinct_cards"] = phase11d(dev, fspec, compare, main, n_cards, Xq9, ten9)
    report["seconds"] = time.perf_counter() - t_phase
    print("[phase 11] " + json.dumps(report))
    print(f"[phase 11] took {report['seconds']:.1f} s")
    return report


def phase11d(dev, fspec, compare, main, n_cards, Xq9, ten9) -> dict:
    """Phase 11 (d): a fleet sharded over min(4, cards) distinct cards
    serves as over one card (1e-5), the row-sharded fit over them equals
    the one-card schedule (1e-6), and ``tests/test_torch_multicard.py``
    (each kernel launched on cuda:1 while cuda:0 is current, bitwise)."""
    import numpy as np
    import torch

    from repro_torch.bank import GPBank, ShardedGPBank
    from repro_torch.core import distributed as dgp
    from repro_torch.launch.mesh import make_bank_mesh, make_local_mesh
    from repro_torch.launch.serve_gp import fleet_dataset

    S = min(SHARDS, n_cards)
    P = PIPE
    _, Xb, yb, _ = fleet_dataset(
        np.random.default_rng(P["seed"]), tenants=P["tenants"], n_train=P["n_train"],
        p=P["p"], rounds=P["rounds"], observations_per_round=P["observations_per_round"],
        noise=P["noise"], seed=P["seed"])
    rb = GPBank.fit(torch.from_numpy(Xb), torch.from_numpy(yb), fspec)
    answers = []
    for mesh in (make_bank_mesh(S), make_bank_mesh(S, devices=[dev] * S)):
        answers.append([t.cpu() for t in ShardedGPBank.fit(
            torch.from_numpy(Xb), torch.from_numpy(yb), fspec, mesh).mean_var(ten9, Xq9)])
    compare(f"ShardedGPBank.fit over {S} cards vs over one card", answers[0], answers[1],
            rtol=0.0, atol=1e-5, why="tests/test_shard_bank.py:82-84 gate")
    shd = ShardedGPBank.from_bank(rb, make_bank_mesh(S), pad_capacity=True)
    compare(f"from_bank over {S} cards vs resident", [t.cpu() for t in shd.mean_var(ten9, Xq9)],
            [t.cpu() for t in rb.mean_var(ten9, Xq9)], rtol=0.0, atol=1e-5,
            why="tests/test_shard_bank.py:82-84 gate")
    del shd, rb
    fits = []
    for devices in (None, [dev] * S):
        mesh = make_local_mesh(data=S, devices=devices)
        st = dgp.fit_distributed(main["X"], main["y"], main["spec"], mesh)
        fits.append([st.u.cpu()] + [t.cpu() for t in dgp.predict_distributed(
            main["Xq"], st, mesh)])
        del st
    compare(f"fit_distributed over {S} cards vs over one card (u, mean, variance)",
            fits[0], fits[1], rtol=0.0, atol=1e-6, why="the same sums in the same order")
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                        str(ROOT / "tests" / "test_torch_multicard.py")],
                       capture_output=True, text=True, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    print(f"[phase 11d] tests/test_torch_multicard.py rc={r.returncode}: "
          f"{r.stdout.strip().splitlines()[-1] if r.stdout.strip() else r.stderr[-500:]}")
    check(r.returncode == 0, "the launch guard's card tests failed:\n" + r.stdout[-3000:])
    return {"cards": S}


def graph_device_ms(fn, replays: int = 5) -> float:
    """The device's time for ``fn``'s work without the host between its
    launches: one call captured in a CUDA graph (after two warm calls on
    a side stream), the replays timed with CUDA events, median."""
    import torch

    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
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
            times.append(start.elapsed_time(end))
        del g
    return statistics.median(times)


def sync_s(fn):
    """(``fn()``, the wall seconds it took between two synchronisations of
    the card)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def nparams(params) -> int:
    return sum(p.numel() for p in params.parameters())


def card_vs_cpu(dev, compare, tag, cfg_a, cut: str, D, rng, *, prepare=None,
                watch=lambda name: False) -> dict:
    """(a) of phases 16 and 17 for one config cut in depth (full width, no
    remat): weights drawn on the card at ``D["seed"]`` (``prepare(params)``
    edits them in place) and copied to the CPU, in bfloat16 and float32;
    the prefill of a ``cpu_batch`` x ``cpu_prompt`` prompt from ``rng``
    (with the family's extras, drawn next) and ``cpu_steps`` decode steps
    on the CPU's greedy tokens, then the loss and every gradient entry at
    ``cpu_loss_batch`` x ``cpu_loss_seq``: the card's logits, loss and
    gradients each within twice the CPU's own bfloat16-vs-float32
    distance.  The gradient leaves that ``watch`` names must not be zero;
    the final cache entries named ``*ssm*`` are reported card vs CPU and
    CPU float32 vs bfloat16."""
    import copy

    import torch

    from repro_torch.launch import serve as tserve
    from repro_torch.models import get_model
    from repro_torch.models import lm as tlm

    t_a = time.perf_counter()
    m_a, m_a32 = get_model(cfg_a), get_model(dataclasses.replace(cfg_a, dtype="float32"))
    t0 = time.perf_counter()
    card_p = m_a.init_params(D["seed"], device=dev)
    if prepare is not None:
        prepare(card_p)
    cpu_p = copy.deepcopy(card_p).to("cpu")
    cpu_p32 = copy.deepcopy(cpu_p).float()
    init_s = time.perf_counter() - t0
    n_a = nparams(cpu_p)
    toks = torch.from_numpy(rng.integers(0, cfg_a.vocab, size=(D["cpu_batch"], D["cpu_prompt"])))
    extras = tserve.draw_extras(cfg_a, D["cpu_batch"], rng)
    cap = D["cpu_prompt"] + D["cpu_steps"]

    def on(ex, d):
        return {k: v.to(d) for k, v in ex.items()}

    @torch.no_grad()
    def run(model, params, feed):
        """Prefill, then one decode step per token of ``feed`` (None: the
        run's own greedy tokens): (logits per step, tokens fed, the final
        SSM states)."""
        d = params.device
        logits, cache = model.prefill(params, {"tokens": toks.to(d), **on(extras, d)},
                                      cache_len=cap)
        out, fed = [logits.float().cpu()], []
        for i in range(D["cpu_steps"]):
            tok = (torch.argmax(logits, -1)[:, None] if feed is None else feed[i].to(d))
            fed.append(tok.cpu())
            logits, cache = model.decode_step(
                params, {"token": tok, "pos": D["cpu_prompt"] + i}, cache)
            out.append(logits.float().cpu())
        return out, fed, {k: v.float().cpu() for k, v in cache.items() if "ssm" in k}

    t0 = time.perf_counter()
    ref, fed, st_cpu = run(m_a, cpu_p, None)
    t1 = time.perf_counter()
    ref32, _, st_32 = run(m_a32, cpu_p32, fed)
    serve_cpu_s = (t1 - t0, time.perf_counter() - t1)
    got, _, st_card = run(m_a, card_p, fed)
    bf16_vs_f32 = max(float((a - b).abs().max()) for a, b in zip(ref, ref32))
    serve_err = compare(
        f"{cfg_a.arch_id} card vs CPU (cut to {cut}; prefill of {D['cpu_batch']} x "
        f"{D['cpu_prompt']} + {D['cpu_steps']} decode steps on the CPU's greedy tokens, "
        f"logits)", got, ref, rtol=0.0, atol=2.0 * bf16_vs_f32,
        why=f"twice the CPU's bfloat16-vs-float32 distance, {bf16_vs_f32:.4e}")
    states = {k: (float((st_card[k] - st_cpu[k]).abs().max()),
                  float((st_32[k] - st_cpu[k]).abs().max())) for k in st_cpu}
    del got, ref, ref32
    ltoks = torch.from_numpy(rng.integers(0, cfg_a.vocab, size=(D["cpu_loss_batch"],
                                                                 D["cpu_loss_seq"])))
    lextras = tserve.draw_extras(cfg_a, D["cpu_loss_batch"], rng)

    def loss_grads(model, params):
        d = params.device
        with tlm.trainable(params):
            loss, _ = model.loss_fn(params, {"tokens": ltoks.to(d), **on(lextras, d)})
            named = tlm.leaves(params)
            grads = torch.autograd.grad(loss, list(named.values()))
        sq = torch.zeros((), dtype=torch.float32, device=d)
        for g in grads:
            sq = sq + torch.sum(torch.square(g.float()))
        return (float(loss.detach()), float(torch.sqrt(sq))), dict(zip(named, grads))

    def grad_dist(ga, gb):
        return max(float((ga[k].to(dev).float() - gb[k].to(dev).float()).abs().max())
                   for k in ga)

    t0 = time.perf_counter()
    l_cpu, g_cpu = loss_grads(m_a, cpu_p)
    t1 = time.perf_counter()
    l_32, g_32 = loss_grads(m_a32, cpu_p32)
    loss_cpu_s = (t1 - t0, time.perf_counter() - t1)
    grad_bf16_vs_f32 = grad_dist(g_cpu, g_32)
    del g_32
    l_card, g_card = loss_grads(m_a, card_p)
    grad_err = grad_dist(g_card, g_cpu)
    moved = {k: float(g_card[k].float().abs().max()) for k in g_card if watch(k)}
    check(all(v > 0 for v in moved.values()), f"(a) {cfg_a.arch_id}: zero gradients: {moved}")
    del g_card, g_cpu
    check(all(math.isfinite(v) for v in l_card), "(a) the card's loss and grad norm finite")
    loss_gap, loss_gap32 = abs(l_card[0] - l_cpu[0]), abs(l_cpu[0] - l_32[0])
    check(loss_gap <= 2.0 * loss_gap32,
          f"(a) {cfg_a.arch_id}: card loss {loss_gap:.3e} from the CPU's, over twice its "
          f"bf16-vs-f32 {loss_gap32:.3e}")
    ok = grad_err <= 2.0 * grad_bf16_vs_f32
    print(f"[check] {cfg_a.arch_id} gradients card vs CPU (cut to {cut}, "
          f"{D['cpu_loss_batch']} x {D['cpu_loss_seq']} tokens, every leaf): "
          f"max_abs_err={grad_err:.3e} tol=rtol 0, atol {2.0 * grad_bf16_vs_f32:g} (twice the "
          f"CPU's bfloat16-vs-float32 distance, {grad_bf16_vs_f32:.4e}); worst error/tolerance "
          f"{grad_err / (2.0 * grad_bf16_vs_f32):.3f} -> {'ok' if ok else 'FAIL'}")
    check(ok, f"(a) {cfg_a.arch_id}: the card's gradients disagree with the CPU's")
    rec = {"cut": cut, "params": n_a, "serve_max_abs_err": serve_err,
           "serve_cpu_bf16_vs_f32": bf16_vs_f32,
           "loss": {"card": l_card, "cpu": l_cpu, "cpu_f32": l_32},
           "loss_gap": (loss_gap, loss_gap32), "grad_max_abs_err": (grad_err, grad_bf16_vs_f32),
           "grad_max_watched": moved, "ssm_state_card_vs_cpu_and_f32_vs_bf16": states,
           "init_and_copies_s": init_s, "serve_cpu_bf16_s": serve_cpu_s[0],
           "serve_cpu_f32_s": serve_cpu_s[1], "loss_cpu_bf16_s": loss_cpu_s[0],
           "loss_cpu_f32_s": loss_cpu_s[1], "seconds": time.perf_counter() - t_a}
    st = (f"; final SSM states card vs CPU / CPU f32 vs bf16 "
          f"{ {k: tuple(round(x, 5) for x in v) for k, v in states.items()} }" if states else "")
    print(f"[phase {tag}] (a) {cfg_a.arch_id} cut to {cut} ({n_a / 1e9:.3f}e9 parameters): "
          f"loss card {l_card[0]:.6f} cpu {l_cpu[0]:.6f} cpu-f32 {l_32[0]:.6f}; grad norm "
          f"card {l_card[1]:.6f} cpu {l_cpu[1]:.6f} cpu-f32 {l_32[1]:.6f}{st}; on the CPU "
          f"({torch.get_num_threads()} threads) prefill + decode bf16 {serve_cpu_s[0]:.1f} s "
          f"f32 {serve_cpu_s[1]:.1f} s, loss and gradients bf16 {loss_cpu_s[0]:.1f} s f32 "
          f"{loss_cpu_s[1]:.1f} s; took {rec['seconds']:.1f} s")
    del cpu_p, cpu_p32, card_p
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def restart_bitwise(tag, label: str, D, fresh, tops=None) -> dict:
    """(d) of phases 14-17: with ``fresh()`` -> (params, AdamW state, step
    function, batch function) on the card, two straight ``ckpt_steps``-step
    runs through ``train_loop``; a run of ``ckpt_at`` steps writing a
    checkpoint every ``ckpt_every`` (async, the last sync), its async one
    restored into a fresh model against a straight ``ckpt_every``-step run;
    a fresh model resumed from it to ``ckpt_steps`` against the straight
    runs: each bitwise, or the phase fails.  ``tops``, where given, is the
    checkpoint's set of top-level parameter names."""
    import torch

    from repro_torch import checkpoint as tckpt
    from repro_torch.models import convert
    from repro_torch.models import lm as tlm
    from repro_torch.runtime import TrainLoopConfig, train_loop

    n, at, every = D["ckpt_steps"], D["ckpt_at"], D["ckpt_every"]

    def host(params):
        return [t.detach().float().cpu() for t in tlm.leaves(params).values()]

    def loop(n_steps, ckpt_dir=None, every=every, run=None):
        p, o, step, batch = run or fresh()
        return train_loop(step, p, o, batch,
                          TrainLoopConfig(steps=n_steps, ckpt_dir=ckpt_dir, ckpt_every=every,
                                          log_every=1000, handle_signals=False),
                          log_fn=lambda s: None)

    t0 = time.perf_counter()
    straight = [host(loop(n)[0]) for _ in range(2)]
    straight_s = time.perf_counter() - t0
    bitwise = all(torch.equal(a, b) for a, b in zip(*straight))
    check(bitwise, f"(d) {label}: two straight runs on the card are not bitwise equal")
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        loop(at, td)                                  # async at step 3, sync at 5
        first_s = time.perf_counter() - t0
        check(tckpt.latest_step(td) == at, f"(d) {label}: the checkpoint of step {at}")
        ckpt_bytes = sum(f.stat().st_size for f in Path(td).rglob("*") if f.is_file())
        run3 = fresh()
        loop(every, run=run3)
        keys = convert.train_state_keys(run3[0])
        check(tops is None or set(keys["params"]) == tops,
              f"(d) {label}: the checkpoint's tree: {sorted(keys['params'])}")
        _, tree3 = tckpt.restore(td, keys, step=every, device="cpu")
        p_chk, o_chk = fresh()[:2]
        convert.load_train_state(p_chk, o_chk, tree3)
        async_bitwise = all(torch.equal(a, b) for a, b in zip(host(p_chk), host(run3[0])))
        del tree3, run3, p_chk, o_chk
        t0 = time.perf_counter()
        resumed, _, rep_d = loop(n, td, every=n)      # writes step 10 only
        resume_s = time.perf_counter() - t0
        check(rep_d["final_step"] == n, f"(d) {label}: the resumed run reached step {n}")
        got = host(resumed)
        del resumed
    resume_bitwise = all(torch.equal(a, b) for a, b in zip(got, straight[0]))
    check(resume_bitwise, f"(d) {label}: the resumed run is not bitwise the straight run")
    check(async_bitwise, f"(d) {label}: the async step-{every} checkpoint is not bitwise a "
                         f"straight {every}-step run")
    print(f"[phase {tag}] restart ({label}): two straight {n}-step runs bitwise {bitwise} "
          f"({straight_s:.1f} s); {at} steps, a fresh model restored, {n - at} more = straight "
          f"bitwise {resume_bitwise}; the async step-{every} checkpoint = a straight "
          f"{every}-step run bitwise {async_bitwise}; the checkpoints of steps {every} and "
          f"{at} {ckpt_bytes / 1e9:.3f} GB; {at} steps and both writes {first_s:.1f} s; the "
          f"restore, {n - at} steps and the write of step {n} {resume_s:.1f} s")
    del straight, got
    gc.collect()
    torch.cuda.empty_cache()
    return {"straight_bitwise": bitwise, "resume_bitwise": resume_bitwise,
            "async_ckpt_bitwise": async_bitwise, "ckpt_bytes_both": ckpt_bytes,
            "straight_two_runs_s": straight_s, "first_half_s": first_s, "resume_s": resume_s}


# phase 12, ROADMAP A8 (dense serving): qwen2-1.5b at full width
# (repro_torch/configs/qwen2_1p5b.py: 28 layers, d_model 1,536, 12/2 heads
# of 128, d_ff 8,960, vocab 151,936, bfloat16, tied embeddings), random
# weights from a seed; (a) cut to 2 layers for the card-against-CPU check,
# (b) whole at the reference serve.py's defaults, (c) a 4,096-token prompt
LM = dict(arch="qwen2-1.5b", cpu_layers=2, cpu_batch=2, cpu_prompt=64, cpu_steps=8,
          batch=4, prompt_len=64, gen=32, long_prompt=4096, seed=0)
PEAK_BF16 = 989e12    # FLOP/s, H100 SXM bfloat16 tensor cores, dense


def phase12(dev, smi, compare) -> dict:
    """The LM half's dense serving path on the card: (a) card against the
    port's CPU run at full width cut to 2 layers (prefill logits and 8
    decode steps on the CPU's greedy tokens; gate: twice the CPU's own
    bfloat16-vs-float32 distance); (b) the 28-layer model through
    ``serve`` (prefill ms first and warm, decode ms a token, tok/s, peak
    bytes beside the bounds), the reference test's prefill/decode
    consistency (rtol = atol = 0.15) and finite logits; (c) a 4,096-token
    prompt through the chunked (flash) attention route in every layer, one
    layer's flash output against the simple route in float32
    (tests/test_layers.py's 2e-4 / 2e-5), the long prefill timed."""
    import copy

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve as tserve
    from repro_torch.models import get_model
    from repro_torch.models import layers as tl
    from repro_torch.models import lm as tlm

    t_phase = time.perf_counter()
    cfg = ARCHS[LM["arch"]].CONFIG
    check(cfg.n_layers == 28 and cfg.d_model == 1536 and cfg.vocab == 151936
          and cfg.dtype == "bfloat16", "phase 12 runs qwen2-1.5b's full configuration")
    report = {"card": smi}
    print(f"[phase 12] {smi}: {cfg.arch_id}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {cfg.dtype}")

    device_ms = graph_device_ms

    # -- (a) the card against the port's CPU run, 2 layers at full width --------
    cfg2 = dataclasses.replace(cfg, n_layers=LM["cpu_layers"])
    m2, m2_32 = get_model(cfg2), get_model(dataclasses.replace(cfg2, dtype="float32"))
    cpu_p = m2.init_params(torch.Generator().manual_seed(LM["seed"]))
    cpu_p32 = copy.deepcopy(cpu_p).float()          # the same values in float32
    card_p = copy.deepcopy(cpu_p).to(dev)
    rng = np.random.default_rng(LM["seed"])
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(LM["cpu_batch"],
                                                             LM["cpu_prompt"])))
    cap = LM["cpu_prompt"] + LM["cpu_steps"]

    @torch.no_grad()
    def run(model, params, feed):
        """Prefill, then one decode step per token of ``feed`` (None: the
        run's own greedy tokens); returns (logits per step, tokens fed)."""
        d = params.device
        logits, cache = model.prefill(params, {"tokens": toks.to(d)}, cache_len=cap)
        out, fed = [logits.float().cpu()], []
        for i in range(LM["cpu_steps"]):
            tok = (torch.argmax(logits, -1)[:, None] if feed is None else feed[i].to(d))
            fed.append(tok.cpu())
            logits, cache = model.decode_step(params, {"token": tok,
                                                       "pos": LM["cpu_prompt"] + i}, cache)
            out.append(logits.float().cpu())
        return out, fed

    t0 = time.perf_counter()
    ref, fed = run(m2, cpu_p, None)
    ref32, _ = run(m2_32, cpu_p32, fed)
    cpu_s = time.perf_counter() - t0
    got, _ = run(m2, card_p, fed)
    bf16_vs_f32 = max(float((a - b).abs().max()) for a, b in zip(ref, ref32))
    card_err = compare(
        f"LM card vs CPU ({cfg.arch_id} cut to {LM['cpu_layers']} layers, prefill + "
        f"{LM['cpu_steps']} decode steps on the CPU's greedy tokens, logits)",
        got, ref, rtol=0.0, atol=2.0 * bf16_vs_f32,
        why=f"twice the CPU's bfloat16-vs-float32 distance, {bf16_vs_f32:.4e}")
    report["card_vs_cpu"] = {"max_abs_err": card_err, "cpu_bf16_vs_f32": bf16_vs_f32,
                             "cpu_s": cpu_s}
    del cpu_p, cpu_p32, card_p, got, ref, ref32
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) the 28-layer model as serve drives it ------------------------------
    param_bytes = 2 * cfg.param_count()
    # the prefill's products: each token through every matrix but the
    # embedding (a gather, and untied, the unembedding too), the unembedding
    # for the last token only, and each layer's two S x S attention products
    # (the simple route forms them whole, the causal mask applied after)
    B_, S_ = LM["batch"], LM["prompt_len"]
    emb = cfg.vocab * cfg.d_model
    flops_prefill = (2.0 * (cfg.param_count() - emb * (1 if cfg.tie_embeddings else 2))
                     * B_ * S_ + 2.0 * emb * B_
                     + 4.0 * cfg.n_layers * B_ * cfg.n_heads * S_ * S_ * cfg.head_dim)
    bound_decode_ms = param_bytes / PEAK_BYTES * 1e3
    bound_prefill_ms = flops_prefill / PEAK_BF16 * 1e3
    base = torch.cuda.memory_allocated()     # what the earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    served = tserve.serve(LM["arch"], smoke=False, batch=LM["batch"],
                          prompt_len=LM["prompt_len"], gen=LM["gen"], seed=LM["seed"])
    serve_peak = torch.cuda.max_memory_allocated() - base
    check(served["generated"].shape == (LM["batch"], LM["gen"])
          and ((served["generated"] >= 0) & (served["generated"] < cfg.vocab)).all(),
          "serve's generated tokens")
    torch.cuda.empty_cache()
    model = get_model(cfg)
    params = model.init_params(LM["seed"], device=dev)
    held = sum(p.numel() * p.element_size() for p in params.parameters())
    toks = torch.from_numpy(np.random.default_rng(LM["seed"]).integers(
        0, cfg.vocab, size=(LM["batch"], LM["prompt_len"] + 1))).to(dev)
    cap = LM["prompt_len"] + LM["gen"]
    with torch.no_grad():
        pre_s = []
        for _ in range(6):
            (logits, cache), s_ = sync_s(lambda: model.prefill(
                params, {"tokens": toks[:, :LM["prompt_len"]]}, cache_len=cap))
            pre_s.append(s_)
        tok = torch.argmax(logits, -1)[:, None]
        dec_s = []
        for i in range(LM["gen"]):
            (logits_d, cache), s_ = sync_s(lambda: model.decode_step(
                params, {"token": tok, "pos": LM["prompt_len"] + i}, cache))
            dec_s.append(s_)
            tok = torch.argmax(logits_d, -1)[:, None]
        # tests/test_arch_smoke.py:65-83 at full width: prefill(S) + decode(S)
        # against prefill(S + 1)
        lp, c1 = model.prefill(params, {"tokens": toks[:, :LM["prompt_len"]]},
                               cache_len=LM["prompt_len"] + 1)
        ld, _ = model.decode_step(params, {"token": toks[:, LM["prompt_len"]:],
                                           "pos": LM["prompt_len"]}, c1)
        lf, _ = model.prefill(params, {"tokens": toks})
    check(all(bool(torch.isfinite(t).all()) for t in (logits, logits_d, lp, ld, lf)),
          "non-finite LM logits")
    compare(f"LM prefill({LM['prompt_len']}) + decode_step vs prefill({LM['prompt_len'] + 1}) "
            f"(last-token logits, {cfg.n_layers} layers)", [ld], [lf], rtol=0.15, atol=0.15,
            why="tests/test_arch_smoke.py:81-83 gate")
    warm_prefill_ms = statistics.median(pre_s[1:]) * 1e3
    warm_decode_ms = statistics.median(dec_s) * 1e3
    # the device's share: the same step and prefill replayed from a CUDA
    # graph (the decode rewrites cache position 64 each time)
    dec_dev = device_ms(lambda: model.decode_step(
        params, {"token": tok, "pos": LM["prompt_len"]}, cache))
    pre_dev = device_ms(lambda: model.prefill(
        params, {"tokens": toks[:, :LM["prompt_len"]]}, cache_len=cap))
    report["serve"] = {
        "batch": LM["batch"], "prompt_len": LM["prompt_len"], "gen": LM["gen"],
        "prefill_first_ms": served["prefill_s"] * 1e3, "prefill_warm_ms": warm_prefill_ms,
        "decode_ms_per_token": served["decode_s_per_token"] * 1e3,
        "decode_warm_median_ms": warm_decode_ms, "tokens_per_s": served["tokens_per_s"],
        "decode_device_ms": dec_dev, "prefill_device_ms": pre_dev,
        "decode_idle_share": 1.0 - dec_dev / warm_decode_ms,
        "prefill_idle_share": 1.0 - pre_dev / warm_prefill_ms,
        "param_count_bytes": param_bytes, "param_bytes_held": held, "peak_bytes": serve_peak,
        "held_before_bytes": base,
        "bound_decode_ms": bound_decode_ms, "prefill_tflop": flops_prefill / 1e12,
        "bound_prefill_ms": bound_prefill_ms}
    print(f"[phase 12] {smi}: serve({LM['arch']}, batch {LM['batch']}, prompt "
          f"{LM['prompt_len']}, gen {LM['gen']}): prefill {served['prefill_s'] * 1e3:.2f} ms "
          f"first, {warm_prefill_ms:.2f} ms warm (bound {bound_prefill_ms:.3f} ms: "
          f"{flops_prefill / 1e12:.3f} TFLOP at 989 TFLOP/s); decode "
          f"{served['decode_s_per_token'] * 1e3:.3f} ms a token in serve, "
          f"{warm_decode_ms:.3f} ms warm median a step (bound {bound_decode_ms:.3f} ms: "
          f"{param_bytes / 1e9:.3f} GB of parameters at 3.35 TB/s); "
          f"{served['tokens_per_s']:.1f} tok/s; peak {serve_peak / 1e9:.3f} GB "
          f"above the {base / 1e9:.3f} GB held before it (parameters held {held / 1e9:.3f} "
          f"GB); device time from a CUDA graph: decode "
          f"step {dec_dev:.3f} ms (idle {100 * (1 - dec_dev / warm_decode_ms):.1f}% of the "
          f"eager step), prefill {pre_dev:.3f} ms (idle "
          f"{100 * (1 - pre_dev / warm_prefill_ms):.1f}%)")

    # -- (c) the flash route at full width --------------------------------------
    long = torch.from_numpy(np.random.default_rng(LM["seed"] + 1).integers(
        0, cfg.vocab, size=(1, LM["long_prompt"]))).to(dev)
    routes = []
    orig_flash, orig_simple = tl._attention_flash, tl._attention_simple

    def spy(name, fn):
        def call(*a, **kw):
            routes.append(name)
            return fn(*a, **kw)
        return call

    tl._attention_flash = spy("flash", orig_flash)
    tl._attention_simple = spy("simple", orig_simple)
    try:
        with torch.no_grad():
            long_s = [sync_s(lambda: model.prefill(params, {"tokens": long}))[1]
                      for _ in range(3)]
    finally:
        tl._attention_flash, tl._attention_simple = orig_flash, orig_simple
    check(routes == ["flash"] * (3 * cfg.n_layers),
          f"the {LM['long_prompt']}-token prefill took the flash route in every layer")
    long_dev = device_ms(lambda: model.prefill(params, {"tokens": long}), replays=3)
    with torch.no_grad():
        lp0 = params.blocks[0]
        x = tlm._embed(params, long, cfg)
        hn = tl.rmsnorm(x, lp0["ln1"], cfg.norm_eps)
        q, k, v = tl._project_qkv(lp0["attn"], hn, hn, cfg)
        pos = torch.arange(LM["long_prompt"], device=dev)
        q, k = tl.rope(q, pos, cfg.rope_theta), tl.rope(k, pos, cfg.rope_theta)
        q, k, v = q.float(), k.float(), v.float()
        qg = q.reshape(1, LM["long_prompt"], cfg.n_kv_heads, -1, cfg.head_dim)
        kw = dict(causal=True, window=0, kv_valid_len=None, softcap=0.0)
        (flash_out, flash_s) = sync_s(lambda: tl._attention_flash(qg, k, v, **kw))
        (simple_out, simple_s) = sync_s(lambda: tl._attention_simple(qg, k, v, q_offset=0,
                                                                     **kw))
    flash_err = compare(f"layer 0 attention, flash vs simple route ({LM['long_prompt']} "
                        f"tokens, float32)", [flash_out], [simple_out], rtol=2e-4, atol=2e-5,
                        why="tests/test_layers.py:38-41 gate")
    report["flash"] = {"prompt": LM["long_prompt"], "prefill_first_ms": long_s[0] * 1e3,
                       "prefill_warm_ms": statistics.median(long_s[1:]) * 1e3,
                       "prefill_device_ms": long_dev,
                       "layer0_flash_ms": flash_s * 1e3, "layer0_simple_ms": simple_s * 1e3,
                       "flash_vs_simple": flash_err}
    print(f"[phase 12] {smi}: {LM['long_prompt']}-token prefill (flash route, "
          f"{cfg.n_layers} layers): {long_s[0] * 1e3:.2f} ms first, "
          f"{statistics.median(long_s[1:]) * 1e3:.2f} ms warm, {long_dev:.2f} ms of device "
          f"time (CUDA graph); layer 0 attention in float32: "
          f"flash {flash_s * 1e3:.2f} ms, simple {simple_s * 1e3:.2f} ms")
    del params, model, cache, c1, flash_out, simple_out
    gc.collect()
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    print("[phase 12] " + json.dumps(report))
    print(f"[phase 12] took {report['seconds']:.1f} s")
    return report


# phase 13, ROADMAP A8's training part: qwen2-1.5b at full width; (a) and
# (c) cut to 2 layers (as phase 12(a)), (b) uncut at batch 4 x 1,024, the
# schedule launch/train.py builds (warmup_cosine(lr, 20, 10_000)); (a)'s
# steps at batch 1 x 128 (at 2 x 128 the CPU's bf16 and float32 steps took
# most of the phase's 80-105 s, and the script neared its time limit)
TRAIN = dict(cpu_layers=2, cpu_batch=1, cpu_seq=128, cpu_steps=3, batch=4, seq=1024,
             steps=20, ckpt_steps=10, ckpt_at=5, ckpt_every=3, lr=3e-4, seed=0)


def phase13(dev, smi, compare) -> dict:
    """The LM half's training path on the card: (a) 3 train steps of the
    2-layer cut on the card and on the CPU from the same weights (losses
    and grad norms of both printed; gate on the parameters after step 3:
    twice the CPU's own bfloat16-vs-float32 distance); (b) the 28-layer
    model through ``launch.train.build(smoke=False)`` and ``train_loop``,
    20 steps at batch 4 x 1,024, every loss and grad norm finite and the
    parameters moved (first step, warm median, tokens/s, peak memory,
    the bound); (c) checkpoint and restart on the 2-layer cut: 10 steps
    straight (twice) against 5 steps with an async write at step 3 and a
    synchronous one at step 5, a fresh model restored from step 5 and 5
    more steps; the step-3 checkpoint against a straight 3-step run."""
    import copy

    import numpy as np
    import torch

    from repro_torch import optim
    from repro_torch.configs import ARCHS
    from repro_torch.data import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import convert, get_model
    from repro_torch.models import lm as tlm
    from repro_torch.runtime import TrainLoopConfig, train_loop
    from repro_torch import checkpoint as tckpt

    t_phase = time.perf_counter()
    cfg = ARCHS[LM["arch"]].CONFIG
    check(cfg.n_layers == 28 and cfg.d_model == 1536 and cfg.vocab == 151936
          and cfg.dtype == "bfloat16" and cfg.remat and cfg.logits_chunk == 1024,
          "phase 13 trains qwen2-1.5b's full configuration")
    report = {"card": smi}
    ops.reset_launch_counts()
    ocfg = optim.AdamWConfig(lr=optim.warmup_cosine(TRAIN["lr"], 20, 10_000))
    cfg2 = dataclasses.replace(cfg, n_layers=TRAIN["cpu_layers"])
    m2 = get_model(cfg2)
    stream2 = TokenStream(vocab=cfg.vocab, seq=TRAIN["cpu_seq"], global_batch=TRAIN["cpu_batch"],
                          seed=TRAIN["seed"])

    def steps(model, params, n, opt=None, start=0):
        """``n`` train steps from ``start``; (params, opt, [(loss, grad
        norm)])."""
        opt = optim.init(tlm.leaves(params), ocfg) if opt is None else opt
        step = make_train_step(model, ocfg)
        out = []
        for s in range(start, start + n):
            _, opt, m = step(params, opt, stream2.batch(s, device=params.device))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return params, opt, out

    def host(params):
        return [t.detach().float().cpu() for t in tlm.leaves(params).values()]

    # -- (a) the card against the port's CPU run --------------------------------
    t0 = time.perf_counter()
    cpu_p = m2.init_params(torch.Generator().manual_seed(TRAIN["seed"]))
    cpu_p32 = copy.deepcopy(cpu_p).float()           # the same values in float32
    card_p = copy.deepcopy(cpu_p).to(dev)
    m2_32 = get_model(dataclasses.replace(cfg2, dtype="float32"))
    t1 = time.perf_counter()
    cpu_o, cpu_m = steps(m2, cpu_p, TRAIN["cpu_steps"])[1:]
    t2 = time.perf_counter()
    cpu32_o, cpu32_m = steps(m2_32, cpu_p32, TRAIN["cpu_steps"])[1:]
    cpu_s = time.perf_counter() - t0
    print(f"[phase 13] (a) on the CPU: init and copies {t1 - t0:.1f} s, 3 bfloat16 steps "
          f"{t2 - t1:.1f} s, 3 float32 steps {time.perf_counter() - t2:.1f} s "
          f"({torch.get_num_threads()} threads)")
    card_o, card_m = steps(m2, card_p, TRAIN["cpu_steps"])[1:]
    ref, ref32, got = host(cpu_p), host(cpu_p32), host(card_p)
    bf16_vs_f32 = max(float((a - b).abs().max()) for a, b in zip(ref, ref32))
    for i, (c, r, r32) in enumerate(zip(card_m, cpu_m, cpu32_m)):
        print(f"[phase 13] (a) step {i + 1}: loss card {c[0]:.6f} cpu {r[0]:.6f} cpu-f32 "
              f"{r32[0]:.6f}; grad norm card {c[1]:.6f} cpu {r[1]:.6f} cpu-f32 {r32[1]:.6f}")
    card_err = compare(
        f"LM train card vs CPU ({cfg.arch_id} cut to {TRAIN['cpu_layers']} layers, "
        f"{TRAIN['cpu_steps']} steps at {TRAIN['cpu_batch']} x {TRAIN['cpu_seq']}, every "
        f"parameter)", got, ref, rtol=0.0, atol=2.0 * bf16_vs_f32,
        why=f"twice the CPU's bfloat16-vs-float32 distance, {bf16_vs_f32:.4e}")
    loss_gap = max(abs(c[0] - r[0]) for c, r in zip(card_m, cpu_m))
    loss_gap32 = max(abs(r[0] - r32[0]) for r, r32 in zip(cpu_m, cpu32_m))
    report["card_vs_cpu"] = {"max_abs_err": card_err, "cpu_bf16_vs_f32": bf16_vs_f32,
                             "loss_card_vs_cpu": loss_gap, "loss_bf16_vs_f32": loss_gap32,
                             "card": card_m, "cpu": cpu_m, "cpu_f32": cpu32_m,
                             "cpu_s": cpu_s}
    check(loss_gap <= 2.0 * loss_gap32,
          f"(a) card loss {loss_gap:.3e} from the CPU's, over twice its bf16-vs-f32 "
          f"{loss_gap32:.3e}")
    del cpu_p, cpu_p32, card_p, cpu_o, cpu32_o, card_o, ref, ref32, got
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) the 28 layers through launch/train.py's build and train_loop ------
    B_, S_ = TRAIN["batch"], TRAIN["seq"]
    T_ = B_ * S_
    emb = cfg.vocab * cfg.d_model
    blocks = cfg.param_count() - emb * (1 if cfg.tie_embeddings else 2)
    # the products as the code runs them: forward, backward (twice the
    # forward), the blocks' remat forward and the loss chunk's recomputed
    # logits, in bfloat16 on the tensor cores; the attention's two S x S
    # products a layer are float32 (the simple route forms them whole)
    f_blocks, f_unembed = 2.0 * blocks * T_, 2.0 * emb * T_
    f_attn = 4.0 * cfg.n_layers * B_ * cfg.n_heads * S_ * S_ * cfg.head_dim
    bf16_flop = 4.0 * (f_blocks + f_unembed)
    f32_flop = 4.0 * f_attn
    bound_ms = (bf16_flop / PEAK_BF16 + f32_flop / PEAK_F32) * 1e3
    base = torch.cuda.memory_allocated()      # what the earlier phases still hold
    t0 = time.perf_counter()
    cfg_b, model, params, opt_state, step_fn, stream, extras, shardings = ttrain.build(
        LM["arch"], smoke=False, batch=B_, seq=S_, lr=TRAIN["lr"], seed=TRAIN["seed"],
        device=dev)
    check(cfg_b == cfg and shardings == (None, None), "(b) build's configuration")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - base
    watch = {k: v.detach().clone() for k, v in tlm.leaves(params).items()
             if k in ("final_norm", "blocks.0.ln1", "blocks.27.attn.bq", "blocks.27.mlp.wd")}
    emb_rows = params.tok_emb[:4096].detach().clone()
    t_batch = []
    for s in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stream.batch(s, extras, device=dev)
        torch.cuda.synchronize()
        t_batch.append(time.perf_counter() - t1)
    torch.cuda.reset_peak_memory_stats()
    params, opt_state, rep = train_loop(step_fn, params, opt_state,
                                        lambda s: stream.batch(s, extras, device=dev),
                                        TrainLoopConfig(steps=TRAIN["steps"], ckpt_dir=None,
                                                        log_every=1, handle_signals=False),
                                        log_fn=lambda s: None)
    peak = torch.cuda.max_memory_allocated() - base
    hist = rep["history"]
    check(len(hist) == TRAIN["steps"] and rep["final_step"] == TRAIN["steps"],
          "(b) ran every step")
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist),
          "(b) every loss and grad norm finite")
    moved = {k: not torch.equal(v, tlm.leaves(params)[k]) for k, v in watch.items()}
    moved["tok_emb[:4096]"] = not torch.equal(emb_rows, params.tok_emb[:4096])
    check(all(moved.values()), f"(b) the parameters moved: {moved}")
    secs = [h["sec_per_step"] for h in hist]
    warm = statistics.median(secs[1:])
    report["train"] = {
        "batch": B_, "seq": S_, "steps": TRAIN["steps"], "build_s": build_s,
        "first_step_s": secs[0], "warm_median_s": warm, "warm_min_s": min(secs[1:]),
        "warm_max_s": max(secs[1:]), "tokens_per_s": T_ / warm,
        "first_loss": hist[0]["loss"], "last_loss": hist[-1]["loss"],
        "grad_norms": [h["grad_norm"] for h in hist], "losses": [h["loss"] for h in hist],
        "batch_ms": statistics.median(t_batch) * 1e3, "stragglers": rep["stragglers"],
        "held_bytes": held, "peak_bytes": peak, "held_before_bytes": base,
        "bf16_tflop": bf16_flop / 1e12, "f32_tflop": f32_flop / 1e12, "bound_ms": bound_ms}
    print(f"[phase 13] {smi}: train({LM['arch']}, {cfg.n_layers} layers, batch {B_} x "
          f"{S_}, {TRAIN['steps']} steps): first step {secs[0]:.3f} s, warm median "
          f"{warm * 1e3:.1f} ms ({min(secs[1:]) * 1e3:.1f}-{max(secs[1:]) * 1e3:.1f}), "
          f"{T_ / warm:.0f} tokens/s; loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; "
          f"bound {bound_ms:.1f} ms ({bf16_flop / 1e12:.2f} TFLOP bf16 at 989 TFLOP/s + "
          f"{f32_flop / 1e12:.2f} TFLOP float32 attention at 67 TFLOP/s); model and AdamW "
          f"state held {held / 1e9:.3f} GB, the steps' peak {peak / 1e9:.3f} GB above the "
          f"{base / 1e9:.3f} GB held before (the batch alone {statistics.median(t_batch) * 1e3:.1f} "
          f"ms); built in {build_s:.1f} s")
    del params, opt_state, step_fn, model, watch, emb_rows
    gc.collect()
    torch.cuda.empty_cache()

    # -- (c) checkpoint and restart on the 2-layer cut ---------------------------
    n, at = TRAIN["ckpt_steps"], TRAIN["ckpt_at"]

    def fresh():
        p = m2.init_params(TRAIN["seed"], device=dev)
        return p, optim.init(tlm.leaves(p), ocfg)

    def loop(params, opt, n_steps, ckpt_dir=None, every=TRAIN["ckpt_every"]):
        return train_loop(make_train_step(m2, ocfg), params, opt,
                          lambda s: stream2.batch(s, device=dev),
                          TrainLoopConfig(steps=n_steps, ckpt_dir=ckpt_dir, ckpt_every=every,
                                          log_every=1000, handle_signals=False),
                          log_fn=lambda s: None)

    straight = [host(loop(*fresh(), n)[0]) for _ in range(2)]
    spread = max(float((a - b).abs().max()) for a, b in zip(*straight))
    bitwise = all(torch.equal(a, b) for a, b in zip(*straight))
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        loop(*fresh(), at, td)                        # async at step 3, sync at 5
        first_s = time.perf_counter() - t0
        check(tckpt.latest_step(td) == at, "(c) the checkpoint of step 5")
        ckpt_bytes = sum(f.stat().st_size for f in Path(td).rglob("*") if f.is_file())
        p3, o3 = fresh()
        steps(m2, p3, TRAIN["ckpt_every"], opt=o3)
        _, tree3 = tckpt.restore(td, convert.train_state_keys(p3), step=TRAIN["ckpt_every"],
                                 device="cpu")
        p_chk, o_chk = fresh()
        convert.load_train_state(p_chk, o_chk, tree3)
        async_err = max(float((a - b).abs().max()) for a, b in zip(host(p_chk), host(p3)))
        del tree3, p3, o3, p_chk, o_chk
        t0 = time.perf_counter()
        resumed, resumed_o, rep_c = loop(*fresh(), n, td, every=n)   # writes step 10 only
        resume_s = time.perf_counter() - t0
        check(rep_c["final_step"] == n, "(c) the resumed run reached step 10")
        got = host(resumed)
        del resumed_o
    if bitwise:
        tol, why = dict(rtol=1e-6, atol=1e-7), "tests/test_runtime.py:111-112; two straight " \
            "runs are bitwise equal"
    else:
        tol, why = dict(rtol=0.0, atol=spread), "the spread of two straight runs"
    resume_err = compare(f"LM restart on the card ({TRAIN['cpu_layers']} layers at full width: "
                         f"{at} steps, checkpoint, a fresh model, {n - at} more; against "
                         f"{n} straight)", got, straight[0], why=why, **tol)
    check(async_err <= spread,
          f"(c) the async step-3 checkpoint {async_err:.3e} from a straight 3-step run's "
          f"parameters, over the straight runs' spread {spread:.3e}")
    report["restart"] = {"straight_bitwise": bitwise, "straight_spread": spread,
                         "resume_max_abs_err": resume_err, "async_ckpt_vs_straight": async_err,
                         "ckpt_bytes_both": ckpt_bytes, "first_half_s": first_s,
                         "resume_s": resume_s}
    print(f"[phase 13] {smi}: restart: straight runs bitwise {bitwise} (spread "
          f"{spread:.3e}); resumed - straight {resume_err:.3e}; async step-3 checkpoint - "
          f"straight 3 steps {async_err:.3e}; the checkpoints of steps 3 and 5 "
          f"{ckpt_bytes / 1e9:.2f} GB; 5 steps and both writes {first_s:.1f} s; the "
          f"restore, 5 steps and the write of step 10 {resume_s:.1f} s")
    check(ops.launch_counts() == NO_LAUNCHES,
          f"the LM training path launched a kernel: {ops.launch_counts()}")
    del straight, got, resumed
    gc.collect()
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    print("[phase 13] " + json.dumps(report))
    print(f"[phase 13] took {report['seconds']:.1f} s")
    return report


# phase 14, ROADMAP A8's MoE part: olmoe-1b-7b at full size
# (repro_torch/configs/olmoe_1b_7b.py: 16 layers, d_model 2,048, 16/16
# heads of 128, 64 experts top-8 of width 1,024, capacity factor 1.25,
# vocab 50,304, untied embeddings, bfloat16: 6.92e9 parameters), random
# weights from a seed; (a) and (d) cut to 2 layers at full width, (b)
# served and (c) trained at the full 16 layers; (c)'s batch is the
# largest of 4, 2, 1 x 1,024 whose reckoned memory fits what is free; the
# CPU's train steps of (a) at batch 1 x 128 (its bf16 and float32 steps at
# 2 x 128 took 70-90 s of the phase), 2 of them (3 took 50-70 s, and the
# script neared its time limit)
MOE = dict(arch="olmoe-1b-7b", cpu_layers=2, cpu_batch=2, cpu_prompt=64, cpu_steps=8,
           cpu_train_batch=1, cpu_train_seq=128, cpu_train_steps=2,
           batch=4, prompt_len=256, gen=32, train_batch=4, train_seq=1024, train_steps=20,
           ckpt_steps=10, ckpt_at=5, ckpt_every=3, lr=3e-4, seed=0)


class MoESpy:
    """While active, records what each MoE FFN call routed, in call order:
    ``topi`` (T, k) and the (T, k) mask of dropped assignments, copied to
    the host (so never around a timed region or a graph capture); it wraps
    ``repro_torch.models.moe._route`` and ``_dispatch_tables``."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe = moe
        self.calls = []

    def __enter__(self):
        m = self.moe
        self._route, self._tables = m._route, m._dispatch_tables

        def route(p, x, cfg):
            out = self._route(p, x, cfg)
            self.calls.append({"topi": out[1].cpu()})
            return out

        def tables(topi, topv, T, k, C, e_lo, n_local, dtype):
            out = self._tables(topi, topv, T, k, C, e_lo, n_local, dtype)
            self.calls[-1]["dropped"] = (out[2] >= n_local * C).cpu()
            return out

        m._route, m._dispatch_tables = route, tables
        return self

    def __exit__(self, *exc):
        self.moe._route, self.moe._dispatch_tables = self._route, self._tables
        return False

    def dropped(self) -> int:
        return sum(int(c["dropped"].sum()) for c in self.calls)

    def dropped_share(self, calls=None) -> float:
        """The share of dropped assignments over ``calls`` (default all)."""
        calls = self.calls if calls is None else calls
        return (sum(int(c["dropped"].sum()) for c in calls)
                / max(sum(c["dropped"].numel() for c in calls), 1))

    def rows_lost(self, B: int, last_only: bool = False):
        """(B,) bool: the batch row lost an assignment in some layer (at its
        last position only, with ``last_only``)."""
        import torch

        lost = torch.zeros(B, dtype=torch.bool)
        for c in self.calls:
            d = c["dropped"].reshape(B, -1, c["dropped"].shape[-1])
            lost |= (d[:, -1] if last_only else d.flatten(1)).any(dim=-1)
        return lost


def flipped_tokens(a: MoESpy, b: MoESpy) -> list:
    """Tokens whose ordered top-k differs between two runs, call by call."""
    check(len(a.calls) == len(b.calls), "the two runs made different numbers of MoE calls")
    return [int((x["topi"] != y["topi"]).any(dim=1).sum()) for x, y in zip(a.calls, b.calls)]


def phase14(dev, smi, compare) -> dict:
    """The LM half's MoE family on the card at olmoe-1b-7b's full size:
    (a) card against the port's CPU run at full width cut to 2 layers
    (prefill logits and 8 decode steps on the CPU's greedy tokens, then 2
    train steps, every parameter after them; gate: twice the CPU's own
    bfloat16-vs-float32 distance), the top-k flips a layer between card
    and CPU and the dropped share printed; (b) the 16 layers through
    ``serve`` at batch 4, a 256-token prompt and 32 tokens (prefill first
    and warm, decode ms a token, tok/s, peak bytes above the weights, a
    decode step's and a prefill's device time from a CUDA graph and the
    idle share, beside the bounds), prefill(S) + decode(S) against
    prefill(S + 1) at 0.15 on the batch rows whose last position lost no
    assignment, finite logits; (c) the 16 layers through
    ``launch.train.build(smoke=False)`` and ``train_loop``, 20 steps at
    4 x 1,024 (memory reckoned first), every loss, aux and grad norm
    finite, aux > 0, the parameters moved (first step, warm median,
    tokens/s, peak bytes above model and AdamW state, the bound); (d) on
    (a)'s cut, two straight 10-step runs bitwise, 5 steps with an async
    checkpoint at step 3 and a synchronous one at 5, a fresh model restored
    from step 5 and 5 more, against them; the step-3 checkpoint against a
    straight 3-step run."""
    import copy

    import numpy as np
    import torch

    from repro_torch import optim
    from repro_torch.configs import ARCHS
    from repro_torch.data import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import get_model
    from repro_torch.models import lm as tlm
    from repro_torch.models import moe as tmoe
    from repro_torch.runtime import TrainLoopConfig, train_loop

    t_phase = time.perf_counter()
    cfg = ARCHS[MOE["arch"]].CONFIG
    check(cfg.family == "moe" and not cfg.use_mla and cfg.n_layers == 16
          and cfg.d_model == 2048 and cfg.n_experts == 64 and cfg.top_k == 8
          and cfg.d_expert == 1024 and cfg.capacity_factor == 1.25 and cfg.vocab == 50304
          and cfg.dtype == "bfloat16" and not cfg.tie_embeddings and cfg.remat,
          "phase 14 runs olmoe-1b-7b's full configuration")
    free, total = torch.cuda.mem_get_info()
    report = {"card": smi, "free_bytes_at_start": free,
              "held_at_start": torch.cuda.memory_allocated()}
    print(f"[phase 14] {smi}: {cfg.arch_id}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, {cfg.n_experts} experts "
          f"top-{cfg.top_k} of width {cfg.d_expert}, capacity factor {cfg.capacity_factor}, "
          f"vocab {cfg.vocab}, {cfg.dtype}, {cfg.param_count() / 1e9:.3f}e9 parameters; the "
          f"card's free memory {free / 1e9:.2f} GB of {total / 1e9:.2f} GB, earlier phases "
          f"hold {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    ops.reset_launch_counts()
    E, k = cfg.n_experts, cfg.top_k

    # -- (a) the card against the port's CPU run, 2 layers at full width --------
    cfg2 = dataclasses.replace(cfg, n_layers=MOE["cpu_layers"])
    m2, m2_32 = get_model(cfg2), get_model(dataclasses.replace(cfg2, dtype="float32"))
    t0 = time.perf_counter()
    cpu_p = m2.init_params(torch.Generator().manual_seed(MOE["seed"]))
    cpu_p32 = copy.deepcopy(cpu_p).float()          # the same values in float32
    card_p = copy.deepcopy(cpu_p).to(dev)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(MOE["seed"])
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(MOE["cpu_batch"],
                                                             MOE["cpu_prompt"])))
    cap = MOE["cpu_prompt"] + MOE["cpu_steps"]

    @torch.no_grad()
    def run(model, params, feed):
        """Prefill, then one decode step per token of ``feed`` (None: the
        run's own greedy tokens); (logits per step, tokens fed, its spy)."""
        d = params.device
        with MoESpy() as spy:
            logits, cache = model.prefill(params, {"tokens": toks.to(d)}, cache_len=cap)
            out, fed = [logits.float().cpu()], []
            for i in range(MOE["cpu_steps"]):
                tok = (torch.argmax(logits, -1)[:, None] if feed is None else feed[i].to(d))
                fed.append(tok.cpu())
                logits, cache = model.decode_step(
                    params, {"token": tok, "pos": MOE["cpu_prompt"] + i}, cache)
                out.append(logits.float().cpu())
        return out, fed, spy

    t0 = time.perf_counter()
    ref, fed, spy_cpu = run(m2, cpu_p, None)
    ref32, _, spy_32 = run(m2_32, cpu_p32, fed)
    serve_cpu_s = time.perf_counter() - t0
    got, _, spy_card = run(m2, card_p, fed)
    bf16_vs_f32 = max(float((a - b).abs().max()) for a, b in zip(ref, ref32))
    serve_err = compare(
        f"MoE card vs CPU ({cfg.arch_id} cut to {MOE['cpu_layers']} layers, prefill + "
        f"{MOE['cpu_steps']} decode steps on the CPU's greedy tokens, logits)",
        got, ref, rtol=0.0, atol=2.0 * bf16_vs_f32,
        why=f"twice the CPU's bfloat16-vs-float32 distance, {bf16_vs_f32:.4e}")
    L2 = MOE["cpu_layers"]

    def by_layer(fl):
        return [sum(fl[i::L2]) for i in range(L2)]

    fl_card, fl_32 = flipped_tokens(spy_card, spy_cpu), flipped_tokens(spy_32, spy_cpu)
    flips_a = {"prefill_tokens": MOE["cpu_batch"] * MOE["cpu_prompt"],
               "prefill_card_vs_cpu": fl_card[:L2], "prefill_cpu_f32_vs_bf16": fl_32[:L2],
               "decode_tokens": MOE["cpu_batch"] * MOE["cpu_steps"],
               "decode_card_vs_cpu": by_layer(fl_card[L2:]),
               "decode_cpu_f32_vs_bf16": by_layer(fl_32[L2:]),
               "dropped_share_prefill": spy_cpu.dropped_share(spy_cpu.calls[:L2]),
               "dropped_share_card": spy_card.dropped_share(),
               "dropped_share_cpu": spy_cpu.dropped_share()}
    print(f"[phase 14] (a) top-k flips a layer, tokens whose experts differ: prefill "
          f"({flips_a['prefill_tokens']} tokens) card vs CPU {fl_card[:L2]}, CPU float32 vs "
          f"bfloat16 {fl_32[:L2]}; decode ({flips_a['decode_tokens']} tokens) card vs CPU "
          f"{flips_a['decode_card_vs_cpu']}, CPU float32 vs bfloat16 "
          f"{flips_a['decode_cpu_f32_vs_bf16']}; dropped share: the CPU's prefill "
          f"{flips_a['dropped_share_prefill']:.4f}, all calls CPU "
          f"{spy_cpu.dropped_share():.4f} card {spy_card.dropped_share():.4f}")
    del got, ref, ref32

    ocfg = optim.AdamWConfig(lr=optim.warmup_cosine(MOE["lr"], 20, 10_000))
    stream2 = TokenStream(vocab=cfg.vocab, seq=MOE["cpu_train_seq"],
                          global_batch=MOE["cpu_train_batch"], seed=MOE["seed"])

    def steps(model, params, n, opt=None, start=0):
        """``n`` train steps from ``start``; (params, opt, [(loss, aux, grad
        norm)])."""
        opt = optim.init(tlm.leaves(params), ocfg) if opt is None else opt
        step = make_train_step(model, ocfg)
        out = []
        for s in range(start, start + n):
            _, opt, m = step(params, opt, stream2.batch(s, device=params.device))
            out.append((float(m["loss"]), float(m["aux"]), float(m["grad_norm"])))
        return params, opt, out

    def host(params):
        return [t.detach().float().cpu() for t in tlm.leaves(params).values()]

    t0 = time.perf_counter()
    cpu_o, cpu_m = steps(m2, cpu_p, MOE["cpu_train_steps"])[1:]
    t1 = time.perf_counter()
    cpu32_o, cpu32_m = steps(m2_32, cpu_p32, MOE["cpu_train_steps"])[1:]
    t2 = time.perf_counter()
    card_o, card_m = steps(m2, card_p, MOE["cpu_train_steps"])[1:]
    ref, ref32, got = host(cpu_p), host(cpu_p32), host(card_p)
    train_bf16_vs_f32 = max(float((a - b).abs().max()) for a, b in zip(ref, ref32))
    for i, (c, r, r32) in enumerate(zip(card_m, cpu_m, cpu32_m)):
        print(f"[phase 14] (a) step {i + 1}: loss card {c[0]:.6f} cpu {r[0]:.6f} cpu-f32 "
              f"{r32[0]:.6f}; aux card {c[1]:.6e} cpu {r[1]:.6e} cpu-f32 {r32[1]:.6e}; "
              f"grad norm card {c[2]:.6f} cpu {r[2]:.6f} cpu-f32 {r32[2]:.6f}")
    check(all(math.isfinite(v) for m in card_m for v in m) and all(m[1] > 0 for m in card_m),
          "(a) the card's losses, aux and grad norms finite, aux > 0")
    train_err = compare(
        f"MoE train card vs CPU ({cfg.arch_id} cut to {L2} layers, "
        f"{MOE['cpu_train_steps']} steps at {MOE['cpu_train_batch']} x "
        f"{MOE['cpu_train_seq']}, every parameter)", got, ref, rtol=0.0,
        atol=2.0 * train_bf16_vs_f32,
        why=f"twice the CPU's bfloat16-vs-float32 distance, {train_bf16_vs_f32:.4e}")
    loss_gap = max(abs(c[0] - r[0]) for c, r in zip(card_m, cpu_m))
    loss_gap32 = max(abs(r[0] - r32[0]) for r, r32 in zip(cpu_m, cpu32_m))
    check(loss_gap <= 2.0 * loss_gap32,
          f"(a) card loss {loss_gap:.3e} from the CPU's, over twice its bf16-vs-f32 "
          f"{loss_gap32:.3e}")
    report["card_vs_cpu"] = {
        "serve_max_abs_err": serve_err, "serve_cpu_bf16_vs_f32": bf16_vs_f32,
        "flips": flips_a, "train_max_abs_err": train_err,
        "train_cpu_bf16_vs_f32": train_bf16_vs_f32, "loss_card_vs_cpu": loss_gap,
        "loss_bf16_vs_f32": loss_gap32, "card": card_m, "cpu": cpu_m, "cpu_f32": cpu32_m,
        "init_s": init_s, "serve_cpu_s": serve_cpu_s, "train_cpu_bf16_s": t1 - t0,
        "train_cpu_f32_s": t2 - t1, "seconds": time.perf_counter() - t_phase}
    print(f"[phase 14] (a) on the CPU: init and copies {init_s:.1f} s, prefill + decode "
          f"bf16 and f32 {serve_cpu_s:.1f} s, {MOE['cpu_train_steps']} bfloat16 steps "
          f"{t1 - t0:.1f} s, {MOE['cpu_train_steps']} float32 steps {t2 - t1:.1f} s "
          f"({torch.get_num_threads()} threads); (a) took "
          f"{report['card_vs_cpu']['seconds']:.1f} s")
    del cpu_p, cpu_p32, card_p, cpu_o, cpu32_o, card_o, ref, ref32, got
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) the 16-layer model as serve drives it ------------------------------
    B_, P = MOE["batch"], MOE["prompt_len"]
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    served = tserve.serve(MOE["arch"], smoke=False, batch=B_, prompt_len=P, gen=MOE["gen"],
                          seed=MOE["seed"])
    serve_peak = torch.cuda.max_memory_allocated() - base
    check(served["generated"].shape == (B_, MOE["gen"])
          and ((served["generated"] >= 0) & (served["generated"] < cfg.vocab)).all(),
          "serve's generated tokens")
    torch.cuda.empty_cache()
    model = get_model(cfg)
    params = model.init_params(MOE["seed"], device=dev)
    held = sum(p.numel() * p.element_size() for p in params.parameters())
    emb_bytes = params.tok_emb.numel() * params.tok_emb.element_size()
    kv_row = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2      # k and v, bf16
    # a decode step reads every weight but the embedding table (a gather of
    # B rows): all 64 experts' C = 8 slots run, padding included, as in the
    # reference; the cache's valid positions
    bytes_decode = held - emb_bytes + B_ * (P + MOE["gen"] // 2) * kv_row
    bound_decode_ms = bytes_decode / PEAK_BYTES * 1e3
    # a prefill: the products with the expert rows counted as E x C slot
    # rows (C = capacity(B S), the padding included), the attention
    # projections and router for every token, each layer's two S x S
    # products (float32, formed whole), the unembedding for the last token
    T_ = B_ * P
    C_ = tmoe.capacity(T_, cfg)
    attn_w = 4 * cfg.d_model * cfg.n_heads * cfg.head_dim
    f_bf16 = cfg.n_layers * (2.0 * attn_w * T_ + 6.0 * cfg.d_model * cfg.d_expert * E * C_) \
        + 2.0 * cfg.vocab * cfg.d_model * B_
    f_f32 = cfg.n_layers * (2.0 * cfg.d_model * E * T_
                            + 4.0 * B_ * cfg.n_heads * P * P * cfg.head_dim)
    bound_prefill_ops_ms = (f_bf16 / PEAK_BF16 + f_f32 / PEAK_F32) * 1e3
    bound_prefill_bytes_ms = (held - emb_bytes + T_ * kv_row) / PEAK_BYTES * 1e3
    bound_prefill_ms = max(bound_prefill_ops_ms, bound_prefill_bytes_ms)
    toks = torch.from_numpy(np.random.default_rng(MOE["seed"]).integers(
        0, cfg.vocab, size=(B_, P + 1))).to(dev)
    cap = P + MOE["gen"]
    with torch.no_grad():
        pre_s = []
        for _ in range(6):
            (logits, cache), s_ = sync_s(lambda: model.prefill(
                params, {"tokens": toks[:, :P]}, cache_len=cap))
            pre_s.append(s_)
        tok = torch.argmax(logits, -1)[:, None]
        dec_s = []
        for i in range(MOE["gen"]):
            (logits_d, cache), s_ = sync_s(lambda: model.decode_step(
                params, {"token": tok, "pos": P + i}, cache))
            dec_s.append(s_)
            tok = torch.argmax(logits_d, -1)[:, None]
    check(bool(torch.isfinite(logits).all() and torch.isfinite(logits_d).all()),
          "non-finite MoE logits")
    # tests/test_arch_smoke.py:65-83 at full width: prefill(S) + decode(S)
    # against prefill(S + 1).  It holds exactly where the full forward
    # dropped nothing at the compared position; at capacity factor 1.25 the
    # prefills drop assignments (ranks are token-major, so the last rows
    # lose first), the decode step (C = 8 for 4 tokens) none.  So the gate
    # holds on the rows whose last position kept its experts in every
    # layer, and again on every row at capacity factor E / k, where C = T
    # and nothing can drop (the reference test's regime: its SMOKE config
    # runs at 8.0), on the same weights
    def consistency(m):
        with torch.no_grad():
            with MoESpy() as spy_s:
                _, c1 = m.prefill(params, {"tokens": toks[:, :P]}, cache_len=P + 1)
            with MoESpy() as spy_d:
                ld, _ = m.decode_step(params, {"token": toks[:, P:], "pos": P}, c1)
            with MoESpy() as spy_f:
                lf, _ = m.prefill(params, {"tokens": toks})
        check(bool(torch.isfinite(ld).all() and torch.isfinite(lf).all()),
              "non-finite MoE logits")
        check(spy_d.dropped() == 0 and len(spy_d.calls) == cfg.n_layers,
              f"a decode step at batch {B_} dropped {spy_d.dropped()} assignments")
        # tokens of the compared position routed to other experts by the
        # step than by the full forward, over the layers
        flips = sum(int((d["topi"] != f["topi"].reshape(B_, P + 1, -1)[:, -1]).any(-1).sum())
                    for d, f in zip(spy_d.calls, spy_f.calls))
        return ld.cpu(), lf.cpu(), spy_s, spy_f, flips

    cf8 = E / k
    ld, lf, spy_s, spy_f, flips = consistency(model)
    lost_last = [int(sum(c["dropped"].reshape(B_, P + 1, -1)[b, -1].sum() for c in spy_f.calls))
                 for b in range(B_)]
    kept = torch.tensor([n_ == 0 for n_ in lost_last])
    diff = (ld - lf).abs().amax(dim=-1)
    consist = {"dropped_share_prefill_S": spy_s.dropped_share(),
               "dropped_share_prefill_S1": spy_f.dropped_share(),
               "last_position_lost_by_row": lost_last,
               "rows_without_any_drop": int((~(spy_s.rows_lost(B_) | spy_f.rows_lost(B_))).sum()),
               "rows_checked": int(kept.sum()), "max_abs_diff_by_row": diff.tolist()}
    if kept.any():
        consist["max_abs_err"] = compare(
            f"MoE prefill({P}) + decode_step vs prefill({P + 1}) (last-token logits, "
            f"{cfg.n_layers} layers, capacity factor {cfg.capacity_factor}, the "
            f"{int(kept.sum())} of {B_} rows whose last position kept its {k} experts in "
            f"every layer)", [ld[kept]], [lf[kept]], rtol=0.15, atol=0.15,
            why="tests/test_arch_smoke.py:81-83 gate")
    ld8, lf8, spy_s8, spy_f8, flips8 = consistency(get_model(dataclasses.replace(
        cfg, capacity_factor=cf8)))
    consist.update(topk_flips=flips, topk_flips_cf8=flips8)
    check(spy_s8.dropped() == 0 and spy_f8.dropped() == 0,
          f"capacity factor {cf8} dropped assignments")
    consist["max_abs_err_cf8"] = compare(
        f"MoE prefill({P}) + decode_step vs prefill({P + 1}) (last-token logits, "
        f"{cfg.n_layers} layers, capacity factor {cf8}: nothing dropped, every row)",
        [ld8], [lf8], rtol=0.15, atol=0.15, why="tests/test_arch_smoke.py:81-83 gate")
    print(f"[phase 14] (b) capacity drops at {cfg.capacity_factor}: prefill({P}) at C = "
          f"{tmoe.capacity(B_ * P, cfg)} dropped {spy_s.dropped_share():.5f} of its "
          f"assignments, prefill({P + 1}) at C = {tmoe.capacity(B_ * (P + 1), cfg)} "
          f"{spy_f.dropped_share():.5f}, the decode step at C = {tmoe.capacity(B_, cfg)} "
          f"none; assignments lost at the last position, by row, over the {cfg.n_layers} "
          f"layers: {lost_last}; rows checked {int(kept.sum())} of {B_}; max |prefill + "
          f"decode - prefill(S + 1)| by row {[round(v, 4) for v in diff.tolist()]}; at "
          f"capacity factor {cf8} (C = T) {consist['max_abs_err_cf8']:.4f} over every row; "
          f"the last position's top-k flips between the step and the full forward, rows x "
          f"layers of {B_} x {cfg.n_layers}: {flips} at {cfg.capacity_factor}, {flips8} at "
          f"{cf8}")
    del spy_s, spy_f, spy_s8, spy_f8
    warm_prefill_ms = statistics.median(pre_s[1:]) * 1e3
    warm_decode_ms = statistics.median(dec_s) * 1e3
    dec_dev = graph_device_ms(lambda: model.decode_step(
        params, {"token": tok, "pos": P}, cache))
    pre_dev = graph_device_ms(lambda: model.prefill(
        params, {"tokens": toks[:, :P]}, cache_len=cap))
    report["serve"] = {
        "batch": B_, "prompt_len": P, "gen": MOE["gen"],
        "prefill_first_ms": served["prefill_s"] * 1e3, "prefill_warm_ms": warm_prefill_ms,
        "decode_ms_per_token": served["decode_s_per_token"] * 1e3,
        "decode_warm_median_ms": warm_decode_ms, "tokens_per_s": served["tokens_per_s"],
        "decode_device_ms": dec_dev, "prefill_device_ms": pre_dev,
        "decode_idle_share": 1.0 - dec_dev / warm_decode_ms,
        "prefill_idle_share": 1.0 - pre_dev / warm_prefill_ms,
        "param_bytes_held": held, "peak_bytes": serve_peak,
        "peak_above_weights": serve_peak - held, "held_before_bytes": base,
        "bound_decode_ms": bound_decode_ms, "decode_bytes": bytes_decode,
        "prefill_capacity": C_, "prefill_bf16_tflop": f_bf16 / 1e12,
        "prefill_f32_tflop": f_f32 / 1e12, "bound_prefill_ops_ms": bound_prefill_ops_ms,
        "bound_prefill_bytes_ms": bound_prefill_bytes_ms, "bound_prefill_ms": bound_prefill_ms,
        "consistency": consist}
    print(f"[phase 14] {smi}: serve({MOE['arch']}, batch {B_}, prompt {P}, gen "
          f"{MOE['gen']}): prefill {served['prefill_s'] * 1e3:.2f} ms first, "
          f"{warm_prefill_ms:.2f} ms warm (bound {bound_prefill_ms:.3f} ms: operations "
          f"{bound_prefill_ops_ms:.3f} ms, {f_bf16 / 1e12:.3f} TFLOP bf16 with {E} x "
          f"{C_} expert rows a layer + {f_f32 / 1e12:.4f} TFLOP float32; bytes "
          f"{bound_prefill_bytes_ms:.3f} ms); decode "
          f"{served['decode_s_per_token'] * 1e3:.3f} ms a token in serve, "
          f"{warm_decode_ms:.3f} ms warm median a step (bound {bound_decode_ms:.3f} ms: "
          f"{bytes_decode / 1e9:.3f} GB at 3.35 TB/s); {served['tokens_per_s']:.1f} tok/s; "
          f"serve's peak {serve_peak / 1e9:.3f} GB, {(serve_peak - held) / 1e9:.3f} GB above "
          f"the {held / 1e9:.3f} GB of weights ({base / 1e9:.3f} GB held before); device "
          f"time from a CUDA graph: decode step {dec_dev:.3f} ms (idle "
          f"{100 * (1 - dec_dev / warm_decode_ms):.1f}% of the eager step), prefill "
          f"{pre_dev:.3f} ms (idle {100 * (1 - pre_dev / warm_prefill_ms):.1f}%)")
    del params, model, cache, logits, logits_d, ld, lf, ld8, lf8
    gc.collect()
    torch.cuda.empty_cache()

    # -- (c) the 16 layers through launch/train.py's build and train_loop ------
    S_ = MOE["train_seq"]
    state_bytes = 4 * held                    # weights, gradients, AdamW's m and v

    def act_bytes(b):
        """What a step holds beside the state, reckoned: each block's input
        (per-block remat), one block's recomputed expert buffers and their
        gradients (gathered rows, outputs, products: E x C slot rows), the
        float32 S x S attention scores, probabilities and their gradient,
        and a loss chunk's float32 logits, their softmax and gradient."""
        T = b * S_
        C = tmoe.capacity(T, cfg)
        return (cfg.n_layers * T * cfg.d_model * 2 + 8 * E * C * cfg.d_model * 2
                + 6 * E * C * cfg.d_expert * 2 + 3 * b * cfg.n_heads * S_ * S_ * 4
                + 3 * b * min(cfg.logits_chunk, S_) * cfg.vocab * 4)

    free = torch.cuda.mem_get_info()[0]
    bt = MOE["train_batch"]
    while bt > 1 and state_bytes + act_bytes(bt) > free:
        bt //= 2
    print(f"[phase 14] (c) memory reckoned: weights, gradients and AdamW state "
          f"{state_bytes / 1e9:.2f} GB + a step's activations {act_bytes(bt) / 1e9:.2f} GB "
          f"at batch {bt} x {S_} (at {MOE['train_batch']}: {act_bytes(MOE['train_batch']) / 1e9:.2f}"
          f" GB); free {free / 1e9:.2f} GB")
    T_ = bt * S_
    C_ = tmoe.capacity(T_, cfg)
    # the products as the code runs them: forward, backward (twice the
    # forward), the blocks' remat forward and the loss chunk's recomputed
    # logits: the projections and the E x C expert rows in bfloat16, the
    # router and the attention's S x S products in float32
    f_blocks = cfg.n_layers * (2.0 * attn_w * T_ + 6.0 * cfg.d_model * cfg.d_expert * E * C_)
    f_unembed = 2.0 * cfg.vocab * cfg.d_model * T_
    f_attn = cfg.n_layers * 4.0 * bt * cfg.n_heads * S_ * S_ * cfg.head_dim
    f_router = cfg.n_layers * 2.0 * T_ * cfg.d_model * E
    bf16_flop = 4.0 * (f_blocks + f_unembed)
    f32_flop = 4.0 * (f_attn + f_router)
    bound_ms = (bf16_flop / PEAK_BF16 + f32_flop / PEAK_F32) * 1e3
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cfg_b, model, params, opt_state, step_fn, stream, extras, shardings = ttrain.build(
        MOE["arch"], smoke=False, batch=bt, seq=S_, lr=MOE["lr"], seed=MOE["seed"],
        device=dev)
    check(cfg_b == cfg and shardings == (None, None), "(c) build's configuration")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    held_c = torch.cuda.memory_allocated() - base
    last = cfg.n_layers - 1
    watch = {k_: v.detach().clone() for k_, v in tlm.leaves(params).items()
             if k_ in ("final_norm", "blocks.0.ln1", "blocks.0.moe.router",
                       f"blocks.{last}.attn.wq", f"blocks.{last}.moe.wd")}
    emb_rows = params.tok_emb[:4096].detach().clone()
    auxes = []

    def step_rec(p, o, b):
        out = step_fn(p, o, b)
        auxes.append(out[2]["aux"])
        return out

    torch.cuda.reset_peak_memory_stats()
    params, opt_state, rep = train_loop(step_rec, params, opt_state,
                                        lambda s: stream.batch(s, extras, device=dev),
                                        TrainLoopConfig(steps=MOE["train_steps"], ckpt_dir=None,
                                                        log_every=1, handle_signals=False),
                                        log_fn=lambda s: None)
    peak = torch.cuda.max_memory_allocated() - base
    hist = rep["history"]
    aux_v = [float(a) for a in auxes]
    check(len(hist) == MOE["train_steps"] and rep["final_step"] == MOE["train_steps"],
          "(c) ran every step")
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist)
          and all(math.isfinite(a) and a > 0 for a in aux_v),
          "(c) every loss, aux and grad norm finite, aux > 0")
    moved = {k_: not torch.equal(v, tlm.leaves(params)[k_]) for k_, v in watch.items()}
    moved["tok_emb[:4096]"] = not torch.equal(emb_rows, params.tok_emb[:4096])
    check(all(moved.values()), f"(c) the parameters moved: {moved}")
    secs = [h["sec_per_step"] for h in hist]
    warm = statistics.median(secs[1:])
    report["train"] = {
        "batch": bt, "seq": S_, "steps": MOE["train_steps"], "capacity": C_,
        "build_s": build_s, "first_step_s": secs[0], "warm_median_s": warm,
        "warm_min_s": min(secs[1:]), "warm_max_s": max(secs[1:]), "tokens_per_s": T_ / warm,
        "losses": [h["loss"] for h in hist], "aux": aux_v,
        "grad_norms": [h["grad_norm"] for h in hist], "stragglers": rep["stragglers"],
        "held_bytes": held_c, "peak_bytes": peak, "peak_above_state": peak - held_c,
        "held_before_bytes": base, "reckoned_state_bytes": state_bytes,
        "reckoned_act_bytes": act_bytes(bt), "bf16_tflop": bf16_flop / 1e12,
        "f32_tflop": f32_flop / 1e12, "bound_ms": bound_ms}
    print(f"[phase 14] {smi}: train({MOE['arch']}, {cfg.n_layers} layers, batch {bt} x "
          f"{S_}, {MOE['train_steps']} steps, {E} x {C_} expert rows a layer): first step "
          f"{secs[0]:.3f} s, warm median {warm * 1e3:.1f} ms "
          f"({min(secs[1:]) * 1e3:.1f}-{max(secs[1:]) * 1e3:.1f}), {T_ / warm:.0f} tokens/s; "
          f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, aux {aux_v[0]:.5f} -> "
          f"{aux_v[-1]:.5f}; bound {bound_ms:.1f} ms ({bf16_flop / 1e12:.2f} TFLOP bf16 at "
          f"989 TFLOP/s + {f32_flop / 1e12:.2f} TFLOP float32 at 67 TFLOP/s); model and "
          f"AdamW state held {held_c / 1e9:.3f} GB, the steps' peak {(peak - held_c) / 1e9:.3f}"
          f" GB above it ({base / 1e9:.3f} GB held before); built in {build_s:.1f} s")
    del params, opt_state, step_fn, model, watch, emb_rows, auxes
    gc.collect()
    torch.cuda.empty_cache()

    # -- (d) checkpoint and restart on (a)'s cut ----------------------------------
    def fresh():
        p = m2.init_params(MOE["seed"], device=dev)
        return (p, optim.init(tlm.leaves(p), ocfg), make_train_step(m2, ocfg),
                lambda s: stream2.batch(s, device=dev))

    report["restart"] = restart_bitwise(
        14, f"{L2} layers at full width, batch {MOE['cpu_train_batch']} x "
            f"{MOE['cpu_train_seq']}", MOE, fresh)
    check(ops.launch_counts() == NO_LAUNCHES,
          f"the MoE path launched a kernel: {ops.launch_counts()}")
    gc.collect()
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    print("[phase 14] " + json.dumps(report))
    print(f"[phase 14] took {report['seconds']:.1f} s")
    return report


# phase 15, ROADMAP A8's MLA and MTP part: deepseek-v3-671b at full width
# (repro_torch/configs/deepseek_v3_671b.py: d_model 7,168, 128 heads, MLA
# q_lora 1,536, kv_lora 512, nope 128, rope 64, v 128; the first 3 layers
# dense (d_ff 18,432), then 256 routed experts top-8 of width 2,048 and one
# shared expert, capacity factor 1.25; MTP depth 1; vocab 129,280, untied,
# bfloat16), random weights from a seed, every width the published one and
# only the depth cut: (a) 2 layers (the first dense) with 16 experts top-8
# (4.31e9 parameters) for the card-against-CPU check; (b) served at 4
# layers (the 3 dense and 1 MoE layer) with all 256 experts and the MTP
# block as init_params builds it (2.67e10 parameters, 53.4 GB in bf16: a
# second MoE layer would need ~76 GB); (c) trained at 4 layers with the
# routed experts cut to 32 (6.89e9 parameters): one 256-expert layer with
# AdamW's moments and its gradients needs ~92 GB; (d) the restart on the
# SMOKE config (a full-width checkpoint is >= 26 GB a write)
DEEPSEEK = dict(arch="deepseek-v3-671b", cpu_layers=2, cpu_moe_start=1, cpu_experts=16,
                cpu_batch=2, cpu_prompt=64, cpu_steps=8, cpu_loss_batch=1, cpu_loss_seq=128,
                serve_layers=4, batch=4, prompt_len=256, gen=32, long_prompt=4096,
                flash_heads=16, consistency_cf=8.0,
                train_layers=4, train_experts=32, train_batch=4, train_seq=1024,
                train_steps=20, ckpt_steps=10, ckpt_at=5, ckpt_every=3, ckpt_seq=64,
                ckpt_batch=2, lr=3e-4, seed=0)


def mla_bytes_read(params) -> int:
    """The bytes of the parameters a serving call reads: every one but the
    embedding table (a gather of a few rows) and the MTP head (the loss's
    only)."""
    return sum(p.numel() * p.element_size() for n, p in params.named_parameters()
               if not n.startswith(("tok_emb", "mtp_")))


def phase15(dev, smi, compare) -> dict:
    """The LM half's MLA family on the card, deepseek-v3 at full width with
    the depth cut: (a) card against the port's CPU run at 2 layers and 16
    experts (prefill logits and 8 decode steps on the CPU's greedy tokens,
    then the loss with its MTP term and its gradients' global norm on 1 x
    128 tokens; gate: twice the CPU's own bfloat16-vs-float32 distance),
    the top-k flips and dropped share printed; (b) 4 layers with all 256
    experts through ``launch.serve.generate`` at batch 4, a 256-token
    prompt and 32 tokens (prefill first and warm, decode ms a token,
    tok/s, peak above the weights, the latent cache beside the expanded
    K/V it replaces, a decode step's and a prefill's device time from a
    CUDA graph and the idle share, beside the bounds), prefill(S) +
    decode(S) against prefill(S + 1) at 0.15 (capacity factor 8 on the
    rows whose last position kept its experts; capacity factor E / k on
    one row, where nothing can drop), a 4,096-token prompt through the
    flash route in every layer (counted) and layer 0's flash attention
    against the simple route on 16 heads in float32; (c) 4 layers with 32
    experts through the pieces ``launch.train.build`` assembles and
    ``train_loop``, 20 steps at 4 x 1,024 (memory reckoned first), every
    loss (the MTP term in), aux and grad norm finite, aux > 0, the
    parameters moved, beside the step's bound; (d) on the SMOKE config,
    two straight runs, a restart from an async checkpoint and the
    checkpoint itself, bitwise, with the MTP leaves in the reference's
    tree."""
    import copy

    import numpy as np
    import torch

    from repro_torch import optim
    from repro_torch.configs import ARCHS
    from repro_torch.data import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import get_model
    from repro_torch.models import layers as tl
    from repro_torch.models import lm as tlm
    from repro_torch.models import mla as tmla
    from repro_torch.models import moe as tmoe
    from repro_torch.runtime import TrainLoopConfig, train_loop

    t_phase = time.perf_counter()
    D = DEEPSEEK
    full = ARCHS[D["arch"]].CONFIG
    check(full.use_mla and full.n_layers == 61 and full.moe_layer_start == 3
          and full.d_model == 7168 and full.n_heads == 128 and full.q_lora_rank == 1536
          and full.kv_lora_rank == 512 and full.qk_nope_dim == 128 and full.qk_rope_dim == 64
          and full.v_head_dim == 128 and full.n_experts == 256 and full.top_k == 8
          and full.n_shared_experts == 1 and full.d_expert == 2048 and full.d_ff == 18432
          and full.capacity_factor == 1.25 and full.mtp_depth == 1 and full.vocab == 129280
          and full.dtype == "bfloat16" and not full.tie_embeddings and full.remat,
          "phase 15 runs deepseek-v3-671b's published widths")
    # the absorbed form's float32 score and context products: full float32
    prec = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    check(prec == ("highest", False), f"TF32 is on for float32 products: {prec}")
    free, total = torch.cuda.mem_get_info()
    report = {"card": smi, "free_bytes_at_start": free,
              "held_at_start": torch.cuda.memory_allocated(), "matmul_precision": prec[0]}
    print(f"[phase 15] {smi}: {full.arch_id}, published widths: d_model {full.d_model}, "
          f"{full.n_heads} heads, MLA q_lora {full.q_lora_rank} kv_lora {full.kv_lora_rank} "
          f"nope {full.qk_nope_dim} rope {full.qk_rope_dim} v {full.v_head_dim}, "
          f"{full.moe_layer_start} dense layers of d_ff {full.d_ff}, {full.n_experts} routed "
          f"experts top-{full.top_k} of width {full.d_expert} + {full.n_shared_experts} "
          f"shared, capacity factor {full.capacity_factor}, MTP depth {full.mtp_depth}, "
          f"vocab {full.vocab}, {full.dtype}; float32 matmul precision {prec[0]!r}, "
          f"allow_tf32 {prec[1]}; the card's free memory {free / 1e9:.2f} GB of "
          f"{total / 1e9:.2f} GB, earlier phases hold "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    ops.reset_launch_counts()

    # -- (a) the card against the port's CPU run, 2 layers and 16 experts ------
    # without the per-block remat, which gives the same values bitwise
    # (tests/test_torch_lm_mla.py::test_mla_remat_on_and_off_agree) and
    # spares the CPU's gradients a second forward pass; (c) trains with it
    cfg_a = dataclasses.replace(full, n_layers=D["cpu_layers"],
                                moe_layer_start=D["cpu_moe_start"], n_experts=D["cpu_experts"],
                                remat=False)
    m_a, m_a32 = get_model(cfg_a), get_model(dataclasses.replace(cfg_a, dtype="float32"))
    t0 = time.perf_counter()
    card_p = m_a.init_params(D["seed"], device=dev)          # drawn on the card
    cpu_p = copy.deepcopy(card_p).to("cpu")
    cpu_p32 = copy.deepcopy(cpu_p).float()                   # the same values in float32
    init_s = time.perf_counter() - t0
    n_a = nparams(cpu_p)
    # bf16 and f32 weights, the bf16 run's gradients kept while the
    # float32 run's are compared with them
    host_bytes = n_a * (2 + 4 + 2 + 4)
    print(f"[phase 15] (a) {cfg_a.n_layers} layers ({cfg_a.moe_layer_start} dense), "
          f"{cfg_a.n_experts} experts top-{cfg_a.top_k}, MTP {cfg_a.mtp_depth}: "
          f"{n_a / 1e9:.3f}e9 parameters; the CPU side holds ~{host_bytes / 1e9:.1f} GB "
          f"(bf16 and float32 weights, the gradients of both runs) beside its "
          f"activations")
    rng = np.random.default_rng(D["seed"])
    toks = torch.from_numpy(rng.integers(0, cfg_a.vocab, size=(D["cpu_batch"],
                                                                D["cpu_prompt"])))
    cap = D["cpu_prompt"] + D["cpu_steps"]

    @torch.no_grad()
    def run(model, params, feed):
        """Prefill, then one decode step per token of ``feed`` (None: the
        run's own greedy tokens); (logits per step, tokens fed, its spy)."""
        d = params.device
        with MoESpy() as spy:
            logits, cache = model.prefill(params, {"tokens": toks.to(d)}, cache_len=cap)
            out, fed = [logits.float().cpu()], []
            for i in range(D["cpu_steps"]):
                tok = (torch.argmax(logits, -1)[:, None] if feed is None else feed[i].to(d))
                fed.append(tok.cpu())
                logits, cache = model.decode_step(
                    params, {"token": tok, "pos": D["cpu_prompt"] + i}, cache)
                out.append(logits.float().cpu())
        return out, fed, spy

    t0 = time.perf_counter()
    ref, fed, spy_cpu = run(m_a, cpu_p, None)
    t1 = time.perf_counter()
    ref32, _, spy_32 = run(m_a32, cpu_p32, fed)
    serve_cpu_s = (t1 - t0, time.perf_counter() - t1)
    got, _, spy_card = run(m_a, card_p, fed)
    bf16_vs_f32 = max(float((a - b).abs().max()) for a, b in zip(ref, ref32))
    serve_err = compare(
        f"MLA card vs CPU ({cfg_a.arch_id} cut to {cfg_a.n_layers} layers and "
        f"{cfg_a.n_experts} experts, prefill + {D['cpu_steps']} decode steps on the CPU's "
        f"greedy tokens, logits)", got, ref, rtol=0.0, atol=2.0 * bf16_vs_f32,
        why=f"twice the CPU's bfloat16-vs-float32 distance, {bf16_vs_f32:.4e}")
    fl_card, fl_32 = flipped_tokens(spy_card, spy_cpu), flipped_tokens(spy_32, spy_cpu)
    flips_a = {"prefill_tokens": D["cpu_batch"] * D["cpu_prompt"],
               "prefill_card_vs_cpu": fl_card[0], "prefill_cpu_f32_vs_bf16": fl_32[0],
               "decode_tokens": D["cpu_batch"] * D["cpu_steps"],
               "decode_card_vs_cpu": sum(fl_card[1:]), "decode_cpu_f32_vs_bf16": sum(fl_32[1:]),
               "dropped_share_prefill_cpu": spy_cpu.dropped_share(spy_cpu.calls[:1]),
               "dropped_share_card": spy_card.dropped_share(),
               "dropped_share_cpu": spy_cpu.dropped_share()}
    print(f"[phase 15] (a) the MoE layer's top-k flips, tokens whose experts differ: prefill "
          f"({flips_a['prefill_tokens']} tokens) card vs CPU {fl_card[0]}, CPU float32 vs "
          f"bfloat16 {fl_32[0]}; decode ({flips_a['decode_tokens']} tokens) card vs CPU "
          f"{flips_a['decode_card_vs_cpu']}, CPU float32 vs bfloat16 "
          f"{flips_a['decode_cpu_f32_vs_bf16']}; dropped share: the CPU's prefill (C = "
          f"{tmoe.capacity(flips_a['prefill_tokens'], cfg_a)}) "
          f"{flips_a['dropped_share_prefill_cpu']:.4f}, all calls CPU "
          f"{spy_cpu.dropped_share():.4f} card {spy_card.dropped_share():.4f}")
    del got, ref, ref32

    ltoks = torch.from_numpy(rng.integers(0, cfg_a.vocab, size=(D["cpu_loss_batch"],
                                                                 D["cpu_loss_seq"])))

    def loss_grads(model, params):
        """((the loss with its MTP term, its aux, the global norm of its
        gradients over every leaf, summed in float32), the gradients)."""
        with tlm.trainable(params):
            loss, met = model.loss_fn(params, {"tokens": ltoks.to(params.device)})
            named = tlm.leaves(params)
            grads = torch.autograd.grad(loss, list(named.values()))
        sq = torch.zeros((), dtype=torch.float32, device=params.device)
        for g in grads:
            sq = sq + torch.sum(torch.square(g.float()))
        return (float(loss.detach()), float(met["aux"].detach()), float(torch.sqrt(sq))), grads

    def grad_dist(ga, gb):
        """max |ga - gb| over every gradient entry, a leaf at a time on the
        card (the same float32 differences, without the host's passes over
        the 4.4e9 entries)."""
        return max(float((a.to(dev).float() - b.to(dev).float()).abs().max())
                   for a, b in zip(ga, gb))

    t0 = time.perf_counter()
    l_cpu, g_cpu = loss_grads(m_a, cpu_p)
    t1 = time.perf_counter()
    l_32, g_32 = loss_grads(m_a32, cpu_p32)
    loss_cpu_s = (t1 - t0, time.perf_counter() - t1)
    grad_bf16_vs_f32 = grad_dist(g_cpu, g_32)
    del g_32
    l_card, g_card = loss_grads(m_a, card_p)
    grad_err = grad_dist(g_card, g_cpu)
    del g_card, g_cpu
    # the loss's MTP term alone, on the card, from the port's own pieces
    no_mtp = float(tlm.loss_fn(card_p, {"tokens": ltoks.to(dev)},
                               dataclasses.replace(cfg_a, mtp_depth=0))[0])
    print(f"[phase 15] (a) on 1 x {D['cpu_loss_seq']} tokens: loss card {l_card[0]:.6f} cpu "
          f"{l_cpu[0]:.6f} cpu-f32 {l_32[0]:.6f} (card without the MTP head {no_mtp:.6f}); "
          f"aux card {l_card[1]:.6e} cpu {l_cpu[1]:.6e} cpu-f32 {l_32[1]:.6e}; gradients' "
          f"global norm card {l_card[2]:.6f} cpu {l_cpu[2]:.6f} cpu-f32 {l_32[2]:.6f}")
    check(all(math.isfinite(v) for v in l_card) and l_card[1] > 0,
          "(a) the card's loss, aux and grad norm finite, aux > 0")
    check(no_mtp != l_card[0], "(a) the MTP term is in the loss")
    loss_gap, loss_gap32 = abs(l_card[0] - l_cpu[0]), abs(l_cpu[0] - l_32[0])
    check(loss_gap <= 2.0 * loss_gap32, f"(a) card loss {loss_gap:.3e} from the CPU's, over "
                                        f"twice its bf16-vs-f32 {loss_gap32:.3e}")
    # the gradients entry by entry (a scalar norm's bf16-vs-f32 gap is one
    # draw, which cancellation can make small by chance)
    ok = grad_err <= 2.0 * grad_bf16_vs_f32
    print(f"[check] MLA gradients card vs CPU ({cfg_a.arch_id} cut to {cfg_a.n_layers} layers "
          f"and {cfg_a.n_experts} experts, the loss with its MTP term on 1 x "
          f"{D['cpu_loss_seq']} tokens, every leaf): max_abs_err={grad_err:.3e} tol=rtol 0, "
          f"atol {2.0 * grad_bf16_vs_f32:g} (twice the CPU's bfloat16-vs-float32 distance, "
          f"{grad_bf16_vs_f32:.4e}); worst error/tolerance "
          f"{grad_err / (2.0 * grad_bf16_vs_f32):.3f} -> {'ok' if ok else 'FAIL'}")
    check(ok, "(a) the card's gradients disagree with the CPU's")
    gaps = {"loss": (loss_gap, loss_gap32), "grad_norm": (abs(l_card[2] - l_cpu[2]),
                                                          abs(l_cpu[2] - l_32[2])),
            "grads": (grad_err, grad_bf16_vs_f32)}
    report["card_vs_cpu"] = {
        "layers": cfg_a.n_layers, "experts": cfg_a.n_experts, "params": n_a,
        "serve_max_abs_err": serve_err, "serve_cpu_bf16_vs_f32": bf16_vs_f32,
        "flips": flips_a, "loss": {"card": l_card, "cpu": l_cpu, "cpu_f32": l_32,
                                   "card_without_mtp": no_mtp},
        "loss_gap": gaps["loss"], "grad_norm_gap": gaps["grad_norm"],
        "grad_max_abs_err": gaps["grads"],
        "reckoned_host_bytes": host_bytes, "init_and_copies_s": init_s,
        "serve_cpu_bf16_s": serve_cpu_s[0], "serve_cpu_f32_s": serve_cpu_s[1],
        "loss_cpu_bf16_s": loss_cpu_s[0], "loss_cpu_f32_s": loss_cpu_s[1],
        "seconds": time.perf_counter() - t_phase}
    print(f"[phase 15] (a) on the CPU ({torch.get_num_threads()} threads): init on the card "
          f"and copies {init_s:.1f} s, prefill + decode bf16 {serve_cpu_s[0]:.1f} s and f32 "
          f"{serve_cpu_s[1]:.1f} s, loss and gradients bf16 {loss_cpu_s[0]:.1f} s and f32 "
          f"{loss_cpu_s[1]:.1f} s; (a) took {report['card_vs_cpu']['seconds']:.1f} s")
    del cpu_p, cpu_p32, card_p
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) serving at 4 layers with all 256 experts -------------------------
    cfg = dataclasses.replace(full, n_layers=D["serve_layers"])
    E, k = cfg.n_experts, cfg.top_k
    B_, P, G = D["batch"], D["prompt_len"], D["gen"]
    model = get_model(cfg)
    base = torch.cuda.memory_allocated()
    (params, init_b_s) = sync_s(lambda: model.init_params(D["seed"], device=dev))
    held = sum(p.numel() * p.element_size() for p in params.parameters())
    n_b = nparams(params)
    toks = torch.from_numpy(np.random.default_rng(D["seed"]).integers(
        0, cfg.vocab, size=(B_, P + 1))).to(dev)
    cap = P + G
    torch.cuda.reset_peak_memory_stats()
    served = tserve.generate(model, params, toks[:, :P], G)
    serve_peak = torch.cuda.max_memory_allocated() - base
    check(served["generated"].shape == (B_, G)
          and ((served["generated"] >= 0) & (served["generated"] < cfg.vocab)).all(),
          "generate's tokens")
    W = cfg.kv_lora_rank + cfg.qk_rope_dim
    latent_bytes = cfg.n_layers * B_ * cap * W * 2
    expanded_bytes = cfg.n_layers * B_ * cap * cfg.n_heads * (
        cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim) * 2
    # a decode step reads the weights of the path (the LM head, every
    # layer's attention and FFN, all 256 experts' 8 slots as the reference
    # runs them) and the cache's valid latents; not the embedding table (a
    # gather of B rows) nor the MTP head
    read = mla_bytes_read(params)
    bytes_decode = read + B_ * (P + G // 2) * cfg.n_layers * W * 2
    bound_decode_ms = bytes_decode / PEAK_BYTES * 1e3
    # a prefill: the bf16 products (attention projections with the
    # expanded wkv_b for every token; the dense FFNs; the routed experts
    # over E x C slot rows, padding included; the shared expert; the LM
    # head for the last token), the float32 ones (router; each layer's two
    # S x S products, formed whole at 256 tokens)
    T_ = B_ * P
    C_ = tmoe.capacity(T_, cfg)
    H, Dqk, Dv = cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    attn_w = (cfg.d_model * cfg.q_lora_rank + cfg.q_lora_rank * H * Dqk
              + cfg.d_model * W + cfg.kv_lora_rank * H * (cfg.qk_nope_dim + Dv)
              + H * Dv * cfg.d_model)
    nd, nm = cfg.moe_layer_start, cfg.n_layers - cfg.moe_layer_start
    f_bf16 = (cfg.n_layers * 2.0 * attn_w * T_ + nd * 6.0 * cfg.d_model * cfg.d_ff * T_
              + nm * 6.0 * cfg.d_model * cfg.d_expert * (E * C_ + T_)
              + 2.0 * cfg.vocab * cfg.d_model * B_)
    f_f32 = (nm * 2.0 * cfg.d_model * E * T_
             + cfg.n_layers * 2.0 * B_ * H * P * P * (Dqk + Dv))
    bound_prefill_ops_ms = (f_bf16 / PEAK_BF16 + f_f32 / PEAK_F32) * 1e3
    bound_prefill_bytes_ms = (read + T_ * cfg.n_layers * W * 2) / PEAK_BYTES * 1e3
    bound_prefill_ms = max(bound_prefill_ops_ms, bound_prefill_bytes_ms)
    with torch.no_grad():
        pre_s = []
        for _ in range(4):
            (logits, cache), s_ = sync_s(lambda: model.prefill(
                params, {"tokens": toks[:, :P]}, cache_len=cap))
            pre_s.append(s_)
        tok = torch.argmax(logits, -1)[:, None]
        dec_s = []
        for i in range(G):
            (logits_d, cache), s_ = sync_s(lambda: model.decode_step(
                params, {"token": tok, "pos": P + i}, cache))
            dec_s.append(s_)
            tok = torch.argmax(logits_d, -1)[:, None]
    check(bool(torch.isfinite(logits).all() and torch.isfinite(logits_d).all()),
          "non-finite MLA logits")
    warm_prefill_ms = statistics.median(pre_s) * 1e3
    warm_decode_ms = statistics.median(dec_s) * 1e3
    dec_dev = graph_device_ms(lambda: model.decode_step(
        params, {"token": tok, "pos": P}, cache))
    pre_dev = graph_device_ms(lambda: model.prefill(
        params, {"tokens": toks[:, :P]}, cache_len=cap))
    del cache, logits, logits_d
    torch.cuda.empty_cache()

    # tests/test_arch_smoke.py:65-83 at full width: the absorbed step after
    # the expanded prefill against the expanded prefill of one more token.
    # At capacity factor 8 (C = 264 slots for 4 x 257 tokens) the gate holds
    # on the rows whose last position kept its experts in every layer; at
    # capacity factor E / k = 32 (C = T) nothing can drop, on one row
    def consistency(m, rows):
        tk = toks[:rows]
        with torch.no_grad():
            with MoESpy() as spy_s:
                _, c1 = m.prefill(params, {"tokens": tk[:, :P]}, cache_len=P + 1)
            with MoESpy() as spy_d:
                ld, _ = m.decode_step(params, {"token": tk[:, P:], "pos": P}, c1)
            del c1
            with MoESpy() as spy_f:
                lf, _ = m.prefill(params, {"tokens": tk})
        check(bool(torch.isfinite(ld).all() and torch.isfinite(lf).all()),
              "non-finite MLA logits")
        check(spy_d.dropped() == 0, f"a decode step at batch {rows} dropped assignments")
        lost = [int(sum(c["dropped"].reshape(rows, P + 1, -1)[b, -1].sum()
                        for c in spy_f.calls)) for b in range(rows)]
        return ld.cpu(), lf.cpu(), spy_s, spy_f, lost

    cf8 = D["consistency_cf"]
    ld, lf, spy_s, spy_f, lost = consistency(
        get_model(dataclasses.replace(cfg, capacity_factor=cf8)), B_)
    kept = torch.tensor([n_ == 0 for n_ in lost])
    consist = {"capacity_factor": cf8, "capacity": tmoe.capacity(B_ * (P + 1), dataclasses.replace(
        cfg, capacity_factor=cf8)), "dropped_share_prefill_S": spy_s.dropped_share(),
        "dropped_share_prefill_S1": spy_f.dropped_share(),
        "last_position_lost_by_row": lost, "rows_checked": int(kept.sum()),
        "max_abs_diff_by_row": (ld - lf).abs().amax(dim=-1).tolist()}
    if kept.any():
        consist["max_abs_err"] = compare(
            f"MLA prefill({P}) + decode_step vs prefill({P + 1}) (last-token logits, "
            f"{cfg.n_layers} layers, {E} experts, capacity factor {cf8}, the "
            f"{int(kept.sum())} of {B_} rows whose last position kept its {k} experts in "
            f"every layer)", [ld[kept]], [lf[kept]], rtol=0.15, atol=0.15,
            why="tests/test_arch_smoke.py:81-83 gate")
    del spy_s, spy_f
    cf_all = E / k
    ld1, lf1, spy_s1, spy_f1, _ = consistency(
        get_model(dataclasses.replace(cfg, capacity_factor=cf_all)), 1)
    check(spy_s1.dropped() == 0 and spy_f1.dropped() == 0,
          f"capacity factor {cf_all} dropped assignments")
    consist["max_abs_err_all_kept"] = compare(
        f"MLA prefill({P}) + decode_step vs prefill({P + 1}) (last-token logits, "
        f"{cfg.n_layers} layers, capacity factor {cf_all}: nothing dropped, row 0)",
        [ld1], [lf1], rtol=0.15, atol=0.15, why="tests/test_arch_smoke.py:81-83 gate")
    del spy_s1, spy_f1
    print(f"[phase 15] (b) prefill({P}) + decode vs prefill({P + 1}): at capacity factor "
          f"{cf8} (C = {consist['capacity']}) the prefills dropped "
          f"{consist['dropped_share_prefill_S']:.5f} / "
          f"{consist['dropped_share_prefill_S1']:.5f} of their assignments, the last "
          f"position lost {lost} by row, rows checked {int(kept.sum())} of {B_}, max |diff| by "
          f"row {[round(v, 4) for v in consist['max_abs_diff_by_row']]}; at capacity factor "
          f"{cf_all:g} on row 0 {consist['max_abs_err_all_kept']:.4f}")

    # a 4,096-token prompt: the flash route (Dqk 192, Dv 128) in every layer
    long = torch.from_numpy(np.random.default_rng(D["seed"] + 1).integers(
        0, cfg.vocab, size=(1, D["long_prompt"]))).to(dev)
    routes = []
    orig_flash, orig_simple = tl._attention_flash, tl._attention_simple

    def spy(name, fn):
        def call(*a, **kw):
            routes.append(name)
            return fn(*a, **kw)
        return call

    tl._attention_flash = spy("flash", orig_flash)
    tl._attention_simple = spy("simple", orig_simple)
    try:
        with torch.no_grad():
            long_s = [sync_s(lambda: model.prefill(params, {"tokens": long}))[1]
                      for _ in range(2)]
    finally:
        tl._attention_flash, tl._attention_simple = orig_flash, orig_simple
    check(routes == ["flash"] * (2 * cfg.n_layers),
          f"the {D['long_prompt']}-token prefill took the flash route in every layer: {routes}")
    long_dev = graph_device_ms(lambda: model.prefill(params, {"tokens": long}), replays=3)
    hh = D["flash_heads"]
    with torch.no_grad():
        lp0 = params.dense_blocks[0]
        x = tlm._embed(params, long, cfg)
        hn = tl.rmsnorm(x, lp0["ln1"], cfg.norm_eps)
        p0 = lp0["attn"]
        pos = torch.arange(D["long_prompt"], device=dev)
        q_nope, q_rope = tmla._q_proj(p0, hn, cfg)
        ckv, k_rope = tmla._kv_latent(p0, hn, cfg)
        q = torch.cat([q_nope, tl.rope(q_rope, pos, cfg.rope_theta)], dim=-1)[:, :, :hh]
        kv = (ckv @ p0["wkv_b"]).reshape(1, D["long_prompt"], H, -1)[:, :, :hh]
        k_ = torch.cat([kv[..., :cfg.qk_nope_dim],
                        tl.rope(k_rope, pos, cfg.rope_theta).expand(-1, -1, hh, -1)], dim=-1)
        v_ = kv[..., cfg.qk_nope_dim:]
        qg = q.float().reshape(1, D["long_prompt"], hh, 1, Dqk)
        kw = dict(causal=True, window=0, kv_valid_len=None, softcap=0.0)
        (flash_out, flash_s) = sync_s(lambda: tl._attention_flash(qg, k_.float(), v_.float(),
                                                                  **kw))
        (simple_out, simple_s) = sync_s(lambda: tl._attention_simple(
            qg, k_.float(), v_.float(), q_offset=0, **kw))
    check(tuple(flash_out.shape) == (1, D["long_prompt"], hh, 1, Dv), "the flash route's Dv")
    flash_err = compare(f"layer 0 MLA attention, flash vs simple route ({D['long_prompt']} "
                        f"tokens, heads 0-{hh - 1} of {H}, Dqk {Dqk}, Dv {Dv}, float32)",
                        [flash_out], [simple_out], rtol=2e-4, atol=2e-5,
                        why="tests/test_layers.py:38-41 gate")
    del x, hn, q, kv, k_, v_, qg, flash_out, simple_out, q_nope, q_rope, ckv, k_rope, lp0, p0
    report["serve"] = {
        "layers": cfg.n_layers, "experts": E, "params": n_b, "init_s": init_b_s,
        "batch": B_, "prompt_len": P, "gen": G,
        "prefill_first_ms": served["prefill_s"] * 1e3, "prefill_warm_ms": warm_prefill_ms,
        "decode_ms_per_token": served["decode_s_per_token"] * 1e3,
        "decode_warm_median_ms": warm_decode_ms, "tokens_per_s": served["tokens_per_s"],
        "decode_device_ms": dec_dev, "prefill_device_ms": pre_dev,
        "decode_idle_share": 1.0 - dec_dev / warm_decode_ms,
        "decode_idle_share_generate": 1.0 - dec_dev / (served["decode_s_per_token"] * 1e3),
        "prefill_idle_share": 1.0 - pre_dev / warm_prefill_ms,
        "param_bytes_held": held, "peak_bytes": serve_peak,
        "peak_above_weights": serve_peak - held, "held_before_bytes": base,
        "latent_cache_bytes": latent_bytes, "expanded_kv_bytes": expanded_bytes,
        "bound_decode_ms": bound_decode_ms, "decode_bytes": bytes_decode,
        "prefill_capacity": C_, "prefill_bf16_tflop": f_bf16 / 1e12,
        "prefill_f32_tflop": f_f32 / 1e12, "bound_prefill_ops_ms": bound_prefill_ops_ms,
        "bound_prefill_bytes_ms": bound_prefill_bytes_ms, "bound_prefill_ms": bound_prefill_ms,
        "consistency": consist,
        "long": {"prompt": D["long_prompt"], "prefill_first_ms": long_s[0] * 1e3,
                 "prefill_warm_ms": long_s[1] * 1e3, "prefill_device_ms": long_dev,
                 "layer0_flash_ms": flash_s * 1e3, "layer0_simple_ms": simple_s * 1e3,
                 "flash_heads": hh, "flash_vs_simple": flash_err}}
    print(f"[phase 15] {smi}: generate({cfg.arch_id} at {cfg.n_layers} layers, {E} experts, "
          f"{n_b / 1e9:.3f}e9 parameters, batch {B_}, prompt {P}, gen {G}): prefill "
          f"{served['prefill_s'] * 1e3:.2f} ms first, {warm_prefill_ms:.2f} ms warm (bound "
          f"{bound_prefill_ms:.3f} ms: operations {bound_prefill_ops_ms:.3f} ms, "
          f"{f_bf16 / 1e12:.3f} TFLOP bf16 with {E} x {C_} expert rows + "
          f"{f_f32 / 1e12:.4f} TFLOP float32; bytes {bound_prefill_bytes_ms:.3f} ms); decode "
          f"{served['decode_s_per_token'] * 1e3:.3f} ms a token in generate, "
          f"{warm_decode_ms:.3f} ms warm median a step (bound {bound_decode_ms:.3f} ms: "
          f"{bytes_decode / 1e9:.3f} GB at 3.35 TB/s); {served['tokens_per_s']:.1f} tok/s; "
          f"generate's peak {serve_peak / 1e9:.3f} GB, {(serve_peak - held) / 1e9:.3f} GB above "
          f"the {held / 1e9:.3f} GB of weights ({base / 1e9:.3f} GB held before); the latent "
          f"cache {latent_bytes / 1e6:.2f} MB where the expanded K/V would take "
          f"{expanded_bytes / 1e6:.2f} MB; device time from a CUDA graph: decode step "
          f"{dec_dev:.3f} ms (idle {100 * (1 - dec_dev / warm_decode_ms):.1f}% of the eager "
          f"step timed alone, {100 * (1 - dec_dev / (served['decode_s_per_token'] * 1e3)):.1f}% "
          f"of generate's, whose host runs ahead), prefill {pre_dev:.3f} ms (idle "
          f"{100 * (1 - pre_dev / warm_prefill_ms):.1f}%)")
    print(f"[phase 15] {smi}: {D['long_prompt']}-token prefill (flash route, {cfg.n_layers} "
          f"layers): {long_s[0] * 1e3:.2f} ms first, {long_s[1] * 1e3:.2f} ms warm, "
          f"{long_dev:.2f} ms of device time (CUDA graph); layer 0 attention on {hh} heads in "
          f"float32: flash {flash_s * 1e3:.2f} ms, simple {simple_s * 1e3:.2f} ms")
    del params, model, long
    gc.collect()
    torch.cuda.empty_cache()

    # -- (c) training at 4 layers with 32 experts ---------------------------------
    cfg_c = dataclasses.replace(full, n_layers=D["train_layers"], n_experts=D["train_experts"])
    E_c = cfg_c.n_experts
    S_ = D["train_seq"]
    model = get_model(cfg_c)
    n_c = cfg_c.param_count()
    state_bytes = 8 * n_c                 # bf16 weights, gradients, AdamW's m and v

    def act_bytes(b):
        """What a step holds beside the state, reckoned: each block's input
        (per-block remat, the MTP block's too), one block's recomputed
        float32 S x S scores, probabilities and their gradient, its expert
        buffers and their gradients (gathered rows, outputs, products: E x
        C slot rows), and a loss chunk's float32 logits, their softmax and
        gradient."""
        T = b * S_
        C = tmoe.capacity(T, cfg_c)
        return ((cfg_c.n_layers + cfg_c.mtp_depth) * T * cfg_c.d_model * 2
                + 3 * b * H * S_ * S_ * 4
                + 8 * E_c * C * cfg_c.d_model * 2 + 6 * E_c * C * cfg_c.d_expert * 2
                + 3 * b * min(cfg_c.logits_chunk, S_) * cfg_c.vocab * 4)

    free = torch.cuda.mem_get_info()[0]
    bt = D["train_batch"]
    while bt > 1 and state_bytes + act_bytes(bt) > free:
        bt //= 2
    print(f"[phase 15] (c) {cfg_c.n_layers} layers, {E_c} experts top-{cfg_c.top_k}, MTP "
          f"{cfg_c.mtp_depth}: {n_c / 1e9:.3f}e9 parameters; memory reckoned: weights, "
          f"gradients and AdamW state {state_bytes / 1e9:.2f} GB + a step's activations "
          f"{act_bytes(bt) / 1e9:.2f} GB at batch {bt} x {S_} (at {D['train_batch']}: "
          f"{act_bytes(D['train_batch']) / 1e9:.2f} GB); free {free / 1e9:.2f} GB")
    T_ = bt * S_
    C_ = tmoe.capacity(T_, cfg_c)
    # the products as the code runs them: forward, backward (twice the
    # forward), the blocks' remat forward and the loss chunks' recomputed
    # logits, the MTP head's included: in bfloat16 the projections, the
    # FFNs, the E x C routed and the shared expert rows, the MTP projection
    # and the two LM heads; in float32 the router and the S x S products
    n_blk = cfg_c.n_layers + cfg_c.mtp_depth
    n_moe = cfg_c.n_layers - cfg_c.moe_layer_start + cfg_c.mtp_depth
    f_blocks = (n_blk * 2.0 * attn_w * T_ + cfg_c.moe_layer_start * 6.0 * cfg_c.d_model
                * cfg_c.d_ff * T_ + n_moe * 6.0 * cfg_c.d_model * cfg_c.d_expert
                * (E_c * C_ + T_) + 2.0 * 2 * cfg_c.d_model * cfg_c.d_model * T_)
    f_unembed = 2 * 2.0 * cfg_c.vocab * cfg_c.d_model * T_
    f_attn = n_blk * 2.0 * bt * H * S_ * S_ * (Dqk + Dv)
    f_router = n_moe * 2.0 * T_ * cfg_c.d_model * E_c
    bf16_flop = 4.0 * (f_blocks + f_unembed)
    f32_flop = 4.0 * (f_attn + f_router)
    bound_ms = (bf16_flop / PEAK_BF16 + f32_flop / PEAK_F32) * 1e3
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    # the pieces launch/train.py's build assembles, at the cut depth
    params = model.init_params(D["seed"], device=dev)
    ocfg = optim.AdamWConfig(lr=optim.warmup_cosine(D["lr"], 20, 10_000))
    opt_state = optim.init(tlm.leaves(params), ocfg)
    step_fn = make_train_step(model, ocfg)
    stream = TokenStream(vocab=cfg_c.vocab, seq=S_, global_batch=bt, seed=D["seed"])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    held_c = torch.cuda.memory_allocated() - base
    watch = {k_: v.detach().clone() for k_, v in tlm.leaves(params).items()
             if k_ in ("final_norm", "dense_blocks.0.attn.q_ln", "moe_blocks.0.moe.router",
                       "moe_blocks.0.attn.wkv_b", "mtp_proj", "mtp_norm_e",
                       "mtp_blocks.0.moe.shared_wd")}
    emb_rows = params.tok_emb[:4096].detach().clone()
    auxes = []

    def step_rec(p, o, b):
        out = step_fn(p, o, b)
        auxes.append(out[2]["aux"])
        return out

    torch.cuda.reset_peak_memory_stats()
    params, opt_state, rep = train_loop(step_rec, params, opt_state,
                                        lambda s: stream.batch(s, device=dev),
                                        TrainLoopConfig(steps=D["train_steps"], ckpt_dir=None,
                                                        log_every=1, handle_signals=False),
                                        log_fn=lambda s: None)
    peak = torch.cuda.max_memory_allocated() - base
    hist = rep["history"]
    aux_v = [float(a) for a in auxes]
    check(len(hist) == D["train_steps"] and rep["final_step"] == D["train_steps"],
          "(c) ran every step")
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist)
          and all(math.isfinite(a) and a > 0 for a in aux_v),
          "(c) every loss, aux and grad norm finite, aux > 0")
    moved = {k_: not torch.equal(v, tlm.leaves(params)[k_]) for k_, v in watch.items()}
    moved["tok_emb[:4096]"] = not torch.equal(emb_rows, params.tok_emb[:4096])
    check(all(moved.values()), f"(c) the parameters moved: {moved}")
    secs = [h["sec_per_step"] for h in hist]
    warm = statistics.median(secs[1:])
    report["train"] = {
        "layers": cfg_c.n_layers, "experts": E_c, "params": n_c,
        "batch": bt, "seq": S_, "steps": D["train_steps"], "capacity": C_,
        "build_s": build_s, "first_step_s": secs[0], "warm_median_s": warm,
        "warm_min_s": min(secs[1:]), "warm_max_s": max(secs[1:]), "tokens_per_s": T_ / warm,
        "losses": [h["loss"] for h in hist], "aux": aux_v,
        "grad_norms": [h["grad_norm"] for h in hist], "stragglers": rep["stragglers"],
        "held_bytes": held_c, "peak_bytes": peak, "peak_above_state": peak - held_c,
        "held_before_bytes": base, "reckoned_state_bytes": state_bytes,
        "reckoned_act_bytes": act_bytes(bt), "bf16_tflop": bf16_flop / 1e12,
        "f32_tflop": f32_flop / 1e12, "bound_ms": bound_ms}
    print(f"[phase 15] {smi}: train({cfg_c.arch_id} at {cfg_c.n_layers} layers, {E_c} "
          f"experts, batch {bt} x {S_}, {D['train_steps']} steps, {E_c} x {C_} expert rows a "
          f"layer): first step {secs[0]:.3f} s, warm median {warm * 1e3:.1f} ms "
          f"({min(secs[1:]) * 1e3:.1f}-{max(secs[1:]) * 1e3:.1f}), {T_ / warm:.0f} tokens/s; "
          f"loss (MTP term in) {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, aux "
          f"{aux_v[0]:.5f} -> {aux_v[-1]:.5f}; bound {bound_ms:.1f} ms ({bf16_flop / 1e12:.2f} "
          f"TFLOP bf16 at 989 TFLOP/s + {f32_flop / 1e12:.2f} TFLOP float32 at 67 TFLOP/s); "
          f"model and AdamW state held {held_c / 1e9:.3f} GB, the steps' peak "
          f"{(peak - held_c) / 1e9:.3f} GB above it ({base / 1e9:.3f} GB held before); built "
          f"in {build_s:.1f} s")
    del params, opt_state, step_fn, model, watch, emb_rows, auxes
    gc.collect()
    torch.cuda.empty_cache()

    # -- (d) checkpoint and restart on the SMOKE config ---------------------------
    cfg_d = ARCHS[D["arch"]].SMOKE
    m_d = get_model(cfg_d)
    stream_d = TokenStream(vocab=cfg_d.vocab, seq=D["ckpt_seq"], global_batch=D["ckpt_batch"],
                           seed=D["seed"])

    def fresh():
        p = m_d.init_params(D["seed"], device=dev)
        return (p, optim.init(tlm.leaves(p), ocfg), make_train_step(m_d, ocfg),
                lambda s: stream_d.batch(s, device=dev))

    report["restart"] = {"config": cfg_d.arch_id, **restart_bitwise(
        15, f"{cfg_d.arch_id}, batch {D['ckpt_batch']} x {D['ckpt_seq']}, the MTP leaves in "
            f"the reference's tree", D, fresh,
        tops={"dense_blocks", "final_norm", "lm_head", "moe_blocks", "mtp_blocks", "mtp_norm_e",
              "mtp_norm_h", "mtp_proj", "tok_emb"})}
    check(ops.launch_counts() == NO_LAUNCHES,
          f"the MLA path launched a kernel: {ops.launch_counts()}")
    gc.collect()
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    print("[phase 15] " + json.dumps(report))
    print(f"[phase 15] took {report['seconds']:.1f} s")
    return report


# phase 16, ROADMAP A8 (the SSM and hybrid families): mamba2-130m
# (repro_torch/configs/mamba2_130m.py: 24 layers, d_model 768, 24 SSD heads
# of 64, state 128, chunk 256, vocab 50,280, tied) and zamba2-7b
# (configs/zamba2_7b.py: 81 mamba layers, d_model 3,584, 112 heads of 64,
# state 64, as 6 groups of 13 and a tail of 3, one shared attention + MLP
# block of 32 heads and d_ff 14,336 before each group, vocab 32,000), bf16,
# random weights from a seed; (a) the card against the CPU with the depth
# cut (mamba2 at 2 layers; zamba2 at 2 groups of 1 and a tail of 1, so the
# shared block runs twice), a 300-token prompt (two chunks, the second
# padded) and the loss at 1 x 128; (b) both uncut through generate at batch
# 4, prompt 256, 32 tokens, and a 32,768-token mamba2 prompt; (c) both
# uncut through launch.train.build + train_loop at 4 x 1,024; (d) restarts
# on the SMOKE configs
SSMS = dict(mamba="mamba2-130m", zamba="zamba2-7b", cpu_mamba_layers=2, cpu_groups=2,
            cpu_group_len=1, cpu_tail=1, cpu_batch=1, cpu_prompt=300, cpu_steps=8,
            cpu_loss_batch=1, cpu_loss_seq=128, batch=4, prompt_len=256, gen=32,
            long_prompt=32768, reckon_context=524288, train_batch=4, train_seq=1024,
            mamba_train_steps=20, zamba_train_steps=8, ckpt_steps=10, ckpt_at=5,
            ckpt_every=3, ckpt_seq=64, ckpt_batch=2, lr=3e-4, seed=0)


def ssm_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase16(dev, smi, compare) -> dict:
    """The LM half's SSM and hybrid families on the card, mamba2-130m and
    zamba2-7b: (a) card against the port's CPU run at full width with the
    depth cut (mamba2 at 2 layers; zamba2 at 2 groups of 1 layer and a
    tail of 1, the shared block run twice): the prefill of a 300-token
    prompt (two SSD chunks, the second padded) and 8 decode steps on the
    CPU's greedy tokens, then the loss and every gradient entry (the shared
    block's summed over its two invocations) at 1 x 128; gate twice the
    CPU's own bfloat16-vs-float32 distance; (b) both uncut through
    ``launch.serve.generate`` at batch 4, prompt 256, 32 tokens: prefill
    first and warm, decode ms a token, a decode step's and a prefill's
    device time from a CUDA graph and the idle share, peak above the
    weights, the cache's bytes, beside the bounds; prefill(256) + decode
    against prefill(257) at 0.15 on the same weights in float32, the
    bfloat16 distances and their float32 witnesses printed (the
    reference's bfloat16 SSD, ROADMAP C10); a 32,768-token mamba2 prefill whose
    cache has the 256-token prompt's bytes; zamba2's cache at 524,288
    tokens reckoned; (c) both uncut through ``launch.train.build`` and
    ``train_loop`` at 4 x 1,024 (mamba2 20 steps, zamba2 8; the memory
    reckoned first, the batch halved until it fits), warm step ms,
    tokens/s, peak above the model and AdamW state, a falling loss, beside
    the step's bound; (d) on both SMOKE configs, two straight runs, a
    restart from an async checkpoint and the checkpoint itself, bitwise.
    TF32 checked off; no kernel of this repository runs there (launch
    counts 0)."""
    import copy

    import numpy as np
    import torch

    from repro_torch import optim
    from repro_torch.configs import ARCHS
    from repro_torch.data import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import get_model
    from repro_torch.models import lm as tlm
    from repro_torch.runtime import TrainLoopConfig, train_loop

    t_phase = time.perf_counter()
    D = SSMS
    fm, fz = ARCHS[D["mamba"]].CONFIG, ARCHS[D["zamba"]].CONFIG
    check(fm.family == "ssm" and fm.n_layers == 24 and fm.d_model == 768 and fm.d_inner == 1536
          and fm.ssm_heads == 24 and fm.ssm_headdim == 64 and fm.ssm_state == 128
          and fm.ssm_chunk == 256 and fm.ssm_conv == 4 and fm.vocab == 50280
          and fm.tie_embeddings and fm.dtype == "bfloat16" and fm.remat,
          "phase 16 runs mamba2-130m's published configuration")
    check(fz.family == "hybrid" and fz.hybrid_groups == 6 and fz.hybrid_group_len == 13
          and fz.hybrid_tail == 3 and fz.d_model == 3584 and fz.d_inner == 7168
          and fz.ssm_heads == 112 and fz.ssm_state == 64 and fz.n_heads == 32
          and fz.n_kv_heads == 32 and fz.d_ff == 14336 and fz.vocab == 32000
          and not fz.tie_embeddings and fz.dtype == "bfloat16" and fz.remat,
          "phase 16 runs zamba2-7b's published configuration")
    prec = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    check(prec == ("highest", False), f"TF32 is on for float32 products: {prec}")
    free, total = torch.cuda.mem_get_info()
    report = {"card": smi, "free_bytes_at_start": free,
              "held_at_start": torch.cuda.memory_allocated(), "matmul_precision": prec[0]}
    print(f"[phase 16] {smi}: {fm.arch_id} ({fm.n_layers} layers, d_model {fm.d_model}, "
          f"{fm.ssm_heads} SSD heads of {fm.ssm_headdim}, state {fm.ssm_state}, chunk "
          f"{fm.ssm_chunk}, vocab {fm.vocab}) and {fz.arch_id} ({fz.hybrid_groups} groups of "
          f"{fz.hybrid_group_len} mamba layers + a tail of {fz.hybrid_tail}, d_model "
          f"{fz.d_model}, {fz.ssm_heads} SSD heads, state {fz.ssm_state}, one shared block of "
          f"{fz.n_heads} heads and d_ff {fz.d_ff}, vocab {fz.vocab}), {fz.dtype}; the card's "
          f"free memory {free / 1e9:.2f} GB of {total / 1e9:.2f} GB, earlier phases hold "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    ops.reset_launch_counts()

    def reads(params, cfg):
        """The parameter bytes a serving call reads: all of them but an
        untied embedding table (a gather of a few rows)."""
        return sum(p.numel() * p.element_size() for n, p in params.named_parameters()
                   if cfg.tie_embeddings or n != "tok_emb")

    # -- (a) the card against the port's CPU run, the depth cut -------------
    # without the per-block remat, which gives the same values bitwise
    # (tests/test_torch_lm_ssm.py::test_ssm_remat_on_and_off_agree) and
    # spares the CPU's gradients a second forward pass; (c) trains with it
    cuts = {"mamba": dataclasses.replace(fm, n_layers=D["cpu_mamba_layers"], remat=False),
            "zamba": dataclasses.replace(
                fz, hybrid_groups=D["cpu_groups"], hybrid_group_len=D["cpu_group_len"],
                hybrid_tail=D["cpu_tail"],
                n_layers=D["cpu_groups"] * D["cpu_group_len"] + D["cpu_tail"], remat=False)}
    report["card_vs_cpu"] = {}
    rng = np.random.default_rng(D["seed"])
    shared = ("shared_attn.ln1", "shared_attn.attn.wq", "shared_attn.mlp.wd")
    for key, cfg_a in cuts.items():
        # zamba2's shared block: its gradient is summed over its two invocations
        report["card_vs_cpu"][key] = card_vs_cpu(
            dev, compare, 16, cfg_a, f"{cfg_a.n_layers} mamba layers"
            f"{', the shared block twice' if key == 'zamba' else ''}", D, rng,
            watch=lambda n: key == "zamba" and n in shared)

    # -- (b) serving, both uncut ----------------------------------------------
    B_, P, G = D["batch"], D["prompt_len"], D["gen"]
    cap = P + G
    report["serve"] = {}
    for key, cfg in (("mamba", fm), ("zamba", fz)):
        model = get_model(cfg)
        base = torch.cuda.memory_allocated()
        params, init_s = sync_s(lambda: model.init_params(D["seed"], device=dev))
        held = ssm_bytes(params.parameters())
        n_b = nparams(params)
        toks = torch.from_numpy(np.random.default_rng(D["seed"]).integers(
            0, cfg.vocab, size=(B_, P + 1))).to(dev)
        torch.cuda.reset_peak_memory_stats()
        served = tserve.generate(model, params, toks[:, :P], G)
        serve_peak = torch.cuda.max_memory_allocated() - base
        check(served["generated"].shape == (B_, G)
              and ((served["generated"] >= 0) & (served["generated"] < cfg.vocab)).all(),
              f"generate's tokens ({cfg.arch_id})")
        with torch.no_grad():
            pre_s = []
            for _ in range(3):
                (logits, cache), s_ = sync_s(lambda: model.prefill(
                    params, {"tokens": toks[:, :P]}, cache_len=cap))
                pre_s.append(s_)
            cache_bytes = ssm_bytes(cache.values())
            tok = torch.argmax(logits, -1)[:, None]
            dec_s = []
            for i in range(G):
                (logits_d, cache), s_ = sync_s(lambda: model.decode_step(
                    params, {"token": tok, "pos": P + i}, cache))
                dec_s.append(s_)
                tok = torch.argmax(logits_d, -1)[:, None]
        check(bool(torch.isfinite(logits).all() and torch.isfinite(logits_d).all()),
              f"non-finite {cfg.arch_id} logits")
        warm_prefill_ms = statistics.median(pre_s[1:]) * 1e3
        warm_decode_ms = statistics.median(dec_s) * 1e3
        dec_dev = graph_device_ms(lambda: model.decode_step(
            params, {"token": tok, "pos": P}, cache))
        pre_dev = graph_device_ms(lambda: model.prefill(
            params, {"tokens": toks[:, :P]}, cache_len=cap))
        # a decode step reads the weights it uses and the cache (the
        # attention's valid K/V, each SSM state and conv window read and
        # written); a prefill's bf16 products: 2 x its weights a token (the
        # LM head for the last position only), SSD's chunk products and
        # the shared block's S x S float32 attention; and its bytes
        state_bytes = ssm_bytes(v for k, v in cache.items() if not k.startswith("attn"))
        kv_bytes = (cfg.hybrid_groups * B_ * (P + G // 2) * 2 * cfg.n_kv_heads * cfg.head_dim
                    * 2 if key == "zamba" else 0)
        read = reads(params, cfg)
        bytes_decode = read + kv_bytes + 2 * state_bytes
        bound_decode_ms = bytes_decode / PEAK_BYTES * 1e3
        T_ = B_ * P
        head = cfg.vocab * cfg.d_model
        body = n_b - head * (1 if cfg.tie_embeddings else 2)
        n_m = (cfg.n_layers if key == "mamba" else
               cfg.hybrid_groups * cfg.hybrid_group_len + cfg.hybrid_tail)
        q, nc = cfg.ssm_chunk, -(-P // cfg.ssm_chunk)
        ssd = n_m * 2.0 * B_ * nc * cfg.ssm_heads * q * q * (cfg.ssm_state + cfg.ssm_headdim)
        f_bf16 = 2.0 * body * T_ + 2.0 * head * B_ + ssd
        f_f32 = (cfg.hybrid_groups * 2.0 * 2 * B_ * cfg.n_heads * P * P * cfg.head_dim
                 if key == "zamba" else 0.0)
        bound_prefill_ops_ms = (f_bf16 / PEAK_BF16 + f_f32 / PEAK_F32) * 1e3
        bound_prefill_bytes_ms = (read + cache_bytes) / PEAK_BYTES * 1e3
        bound_prefill_ms = max(bound_prefill_ops_ms, bound_prefill_bytes_ms)
        del cache, logits, logits_d
        torch.cuda.empty_cache()

        # tests/test_arch_smoke.py:65-83 at full size, held on the same
        # weights in float32: in bfloat16 the reference's SSD takes the
        # cumulative sum of dA over a 256-long chunk and the exp of its
        # differences in bfloat16 (ROADMAP section C, C10), so the chunked
        # prefill(257) sits far from its float32 twin while the float32
        # decode step does not; the bfloat16 distances are printed beside
        def consistency(m, p):
            with torch.no_grad():
                _, c1 = m.prefill(p, {"tokens": toks[:, :P]}, cache_len=P + 1)
                ld, _ = m.decode_step(p, {"token": toks[:, P:], "pos": P}, c1)
                del c1
                lf, _ = m.prefill(p, {"tokens": toks})
            return ld.float().cpu(), lf.float().cpu()

        ld, lf = consistency(model, params)
        p32 = copy.deepcopy(params).float()
        ld32, lf32 = consistency(get_model(dataclasses.replace(cfg, dtype="float32")), p32)
        del p32
        torch.cuda.empty_cache()
        consist = compare(f"{cfg.arch_id} prefill({P}) + decode_step vs prefill({P + 1}) "
                          f"(last-token logits, {n_m} mamba layers, batch {B_}, the weights in "
                          f"float32)", [ld32], [lf32], rtol=0.15, atol=0.15,
                          why="tests/test_arch_smoke.py:81-83 gate")
        bf16_gap = {"decode_vs_prefill": float((ld - lf).abs().max()),
                    "prefill_vs_float32": float((lf - lf32).abs().max()),
                    "decode_vs_float32": float((ld - ld32).abs().max())}
        print(f"[phase 16] {cfg.arch_id} in bfloat16 (ungated, C10): prefill({P}) + decode vs "
              f"prefill({P + 1}) {bf16_gap['decode_vs_prefill']:.4f}; prefill({P + 1}) vs its "
              f"float32 twin {bf16_gap['prefill_vs_float32']:.4f}; the decode step vs its "
              f"float32 twin {bf16_gap['decode_vs_float32']:.4f}")
        rec = {"params": n_b, "init_s": init_s, "batch": B_, "prompt_len": P, "gen": G,
               "prefill_first_ms": served["prefill_s"] * 1e3, "prefill_warm_ms": warm_prefill_ms,
               "decode_ms_per_token": served["decode_s_per_token"] * 1e3,
               "decode_warm_median_ms": warm_decode_ms, "tokens_per_s": served["tokens_per_s"],
               "decode_device_ms": dec_dev, "prefill_device_ms": pre_dev,
               "decode_idle_share": 1.0 - dec_dev / warm_decode_ms,
               "decode_idle_share_generate": 1.0 - dec_dev / (served["decode_s_per_token"] * 1e3),
               "prefill_idle_share": 1.0 - pre_dev / warm_prefill_ms,
               "param_bytes_held": held, "peak_bytes": serve_peak,
               "peak_above_weights": serve_peak - held, "held_before_bytes": base,
               "cache_bytes": cache_bytes, "cache_state_bytes": state_bytes,
               "decode_bytes": bytes_decode, "bound_decode_ms": bound_decode_ms,
               "prefill_bf16_tflop": f_bf16 / 1e12, "prefill_f32_tflop": f_f32 / 1e12,
               "bound_prefill_ops_ms": bound_prefill_ops_ms,
               "bound_prefill_bytes_ms": bound_prefill_bytes_ms,
               "bound_prefill_ms": bound_prefill_ms, "consistency_max_abs_err_f32": consist,
               "consistency_bf16": bf16_gap}
        print(f"[phase 16] {smi}: generate({cfg.arch_id}, {n_m} mamba layers, "
              f"{n_b / 1e9:.3f}e9 parameters, batch {B_}, prompt {P}, gen {G}): prefill "
              f"{served['prefill_s'] * 1e3:.2f} ms first, {warm_prefill_ms:.2f} ms warm (bound "
              f"{bound_prefill_ms:.3f} ms: operations {bound_prefill_ops_ms:.3f} ms, "
              f"{f_bf16 / 1e12:.3f} TFLOP bf16 + {f_f32 / 1e12:.4f} TFLOP float32; bytes "
              f"{bound_prefill_bytes_ms:.3f} ms); decode {served['decode_s_per_token'] * 1e3:.3f} "
              f"ms a token in generate, {warm_decode_ms:.3f} ms warm median a step (bound "
              f"{bound_decode_ms:.3f} ms: {bytes_decode / 1e9:.3f} GB at 3.35 TB/s); "
              f"{served['tokens_per_s']:.1f} tok/s; generate's peak {serve_peak / 1e9:.3f} GB, "
              f"{(serve_peak - held) / 1e9:.3f} GB above the {held / 1e9:.3f} GB of weights "
              f"({base / 1e9:.3f} GB held before); the cache {cache_bytes / 1e6:.2f} MB "
              f"({state_bytes / 1e6:.2f} MB of SSM states and conv windows); device time from a "
              f"CUDA graph: decode step {dec_dev:.3f} ms (idle "
              f"{100 * (1 - dec_dev / warm_decode_ms):.1f}% of the step timed alone, "
              f"{100 * (1 - dec_dev / (served['decode_s_per_token'] * 1e3)):.1f}% of "
              f"generate's), prefill {pre_dev:.3f} ms (idle "
              f"{100 * (1 - pre_dev / warm_prefill_ms):.1f}%)")
        if key == "mamba":
            # the O(1)-state cache: a 32,768-token prompt's is the 256-token one's
            with torch.no_grad():
                _, short = model.prefill(params, {"tokens": toks[:1, :P]})
                long = torch.from_numpy(np.random.default_rng(D["seed"] + 1).integers(
                    0, cfg.vocab, size=(1, D["long_prompt"]))).to(dev)
                torch.cuda.reset_peak_memory_stats()
                base_l = torch.cuda.memory_allocated()
                long_s = []
                for _ in range(2):
                    (ll, lc), s_ = sync_s(lambda: model.prefill(params, {"tokens": long}))
                    long_s.append(s_)
                long_peak = torch.cuda.max_memory_allocated() - base_l
            check(bool(torch.isfinite(ll).all()), "non-finite long-prompt logits")
            check(ssm_bytes(lc.values()) == ssm_bytes(short.values()),
                  f"the {D['long_prompt']}-token prompt's cache ({ssm_bytes(lc.values())} B) is "
                  f"not the {P}-token prompt's ({ssm_bytes(short.values())} B)")
            rec["long"] = {"prompt": D["long_prompt"], "prefill_first_ms": long_s[0] * 1e3,
                           "prefill_warm_ms": long_s[1] * 1e3, "peak_bytes": long_peak,
                           "cache_bytes": ssm_bytes(lc.values())}
            print(f"[phase 16] {smi}: {cfg.arch_id} prefill of 1 x {D['long_prompt']} tokens: "
                  f"{long_s[0] * 1e3:.2f} ms first, {long_s[1] * 1e3:.2f} ms warm, peak "
                  f"{long_peak / 1e9:.3f} GB; its cache {ssm_bytes(lc.values())} B = the "
                  f"{P}-token prompt's")
            del short, long, ll, lc
        else:
            ctx = D["reckon_context"]
            kv_long = cfg.hybrid_groups * 2 * ctx * cfg.n_kv_heads * cfg.head_dim * 2
            rec["reckoned_kv_bytes_at"] = {str(ctx): kv_long}
            print(f"[phase 16] {cfg.arch_id}: at {ctx} tokens (batch 1) the shared block's K/V "
                  f"would take {cfg.hybrid_groups} x 2 x {ctx} x {cfg.n_kv_heads} x "
                  f"{cfg.head_dim} x 2 B = {kv_long / 1e9:.1f} GB beside "
                  f"{state_bytes / B_ / 1e6:.1f} MB of states a sequence (reckoned, not run)")
        report["serve"][key] = rec
        del params, model, toks
        gc.collect()
        torch.cuda.empty_cache()

    # -- (c) training, both uncut ---------------------------------------------
    S_ = D["train_seq"]
    report["train"] = {}
    for key, cfg, steps in (("mamba", fm, D["mamba_train_steps"]),
                            ("zamba", fz, D["zamba_train_steps"])):
        n_c = cfg.param_count()
        state_bytes = 8 * n_c           # bf16 weights, gradients, AdamW's m and v
        n_blk = (cfg.n_layers if key == "mamba" else
                 cfg.hybrid_groups * (cfg.hybrid_group_len + 1) + cfg.hybrid_tail)
        n_m = (cfg.n_layers if key == "mamba" else
               cfg.hybrid_groups * cfg.hybrid_group_len + cfg.hybrid_tail)

        def act_bytes(b):
            """What a step holds beside the state, reckoned: each block's
            input (per-block remat), one mamba block's recomputed
            projections and SSD tiles (decay, scores and their product,
            their gradients: 6 (b, c, h, q, q) tensors) or the shared
            block's float32 S x S scores, probabilities and gradient, and a
            loss chunk's float32 logits, their softmax and gradient."""
            T = b * S_
            mamba = (6 * b * (-(-S_ // cfg.ssm_chunk)) * cfg.ssm_heads * cfg.ssm_chunk ** 2 * 2
                     + 8 * T * (2 * cfg.d_inner) * 2)
            attn = 3 * b * cfg.n_heads * S_ * S_ * 4 if key == "zamba" else 0
            return (n_blk * T * cfg.d_model * 2 + max(mamba, attn)
                    + 3 * b * min(cfg.logits_chunk, S_) * cfg.vocab * 4)

        free = torch.cuda.mem_get_info()[0]
        bt = D["train_batch"]
        while bt > 1 and state_bytes + act_bytes(bt) > free:
            bt //= 2
        cut = "" if bt == D["train_batch"] else f" (cut from {D['train_batch']} to fit)"
        print(f"[phase 16] (c) {cfg.arch_id}: {n_c / 1e9:.3f}e9 parameters; memory reckoned: "
              f"weights, gradients and AdamW state {state_bytes / 1e9:.2f} GB + a step's "
              f"activations {act_bytes(bt) / 1e9:.2f} GB at batch {bt} x {S_}{cut}; free "
              f"{free / 1e9:.2f} GB")
        T_ = bt * S_
        head = cfg.vocab * cfg.d_model
        body = n_c - head * (1 if cfg.tie_embeddings else 2)
        ssd = n_m * 2.0 * bt * (S_ // cfg.ssm_chunk) * cfg.ssm_heads * cfg.ssm_chunk ** 2 * (
            cfg.ssm_state + cfg.ssm_headdim)
        # forward, backward (twice the forward), the blocks' remat forward
        # and the loss chunks' recomputed logits: 4 forwards of each
        bf16_flop = 4.0 * (2.0 * body * T_ + 2.0 * head * T_ + ssd)
        f32_flop = (4.0 * cfg.hybrid_groups * 2.0 * 2 * bt * cfg.n_heads * S_ * S_ * cfg.head_dim
                    if key == "zamba" else 0.0)
        bound_ms = (bf16_flop / PEAK_BF16 + f32_flop / PEAK_F32) * 1e3
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        cfg_b, model, params, opt_state, step_fn, stream, extras, _ = ttrain.build(
            cfg.arch_id, smoke=False, batch=bt, seq=S_, lr=D["lr"], seed=D["seed"], device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(cfg_b == cfg, f"build's config is {cfg.arch_id}'s")
        held_c = torch.cuda.memory_allocated() - base
        watch_names = ([n for n in tlm.leaves(params) if n.endswith(("ssm.A_log", "ssm.in_x"))][:2]
                       + ["final_norm"] + (["shared_attn.attn.wq", "shared_attn.ln1"]
                                           if key == "zamba" else []))
        watch = {k_: tlm.leaves(params)[k_].detach().clone() for k_ in watch_names}
        torch.cuda.reset_peak_memory_stats()
        params, opt_state, rep = train_loop(
            step_fn, params, opt_state, lambda s: stream.batch(s, extras, device=dev),
            TrainLoopConfig(steps=steps, ckpt_dir=None, log_every=1, handle_signals=False),
            log_fn=lambda s: None)
        peak = torch.cuda.max_memory_allocated() - base
        hist = rep["history"]
        check(len(hist) == steps and rep["final_step"] == steps,
              f"(c) {cfg.arch_id} ran every step")
        check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist),
              f"(c) {cfg.arch_id}: every loss and grad norm finite")
        check(hist[-1]["loss"] < hist[0]["loss"],
              f"(c) {cfg.arch_id}: the loss did not fall ({hist[0]['loss']} -> {hist[-1]['loss']})")
        moved = {k_: not torch.equal(v, tlm.leaves(params)[k_]) for k_, v in watch.items()}
        check(all(moved.values()), f"(c) {cfg.arch_id}: the parameters moved: {moved}")
        secs = [h["sec_per_step"] for h in hist]
        warm = statistics.median(secs[1:])
        report["train"][key] = {
            "params": n_c, "batch": bt, "batch_cut": bt != D["train_batch"], "seq": S_,
            "steps": steps, "build_s": build_s, "first_step_s": secs[0], "warm_median_s": warm,
            "warm_min_s": min(secs[1:]), "warm_max_s": max(secs[1:]), "tokens_per_s": T_ / warm,
            "losses": [h["loss"] for h in hist], "grad_norms": [h["grad_norm"] for h in hist],
            "stragglers": rep["stragglers"], "held_bytes": held_c, "peak_bytes": peak,
            "peak_above_state": peak - held_c, "held_before_bytes": base,
            "reckoned_state_bytes": state_bytes, "reckoned_act_bytes": act_bytes(bt),
            "bf16_tflop": bf16_flop / 1e12, "f32_tflop": f32_flop / 1e12, "bound_ms": bound_ms}
        print(f"[phase 16] {smi}: train({cfg.arch_id}, build(smoke=False), batch {bt} x {S_}"
              f"{cut}, {steps} steps): first step {secs[0]:.3f} s, warm median {warm * 1e3:.1f} "
              f"ms ({min(secs[1:]) * 1e3:.1f}-{max(secs[1:]) * 1e3:.1f}), {T_ / warm:.0f} "
              f"tokens/s; loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; bound "
              f"{bound_ms:.1f} ms ({bf16_flop / 1e12:.2f} TFLOP bf16 at 989 TFLOP/s + "
              f"{f32_flop / 1e12:.3f} TFLOP float32 at 67 TFLOP/s, remat included); model and "
              f"AdamW state held {held_c / 1e9:.3f} GB, the steps' peak "
              f"{(peak - held_c) / 1e9:.3f} GB above it ({base / 1e9:.3f} GB held before); built "
              f"in {build_s:.1f} s")
        del params, opt_state, step_fn, model, watch, stream
        gc.collect()
        torch.cuda.empty_cache()

    # -- (d) checkpoint and restart on the SMOKE configs -------------------------
    report["restart"] = {}
    ocfg = optim.AdamWConfig(lr=optim.warmup_cosine(D["lr"], 20, 10_000))
    tops = {"mamba": {"blocks", "final_norm", "tok_emb"},
            "zamba": {"final_norm", "lm_head", "mamba_groups", "mamba_tail", "shared_attn",
                      "tok_emb"}}
    for key in ("mamba", "zamba"):
        cfg_d = ARCHS[D[key]].SMOKE
        m_d = get_model(cfg_d)
        stream_d = TokenStream(vocab=cfg_d.vocab, seq=D["ckpt_seq"],
                               global_batch=D["ckpt_batch"], seed=D["seed"])

        def fresh():
            p = m_d.init_params(D["seed"], device=dev)
            return (p, optim.init(tlm.leaves(p), ocfg), make_train_step(m_d, ocfg),
                    lambda s: stream_d.batch(s, device=dev))

        report["restart"][key] = {"config": cfg_d.arch_id, **restart_bitwise(
            16, f"{cfg_d.arch_id}, batch {D['ckpt_batch']} x {D['ckpt_seq']}", D, fresh,
            tops=tops[key])}
    check(ops.launch_counts() == NO_LAUNCHES,
          f"the SSM and hybrid paths launched a kernel: {ops.launch_counts()}")
    gc.collect()
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    print("[phase 16] " + json.dumps(report))
    print(f"[phase 16] took {report['seconds']:.1f} s")
    return report


# phase 17, ROADMAP A8 (audio and VLM): whisper-small
# (repro_torch/configs/whisper_small.py: 12 encoder + 12 decoder layers,
# d_model 768, 12 heads, d_ff 3,072, vocab 51,865, 1,500 frames, tied
# embeddings) and llama-3.2-vision-11b (llama32_vision_11b.py: 8 groups of
# 1 gated cross block + 4 self blocks, d_model 4,096, 32/8 heads of 128,
# d_ff 14,336, vocab 128,256, 1,601 image tokens, RoPE 500,000), bfloat16,
# random weights from a seed, the cross blocks' gates set to GATES (zero at
# init, where the image would change no logit); (c) trains the VLM at a
# fixed 5 of its 8 groups (full width): its weights, gradients and AdamW
# state at 8 B a parameter and a step's activations, reckoned, fit beside
# the ~3.9 GB that the earlier phases of this script still hold, where 6
# groups do not
AV = dict(audio="whisper-small", vlm="llama-3.2-vision-11b", cpu_enc_layers=2,
          cpu_dec_layers=2, cpu_groups=1, cpu_cross_every=4, cpu_batch=1, cpu_prompt=64,
          cpu_steps=8, cpu_loss_batch=1, cpu_loss_seq=128, batch=4, prompt_len=64, gen=32,
          train_batch=4, train_seq=1024, audio_train_steps=20, vlm_train_steps=8,
          vlm_train_groups=5, ckpt_steps=10, ckpt_at=5, ckpt_every=3, ckpt_seq=64,
          ckpt_batch=2, lr=3e-4, seed=0)
GATES = (0.6, -0.45)     # gate_attn, gate_mlp: tanh 0.54 and -0.42


def set_gates(params) -> None:
    """Each cross block's gates to ``GATES`` (the model's own, in place)."""
    import torch

    with torch.no_grad():
        for blk in getattr(params, "cross_blocks", []):
            blk.gate_attn.fill_(GATES[0])
            blk.gate_mlp.fill_(GATES[1])


def phase17(dev, smi, compare) -> dict:
    """The LM half's audio and VLM families on the card, whisper-small and
    llama-3.2-vision-11b, the cross blocks' gates set to ``GATES``: (a) card
    against the port's CPU run at full width with the depth cut (whisper at
    2 encoder + 2 decoder layers on the published 1,500 frames; the VLM at
    one group, 1 cross block + ``cpu_cross_every`` self blocks, on the
    published 1,601 image tokens): the prefill of a 64-token prompt and 8
    decode steps on the CPU's greedy tokens, then the loss and every
    gradient entry at 1 x 128; gate twice the CPU's own bfloat16-vs-float32
    distance; (b) both uncut through ``launch.serve.generate`` at batch 4,
    prompt 64, 32 tokens: prefill first and warm, decode ms a token, a
    decode step's and a prefill's device time from a CUDA graph and the
    idle share, peak above the weights, the cache's bytes, beside the
    bounds; prefill(64) + decode against prefill(65) at 0.15; (c) both
    through ``train_loop`` at 4 x 1,024 (whisper uncut from
    ``launch.train.build(smoke=False)``, 20 steps; the VLM 8 steps at
    ``vlm_train_groups`` of its 8 groups, from the pieces ``build``
    assembles, the phase failing if its reckoned memory does not fit), warm
    step ms, tokens/s, peak above the model and AdamW state, a falling
    loss, beside the step's bound; (d) on
    both SMOKE configs, two straight runs, a restart from an async
    checkpoint and the checkpoint itself, bitwise.  TF32 checked off; no
    kernel of this repository runs there (launch counts 0)."""
    import copy

    import numpy as np
    import torch

    from repro_torch import optim
    from repro_torch.configs import ARCHS
    from repro_torch.data import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import get_model
    from repro_torch.models import lm as tlm
    from repro_torch.runtime import TrainLoopConfig, train_loop

    t_phase = time.perf_counter()
    D = AV
    fa, fv = ARCHS[D["audio"]].CONFIG, ARCHS[D["vlm"]].CONFIG
    check(fa.family == "audio" and fa.n_layers == 12 and fa.n_enc_layers == 12
          and fa.d_model == 768 and fa.n_heads == 12 and fa.d_ff == 3072 and fa.vocab == 51865
          and fa.enc_len == 1500 and fa.tie_embeddings and not fa.mlp_gated
          and fa.dtype == "bfloat16" and fa.remat,
          "phase 17 runs whisper-small's published configuration")
    check(fv.family == "vlm" and fv.n_layers == 40 and fv.cross_every == 4
          and fv.d_model == 4096 and fv.n_heads == 32 and fv.n_kv_heads == 8
          and fv.head_dim == 128 and fv.d_ff == 14336 and fv.vocab == 128256
          and fv.n_img_tokens == 1601 and fv.rope_theta == 500000.0
          and not fv.tie_embeddings and fv.dtype == "bfloat16" and fv.remat,
          "phase 17 runs llama-3.2-vision-11b's published configuration")
    prec = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    check(prec == ("highest", False), f"TF32 is on for float32 products: {prec}")
    free, total = torch.cuda.mem_get_info()
    report = {"card": smi, "free_bytes_at_start": free, "gates": GATES,
              "held_at_start": torch.cuda.memory_allocated(), "matmul_precision": prec[0]}
    print(f"[phase 17] {smi}: {fa.arch_id} ({fa.n_enc_layers} encoder + {fa.n_layers} decoder "
          f"layers, d_model {fa.d_model}, {fa.n_heads} heads, d_ff {fa.d_ff}, vocab {fa.vocab}, "
          f"{fa.enc_len} frames) and {fv.arch_id} ({tlm.vlm_groups(fv)} groups of 1 cross + "
          f"{fv.cross_every} self blocks, d_model {fv.d_model}, {fv.n_heads}/{fv.n_kv_heads} "
          f"heads, d_ff {fv.d_ff}, vocab {fv.vocab}, {fv.n_img_tokens} image tokens), "
          f"{fv.dtype}, gates tanh({GATES[0]}), tanh({GATES[1]}); the card's free memory "
          f"{free / 1e9:.2f} GB of {total / 1e9:.2f} GB, earlier phases hold "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    ops.reset_launch_counts()

    def on(extras, d, dtype=None):
        return {k: v.to(device=d, dtype=dtype or v.dtype) for k, v in extras.items()}

    # -- (a) the card against the port's CPU run, the depth cut -------------
    # without the per-block remat, which gives the same values bitwise
    # (tests/test_torch_lm_audio.py, tests/test_torch_lm_vlm.py: remat on
    # and off agree) and spares the CPU's gradients a second forward pass
    G1 = D["cpu_groups"]
    cuts = {"audio": dataclasses.replace(fa, n_enc_layers=D["cpu_enc_layers"],
                                         n_layers=D["cpu_dec_layers"], remat=False),
            "vlm": dataclasses.replace(fv, cross_every=D["cpu_cross_every"],
                                       n_layers=G1 * (D["cpu_cross_every"] + 1), remat=False)}
    report["card_vs_cpu"] = {}
    rng = np.random.default_rng(D["seed"])
    watched = {"audio": lambda n: n in ("enc_blocks.0.ln1.b", "dec_blocks.1.cross_attn.wk",
                                        "dec_pos", "ln_enc.w"),
               "vlm": lambda n: ".gate_" in n or n.startswith("cross_blocks.0.attn.wk")}
    for key, cfg_a in cuts.items():
        cut = (f"{cfg_a.n_enc_layers} encoder + {cfg_a.n_layers} decoder layers, "
               f"{cfg_a.enc_len} frames" if key == "audio" else
               f"{G1} group of 1 cross + {cfg_a.cross_every} self blocks, "
               f"{cfg_a.n_img_tokens} image tokens")
        report["card_vs_cpu"][key] = card_vs_cpu(dev, compare, 17, cfg_a, cut, D, rng,
                                                 prepare=set_gates, watch=watched[key])

    # -- (b) serving, both uncut ----------------------------------------------
    B_, P, G = D["batch"], D["prompt_len"], D["gen"]
    cap = P + G
    report["serve"] = {}
    for key, cfg in (("audio", fa), ("vlm", fv)):
        model = get_model(cfg)
        base = torch.cuda.memory_allocated()
        params, init_s = sync_s(lambda: model.init_params(D["seed"], device=dev))
        set_gates(params)
        held = ssm_bytes(params.parameters())
        n_b = nparams(params)
        trng = np.random.default_rng(D["seed"])
        toks = torch.from_numpy(trng.integers(0, cfg.vocab, size=(B_, P + 1))).to(dev)
        extras = on(tserve.draw_extras(cfg, B_, trng), dev)
        torch.cuda.reset_peak_memory_stats()
        served = tserve.generate(model, params, toks[:, :P], G, extras=extras)
        serve_peak = torch.cuda.max_memory_allocated() - base
        check(served["generated"].shape == (B_, G)
              and ((served["generated"] >= 0) & (served["generated"] < cfg.vocab)).all(),
              f"generate's tokens ({cfg.arch_id})")
        batch_p = {"tokens": toks[:, :P], **extras}
        with torch.no_grad():
            pre_s = []
            for _ in range(3):
                (logits, cache), s_ = sync_s(lambda: model.prefill(params, batch_p,
                                                                   cache_len=cap))
                pre_s.append(s_)
            cache_bytes = ssm_bytes(cache.values())
            tok = torch.argmax(logits, -1)[:, None]
            dec_s = []
            for i in range(G):
                (logits_d, cache), s_ = sync_s(lambda: model.decode_step(
                    params, {"token": tok, "pos": P + i}, cache))
                dec_s.append(s_)
                tok = torch.argmax(logits_d, -1)[:, None]
        check(bool(torch.isfinite(logits).all() and torch.isfinite(logits_d).all()),
              f"non-finite {cfg.arch_id} logits")
        warm_prefill_ms = statistics.median(pre_s[1:]) * 1e3
        warm_decode_ms = statistics.median(dec_s) * 1e3
        dec_dev = graph_device_ms(lambda: model.decode_step(
            params, {"token": tok, "pos": P}, cache))
        pre_dev = graph_device_ms(lambda: model.prefill(params, batch_p, cache_len=cap))
        # a decode step reads the weights it uses (whisper's decoder and
        # tied head, not its encoder; every VLM weight but the untied
        # embedding table, a gather of a few rows; neither family's cross
        # K/V projections, whose products the prefill cached) and the
        # cache: the valid self K/V and the whole cross / image K/V
        named = dict(params.named_parameters())
        cross_kv = (".cross_attn.wk", ".cross_attn.wv") if key == "audio" else (
            ".attn.wk", ".attn.wv")
        if key == "audio":
            read = sum(p.numel() * p.element_size() for n, p in named.items()
                       if n.startswith(("dec_blocks.", "tok_emb", "ln_dec"))
                       and not n.endswith(cross_kv))
            ctx_keys, self_keys = ("cross_k", "cross_v"), ("self_k", "self_v")
        else:
            read = sum(p.numel() * p.element_size() for n, p in named.items()
                       if n != "tok_emb" and not (n.startswith("cross_blocks.")
                                                  and n.endswith(cross_kv)))
            ctx_keys, self_keys = ("img_k", "img_v"), ("k", "v")
        ctx_bytes = ssm_bytes(cache[k] for k in ctx_keys)
        self_valid = ssm_bytes(cache[k] for k in self_keys) * (P + G // 2) / cap
        bytes_decode = read + ctx_bytes + self_valid
        bound_decode_ms = bytes_decode / PEAK_BYTES * 1e3
        # a prefill's bf16 products (2 x weights x tokens: the encoder's on
        # the frames, the cross K/V projections on the frames or the image,
        # the rest on the prompt, the head on the last position) and its
        # float32 attention products (QK^T and PV)
        T_, d, KD = B_ * P, cfg.d_model, cfg.n_kv_heads * cfg.head_dim
        H, Dh = cfg.n_heads, cfg.head_dim
        head = cfg.vocab * d
        if key == "audio":
            E = cfg.enc_len
            enc = sum(p.numel() for n, p in named.items() if n.startswith("enc_blocks."))
            dec = sum(p.numel() for n, p in named.items() if n.startswith("dec_blocks."))
            kv_ctx = cfg.n_layers * 2 * d * KD
            f_bf16 = 2.0 * (enc * B_ * E + (dec - kv_ctx) * T_ + kv_ctx * B_ * E + head * B_)
            f_f32 = 4.0 * B_ * H * Dh * (cfg.n_enc_layers * E * E
                                         + cfg.n_layers * (P * P + P * E))
        else:
            E, Gv = cfg.n_img_tokens, tlm.vlm_groups(cfg)
            body = n_b - 2 * head
            kv_ctx = Gv * 2 * d * KD
            f_bf16 = 2.0 * ((body - kv_ctx) * T_ + kv_ctx * B_ * E + head * B_)
            f_f32 = 4.0 * B_ * H * Dh * (Gv * cfg.cross_every * P * P + Gv * P * E)
        bound_prefill_ops_ms = (f_bf16 / PEAK_BF16 + f_f32 / PEAK_F32) * 1e3
        bound_prefill_bytes_ms = (held + cache_bytes) / PEAK_BYTES * 1e3
        bound_prefill_ms = max(bound_prefill_ops_ms, bound_prefill_bytes_ms)
        del cache, logits, logits_d
        torch.cuda.empty_cache()

        # tests/test_arch_smoke.py:65-83 at full size: neither family has an
        # SSD, so it is held in bfloat16; a float32 witness only if it fails
        def consistency(m, p):
            with torch.no_grad():
                _, c1 = m.prefill(p, {"tokens": toks[:, :P], **extras}, cache_len=P + 1)
                ld, _ = m.decode_step(p, {"token": toks[:, P:], "pos": P}, c1)
                del c1
                lf, _ = m.prefill(p, {"tokens": toks, **extras})
            return ld.float().cpu(), lf.float().cpu()

        ld, lf = consistency(model, params)
        gap = float((ld - lf).abs().max())
        consist_f32 = None
        if gap > 0.15:
            p32 = copy.deepcopy(params).float()
            ld32, lf32 = consistency(get_model(dataclasses.replace(cfg, dtype="float32")), p32)
            del p32
            torch.cuda.empty_cache()
            print(f"[phase 17] {cfg.arch_id}: prefill({P}) + decode vs prefill({P + 1}) in "
                  f"bfloat16 {gap:.4f} > 0.15; its float32 witness follows")
            consist_f32 = compare(f"{cfg.arch_id} prefill({P}) + decode_step vs prefill({P + 1}) "
                                  f"(the weights in float32)", [ld32], [lf32], rtol=0.15,
                                  atol=0.15, why="tests/test_arch_smoke.py:81-83 gate")
        else:
            compare(f"{cfg.arch_id} prefill({P}) + decode_step vs prefill({P + 1}) (last-token "
                    f"logits, batch {B_}, bfloat16)", [ld], [lf], rtol=0.15, atol=0.15,
                    why="tests/test_arch_smoke.py:81-83 gate")
        rec = {"params": n_b, "init_s": init_s, "batch": B_, "prompt_len": P, "gen": G,
               "prefill_first_ms": served["prefill_s"] * 1e3, "prefill_warm_ms": warm_prefill_ms,
               "decode_ms_per_token": served["decode_s_per_token"] * 1e3,
               "decode_warm_median_ms": warm_decode_ms, "tokens_per_s": served["tokens_per_s"],
               "decode_device_ms": dec_dev, "prefill_device_ms": pre_dev,
               "decode_idle_share": 1.0 - dec_dev / warm_decode_ms,
               "decode_idle_share_generate": 1.0 - dec_dev / (served["decode_s_per_token"] * 1e3),
               "prefill_idle_share": 1.0 - pre_dev / warm_prefill_ms,
               "param_bytes_held": held, "peak_bytes": serve_peak,
               "peak_above_weights": serve_peak - held, "held_before_bytes": base,
               "cache_bytes": cache_bytes, "cross_cache_bytes": ctx_bytes,
               "decode_bytes": bytes_decode, "bound_decode_ms": bound_decode_ms,
               "prefill_bf16_tflop": f_bf16 / 1e12, "prefill_f32_tflop": f_f32 / 1e12,
               "bound_prefill_ops_ms": bound_prefill_ops_ms,
               "bound_prefill_bytes_ms": bound_prefill_bytes_ms,
               "bound_prefill_ms": bound_prefill_ms, "consistency_bf16": gap,
               "consistency_f32": consist_f32}
        print(f"[phase 17] {smi}: generate({cfg.arch_id}, {n_b / 1e9:.3f}e9 parameters, batch "
              f"{B_}, prompt {P}, gen {G}): prefill {served['prefill_s'] * 1e3:.2f} ms first, "
              f"{warm_prefill_ms:.2f} ms warm (bound {bound_prefill_ms:.3f} ms: operations "
              f"{bound_prefill_ops_ms:.3f} ms, {f_bf16 / 1e12:.3f} TFLOP bf16 + "
              f"{f_f32 / 1e12:.4f} TFLOP float32; bytes {bound_prefill_bytes_ms:.3f} ms); decode "
              f"{served['decode_s_per_token'] * 1e3:.3f} ms a token in generate, "
              f"{warm_decode_ms:.3f} ms warm median a step (bound {bound_decode_ms:.3f} ms: "
              f"{bytes_decode / 1e9:.3f} GB at 3.35 TB/s); {served['tokens_per_s']:.1f} tok/s; "
              f"generate's peak {serve_peak / 1e9:.3f} GB, {(serve_peak - held) / 1e9:.3f} GB "
              f"above the {held / 1e9:.3f} GB of weights ({base / 1e9:.3f} GB held before); the "
              f"cache {cache_bytes / 1e6:.2f} MB ({ctx_bytes / 1e6:.2f} MB of "
              f"{'/'.join(ctx_keys)}); device time from a CUDA graph: decode step "
              f"{dec_dev:.3f} ms (idle {100 * (1 - dec_dev / warm_decode_ms):.1f}% of the step "
              f"timed alone, {100 * (1 - dec_dev / (served['decode_s_per_token'] * 1e3)):.1f}% "
              f"of generate's), prefill {pre_dev:.3f} ms (idle "
              f"{100 * (1 - pre_dev / warm_prefill_ms):.1f}%); prefill({P}) + decode vs "
              f"prefill({P + 1}) {gap:.4f} in bfloat16")
        report["serve"][key] = rec
        del params, named, model, toks, extras, batch_p
        gc.collect()
        torch.cuda.empty_cache()

    # -- (c) training --------------------------------------------------------
    S_, bt = D["train_seq"], D["train_batch"]
    T_ = bt * S_
    report["train"] = {}
    for key, cfg, steps in (("audio", fa, D["audio_train_steps"]),
                            ("vlm", fv, D["vlm_train_steps"])):
        d, H, Dh, KD = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.n_kv_heads * cfg.head_dim

        def act_bytes(c):
            """What a step holds beside the state, reckoned: each block's
            input (per-block remat), one block's recomputed float32 scores,
            probabilities and their gradient (the whisper encoder's E x E,
            the VLM's S x S or S x 1,601 in a cross block), a loss chunk's
            float32 logits, their softmax and gradient, and AdamW's float32
            temporaries of the largest leaf."""
            if key == "audio":
                n_blk, tok = c.n_enc_layers + c.n_layers, bt * max(c.enc_len, S_)
                att = 3 * bt * H * max(c.enc_len ** 2, S_ * (S_ + c.enc_len)) * 4
            else:
                n_blk, tok = c.n_layers, T_
                att = 3 * bt * H * S_ * max(S_, c.n_img_tokens) * 4
            return (n_blk * tok * d * 2 + att + 3 * bt * min(c.logits_chunk, S_) * c.vocab * 4
                    + 3 * 4 * c.vocab * d)

        free = torch.cuda.mem_get_info()[0]
        cfg_c = cfg if key == "audio" else dataclasses.replace(
            cfg, n_layers=D["vlm_train_groups"] * (cfg.cross_every + 1))
        n_c = cfg_c.param_count()
        state_bytes = 8 * n_c            # bf16 weights, gradients, AdamW's m and v
        check(state_bytes + act_bytes(cfg_c) <= free - 2e9,
              f"(c) {cfg_c.arch_id} at {cfg_c.n_layers} layers: the step's reckoned "
              f"{(state_bytes + act_bytes(cfg_c)) / 1e9:.2f} GB and 2 GB to spare do not fit in "
              f"{free / 1e9:.2f} GB")
        cut = ("" if cfg_c == cfg else
               f" (cut to {tlm.vlm_groups(cfg_c)} of {tlm.vlm_groups(cfg)} groups)")
        print(f"[phase 17] (c) {cfg.arch_id}: {n_c / 1e9:.3f}e9 parameters{cut}; memory "
              f"reckoned: weights, gradients and AdamW state {state_bytes / 1e9:.2f} GB + a "
              f"step's activations {act_bytes(cfg_c) / 1e9:.2f} GB at batch {bt} x {S_}; free "
              f"{free / 1e9:.2f} GB")
        head = cfg_c.vocab * d
        if key == "audio":
            E = cfg_c.enc_len
            dec_kv = cfg_c.n_layers * 2 * d * KD
            enc = cfg_c.n_enc_layers * (4 * d * d + 2 * d * cfg_c.d_ff)
            body = n_c - head - cfg_c.max_seq * d - enc - dec_kv
            fwd_bf16 = 2.0 * (body * T_ + head * T_ + (enc + dec_kv) * bt * E)
            fwd_f32 = 4.0 * bt * H * Dh * (cfg_c.n_enc_layers * E * E
                                           + cfg_c.n_layers * (S_ * S_ + S_ * E))
        else:
            E, Gc = cfg_c.n_img_tokens, tlm.vlm_groups(cfg_c)
            kv_ctx = Gc * 2 * d * KD
            body = n_c - 2 * head - kv_ctx
            fwd_bf16 = 2.0 * (body * T_ + head * T_ + kv_ctx * bt * E)
            fwd_f32 = 4.0 * bt * H * Dh * (Gc * cfg_c.cross_every * S_ * S_ + Gc * S_ * E)
        # forward, backward (twice the forward), the blocks' remat forward:
        # 4 forwards of each
        bf16_flop, f32_flop = 4.0 * fwd_bf16, 4.0 * fwd_f32
        bound_ms = (bf16_flop / PEAK_BF16 + f32_flop / PEAK_F32) * 1e3
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        if key == "audio":
            cfg_b, model, params, opt_state, step_fn, stream, extras, _ = ttrain.build(
                cfg.arch_id, smoke=False, batch=bt, seq=S_, lr=D["lr"], seed=D["seed"],
                device=dev)
            check(cfg_b == cfg, f"build's config is {cfg.arch_id}'s")
        else:        # the pieces launch/train.py's build assembles, at the cut depth
            model = get_model(cfg_c)
            params = model.init_params(D["seed"], device=dev)
            ocfg = optim.AdamWConfig(lr=optim.warmup_cosine(D["lr"], 20, 10_000))
            opt_state = optim.init(tlm.leaves(params), ocfg)
            step_fn = make_train_step(model, ocfg)
            stream = TokenStream(vocab=cfg_c.vocab, seq=S_, global_batch=bt, seed=D["seed"])
            name, shape = tserve.extra_input(cfg_c, bt)
            x = np.random.default_rng(D["seed"]).standard_normal(shape).astype(np.float32)
            extras = {name: torch.from_numpy(x).to(dev).to(torch.bfloat16)}
            del x
        set_gates(params)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(set(extras) == ({"frames"} if key == "audio" else {"img"}),
              f"(c) build's extras {sorted(extras)}")
        held_c = torch.cuda.memory_allocated() - base
        names = list(tlm.leaves(params))
        watch_names = ([n for n in names if n.startswith("enc_blocks.0.")][:2]
                       + ["dec_pos", "ln_enc.b"] if key == "audio" else
                       ["cross_blocks.0.gate_attn", "cross_blocks.0.attn.wk",
                        "self_groups.0.0.attn.wq", "final_norm"])
        watch = {k_: tlm.leaves(params)[k_].detach().clone() for k_ in watch_names}
        torch.cuda.reset_peak_memory_stats()
        params, opt_state, rep = train_loop(
            step_fn, params, opt_state, lambda s: stream.batch(s, extras, device=dev),
            TrainLoopConfig(steps=steps, ckpt_dir=None, log_every=1, handle_signals=False),
            log_fn=lambda s: None)
        peak = torch.cuda.max_memory_allocated() - base
        hist = rep["history"]
        check(len(hist) == steps and rep["final_step"] == steps,
              f"(c) {cfg.arch_id} ran every step")
        check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist),
              f"(c) {cfg.arch_id}: every loss and grad norm finite")
        check(hist[-1]["loss"] < hist[0]["loss"],
              f"(c) {cfg.arch_id}: the loss did not fall ({hist[0]['loss']} -> {hist[-1]['loss']})")
        moved = {k_: not torch.equal(v, tlm.leaves(params)[k_]) for k_, v in watch.items()}
        check(all(moved.values()), f"(c) {cfg.arch_id}: the parameters moved: {moved}")
        secs = [h["sec_per_step"] for h in hist]
        warm = statistics.median(secs[1:])
        report["train"][key] = {
            "params": n_c, "layers": cfg_c.n_layers, "cut": cfg_c != cfg, "batch": bt,
            "seq": S_, "steps": steps, "build_s": build_s, "first_step_s": secs[0],
            "warm_median_s": warm, "warm_min_s": min(secs[1:]), "warm_max_s": max(secs[1:]),
            "tokens_per_s": T_ / warm, "losses": [h["loss"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist], "stragglers": rep["stragglers"],
            "held_bytes": held_c, "peak_bytes": peak, "peak_above_state": peak - held_c,
            "held_before_bytes": base, "reckoned_state_bytes": state_bytes,
            "reckoned_act_bytes": act_bytes(cfg_c), "bf16_tflop": bf16_flop / 1e12,
            "f32_tflop": f32_flop / 1e12, "bound_ms": bound_ms}
        src = "build(smoke=False)" if key == "audio" else "build's pieces"
        print(f"[phase 17] {smi}: train({cfg.arch_id}, {src}{cut}, batch {bt} x "
              f"{S_}, {steps} steps): first step {secs[0]:.3f} s, warm median {warm * 1e3:.1f} "
              f"ms ({min(secs[1:]) * 1e3:.1f}-{max(secs[1:]) * 1e3:.1f}), {T_ / warm:.0f} "
              f"tokens/s; loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; bound "
              f"{bound_ms:.1f} ms ({bf16_flop / 1e12:.2f} TFLOP bf16 at 989 TFLOP/s + "
              f"{f32_flop / 1e12:.3f} TFLOP float32 at 67 TFLOP/s, remat included); model and "
              f"AdamW state held {held_c / 1e9:.3f} GB, the steps' peak "
              f"{(peak - held_c) / 1e9:.3f} GB above it ({base / 1e9:.3f} GB held before); built "
              f"in {build_s:.1f} s")
        del params, opt_state, step_fn, model, watch, stream, extras
        gc.collect()
        torch.cuda.empty_cache()

    # -- (d) checkpoint and restart on the SMOKE configs -------------------------
    report["restart"] = {}
    tops = {"audio": {"dec_blocks", "dec_pos", "enc_blocks", "ln_dec", "ln_enc", "tok_emb"},
            "vlm": {"cross_blocks", "final_norm", "lm_head", "self_groups", "tok_emb"}}
    for key in ("audio", "vlm"):
        def fresh():
            """(params, AdamW state, step, batches) as ``launch.train.build``
            gives them on the SMOKE config, the gates set."""
            _, _, p, o, step, stream, ex, _ = ttrain.build(
                D[key], smoke=True, batch=D["ckpt_batch"], seq=D["ckpt_seq"], lr=D["lr"],
                seed=D["seed"], device=dev)
            set_gates(p)
            return p, o, step, lambda s: stream.batch(s, ex, device=dev)

        cfg_d = ARCHS[D[key]].SMOKE
        report["restart"][key] = {"config": cfg_d.arch_id, **restart_bitwise(
            17, f"{cfg_d.arch_id}, batch {D['ckpt_batch']} x {D['ckpt_seq']}", D, fresh,
            tops=tops[key])}
    check(ops.launch_counts() == NO_LAUNCHES,
          f"the audio and VLM paths launched a kernel: {ops.launch_counts()}")
    gc.collect()
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    print("[phase 17] " + json.dumps(report))
    print(f"[phase 17] took {report['seconds']:.1f} s")
    return report


# phase 18, ROADMAP A8.7: the production mesh and parallel/ on the card, at
# full width, on meshes of four cells over the one card (a mesh may repeat
# a device: every cell's path, placement and launch runs here, the cells
# one after another).  (a) olmoe-1b-7b uncut, served under a (data 2,
# model 2) mesh: the prefill of 4 x 256 tokens takes the MoE layers'
# gather-at-use branch ((1,024 * 8) // 64 = 128 > 64), the decode steps of
# 4 tokens their serve mode; the card held against the same mesh on the
# CPU at 2 layers (8 decode steps there, the CPU's greedy tokens fed); (b)
# qwen2-1.5b uncut: one unsharded step at 4 x 1,024 checkpointed, restored
# into a (2, 2) mesh's pieces through train_loop(shardings=), then the
# sharded step against the unsharded one from the same state; (c) gpipe
# over qwen2's 28 blocks, 4 stages of 7, 8 microbatches of 1 x 1,024; (d)
# compress_allreduce of (b)'s gradient over its two data members
PAR = dict(moe_arch="olmoe-1b-7b", train_arch="qwen2-1.5b", mesh=(2, 2), cpu_layers=2,
           batch=4, prompt_len=256, gen=32, cpu_steps=8, train_batch=4, train_seq=1024,
           lr=3e-4, stages=4, micro=8, micro_batch=1, seed=0)


class ShardDropSpy:
    """While active, counts the assignments the MoE layers drop over
    capacity, once per routed token set: it wraps
    ``repro_torch.models.moe._dispatch_tables`` and reads the calls of
    model column 0 (an expert-parallel call routes the same tokens in every
    column).  Reads to the host, so never around a timed region."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe = moe
        self.dropped = self.total = 0

    def __enter__(self):
        import torch

        m, self._tables = self.moe, self.moe._dispatch_tables

        def tables(topi, topv, T, k, C, e_lo, n_local, dtype):
            if e_lo == 0:
                rank = m._expert_ranks(topi.reshape(-1).to(torch.int32), T * k)
                self.dropped += int((rank >= C).sum())
                self.total += T * k
            return self._tables(topi, topv, T, k, C, e_lo, n_local, dtype)

        m._dispatch_tables = tables
        return self

    def __exit__(self, *exc):
        self.moe._dispatch_tables = self._tables
        return False

    def share(self) -> float:
        return self.dropped / max(self.total, 1)


def phase18(dev, smi, compare, r13, r14) -> dict:
    """The production mesh and ``parallel/`` (ROADMAP A8.7) on the card,
    four cells over the one card: (a) olmoe-1b-7b uncut served under a (2,
    2) mesh through ``generate`` (the cache placed by ``cache_shardings``),
    the bytes reckoned first, the dropped share beside phase 14's, and the
    same mesh at 2 layers against the CPU's at phase 14's gate; (b) one
    qwen2-1.5b train step uncut through ``build(mesh=)``, restored from an
    unsharded checkpoint through ``train_loop(shardings=)``, the loss and
    every parameter against the unsharded step at twice the unsharded
    step's bfloat16-vs-float32 distance, the warm step's time and peak
    beside phase 13's; (c) ``gpipe`` over qwen2's 28 blocks (4 stages of 7,
    8 microbatches of 1 x 1,024), its forward and gradients bitwise the
    stages run in sequence and its logits within tests/test_arch_smoke.py's
    0.15 of the unpipelined forward, the bubble share printed; (d)
    ``compress_allreduce`` of (b)'s gradient over its two data members:
    every entry within blockmax / 127 * 0.51 of the plain mean, bitwise
    equal across members, timed."""
    import copy
    import shutil

    import numpy as np
    import torch

    from repro_torch import optim
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import (dp_cells, expert_leaf, make_decode_step,
                                          make_prefill_step, make_train_step)
    from repro_torch.models import get_model
    from repro_torch.models import layers as tlayers
    from repro_torch.models import lm as tlm
    from repro_torch.models import moe as tmoe
    from repro_torch.parallel import compress, hints, sharding
    from repro_torch.parallel.pipeline import gpipe
    from repro_torch.runtime import TrainLoopConfig, train_loop

    t_phase = time.perf_counter()
    cfg = ARCHS[PAR["moe_arch"]].CONFIG
    qcfg = ARCHS[PAR["train_arch"]].CONFIG
    check(cfg.n_layers == 16 and cfg.n_experts == 64 and cfg.fsdp and qcfg.n_layers == 28
          and qcfg.d_model == 1536, "phase 18 runs olmoe-1b-7b's and qwen2-1.5b's full "
                                    "configurations")
    data, model_ax = PAR["mesh"]
    cells = data * model_ax
    mesh = make_local_mesh(data, model_ax, devices=[dev] * cells)
    cpu_mesh = make_local_mesh(data, model_ax, devices=["cpu"] * cells)
    free, total = torch.cuda.mem_get_info()
    report = {"card": smi, "mesh": f"{data} x {model_ax} over {dev} x {cells}",
              "free_bytes_at_start": free, "held_at_start": torch.cuda.memory_allocated()}
    print(f"[phase 18] {smi}: the production mesh and parallel/ on a (data {data}, model "
          f"{model_ax}) mesh of {cells} cells over {dev}; free {free / 1e9:.2f} GB of "
          f"{total / 1e9:.2f} GB, earlier phases hold "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB; temporary directory "
          f"{shutil.disk_usage(tempfile.gettempdir()).free / 1e9:.1f} GB free")
    ops.reset_launch_counts()
    B_, P = PAR["batch"], PAR["prompt_len"]
    E, k = cfg.n_experts, cfg.top_k
    T_l = B_ * P // data
    check((T_l * data * k) // E > 64 and (B_ // data * data * k) // E <= 64,
          "(a) the prefill takes the gather branch and the decode steps the serve mode")
    toks = torch.from_numpy(np.random.default_rng(PAR["seed"]).integers(
        0, cfg.vocab, size=(B_, P)))

    # -- (a) the CPU check: the same mesh at 2 layers, card against CPU ---------
    t_a = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, n_layers=PAR["cpu_layers"])
    m2, m2_32 = get_model(cfg2), get_model(dataclasses.replace(cfg2, dtype="float32"))
    cpu_p = m2.init_params(torch.Generator().manual_seed(PAR["seed"]))
    cpu_p32 = copy.deepcopy(cpu_p).float()
    card_p = copy.deepcopy(cpu_p).to(dev)

    def placed(params, c, msh):
        return sharding.place(params, sharding.param_shardings(params, c, msh, serving=True))

    cap = P + PAR["cpu_steps"]

    @torch.no_grad()
    def run(model, params, feed):
        """Prefill, then one decode step per token of ``feed`` (None: the
        run's own greedy tokens): (logits per step, tokens fed, spy)."""
        d = params.device
        prefill, decode = make_prefill_step(model, cache_len=cap), make_decode_step(model)
        with ShardDropSpy() as spy:
            logits, cache = prefill(params, {"tokens": toks.to(d)})
            out, fed = [logits.float().cpu()], []
            for i in range(PAR["cpu_steps"]):
                tok = torch.argmax(logits, -1)[:, None] if feed is None else feed[i].to(d)
                fed.append(tok.cpu())
                logits, cache = decode(params, {"token": tok, "pos": P + i}, cache)
                out.append(logits.float().cpu())
        check(all(isinstance(v, sharding.Sharded) for v in cache.values()),
              "(a) the cache placed by cache_shardings")
        return out, fed, spy

    t0 = time.perf_counter()
    ref, fed, spy_cpu = run(m2, placed(cpu_p, cfg2, cpu_mesh), None)
    t1 = time.perf_counter()
    ref32, _, _ = run(m2_32, placed(cpu_p32, dataclasses.replace(cfg2, dtype="float32"),
                                    cpu_mesh), fed)
    t2 = time.perf_counter()
    got, _, spy_card2 = run(m2, placed(card_p, cfg2, mesh), fed)
    bf16_vs_f32 = max(float((a - b).abs().max()) for a, b in zip(ref, ref32))
    a_err = compare(
        f"sharded MoE card vs CPU ({cfg.arch_id} cut to {PAR['cpu_layers']} layers on a "
        f"{data} x {model_ax} mesh each; prefill of {B_} x {P} + {PAR['cpu_steps']} decode "
        f"steps on the CPU's greedy tokens, logits)", got, ref, rtol=0.0,
        atol=2.0 * bf16_vs_f32,
        why=f"phase 14's gate: twice the CPU's bfloat16-vs-float32 distance, "
            f"{bf16_vs_f32:.4e}")
    report["card_vs_cpu"] = {"max_abs_err": a_err, "cpu_bf16_vs_f32": bf16_vs_f32,
                             "dropped_share_cpu": spy_cpu.share(),
                             "dropped_share_card": spy_card2.share(),
                             "cpu_bf16_s": t1 - t0, "cpu_f32_s": t2 - t1,
                             "seconds": time.perf_counter() - t_a}
    print(f"[phase 18] (a) 2 layers on the mesh: the CPU's bf16 run {t1 - t0:.1f} s, f32 "
          f"{t2 - t1:.1f} s ({torch.get_num_threads()} threads); dropped share CPU "
          f"{spy_cpu.share():.5f} card {spy_card2.share():.5f}; took "
          f"{report['card_vs_cpu']['seconds']:.1f} s")
    del cpu_p, cpu_p32, card_p, got, ref, ref32
    gc.collect()
    torch.cuda.empty_cache()

    # -- (a) the 16 layers served under the mesh --------------------------------
    model = get_model(cfg)
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    full = model.init_params(PAR["seed"], device=dev)
    pd = placed(full, cfg, mesh)
    del full
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - base
    el = E // model_ax
    gathered = sum(int(np.prod(v.shape)) * v.pieces.flat[0].element_size()
                   for n, v in pd.leaves.items() if not expert_leaf(n))
    cell_experts = 3 * el * cfg.d_model * cfg.d_expert * 2
    kv = 2 * cfg.n_layers * B_ * (P + PAR["gen"]) * cfg.n_kv_heads * cfg.head_dim * 2
    print(f"[phase 18] (a) memory reckoned: {pd.nbytes / 1e9:.3f} GB of bfloat16 pieces "
          f"({cfg.param_count() / 1e9:.3f}e9 parameters; {held / 1e9:.3f} GB allocated), "
          f"plus at use every non-expert leaf gathered, {gathered / 1e9:.3f} GB a call, and in "
          f"the prefill's gather branch one cell's {el} experts of a layer, "
          f"{cell_experts / 1e9:.3f} GB; the cache {kv / 1e9:.4f} GB in pieces; placed in "
          f"{place_s:.1f} s")
    check(pd.nbytes <= 1.001 * held, "(a) the pieces are what the card holds")
    torch.cuda.reset_peak_memory_stats()
    out = tserve.generate(model, pd, toks, PAR["gen"])
    peak = torch.cuda.max_memory_allocated() - base
    check(out["generated"].shape == (B_, PAR["gen"])
          and ((out["generated"] >= 0) & (out["generated"] < cfg.vocab)).all(),
          "(a) generate's tokens")
    with torch.no_grad(), ShardDropSpy() as spy:
        logits, cache = make_prefill_step(model, cache_len=P + 1)(pd, {"tokens": toks.to(dev)})
        logits_d, _ = make_decode_step(model)(
            pd, {"token": torch.argmax(logits, -1)[:, None], "pos": P}, cache)
    check(bool(torch.isfinite(logits).all() and torch.isfinite(logits_d).all()),
          "(a) finite logits")
    check(tuple(cache["k"].spec) == (None, "data", None, "model", None),
          f"(a) the cache's spec {cache['k'].spec!r}")
    share14 = r14["serve"]["consistency"]["dropped_share_prefill_S"]
    report["serve"] = {
        "pieces_bytes": pd.nbytes, "gathered_bytes_a_call": gathered,
        "prefill_cell_experts_bytes": cell_experts, "cache_bytes": kv,
        "prefill_first_ms": out["prefill_s"] * 1e3,
        "decode_ms_per_token": out["decode_s_per_token"] * 1e3,
        "tokens_per_s": out["tokens_per_s"], "peak_above_pieces": peak - held,
        "dropped_share_prefill": spy.share(), "dropped_share_phase14": share14,
        "capacity_per_dp_shard": tmoe.capacity(T_l, cfg),
        "capacity_phase14": tmoe.capacity(B_ * P, cfg)}
    print(f"[phase 18] {smi}: generate({cfg.arch_id}, {cfg.n_layers} layers on the mesh, "
          f"batch {B_}, prompt {P}, gen {PAR['gen']}): prefill {out['prefill_s'] * 1e3:.1f} "
          f"ms, decode {out['decode_s_per_token'] * 1e3:.2f} ms a token, "
          f"{out['tokens_per_s']:.1f} tok/s; peak {(peak - held) / 1e9:.3f} GB above the "
          f"pieces; dropped share of the prefill {spy.share():.5f} at C = "
          f"{tmoe.capacity(T_l, cfg)} a dp shard (phase 14, unsharded at C = "
          f"{tmoe.capacity(B_ * P, cfg)}: {share14:.5f})")
    del pd, cache, logits, logits_d, out
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) qwen2-1.5b: one unsharded step checkpointed, restored on the mesh --
    t_b = time.perf_counter()
    B2, S2 = PAR["train_batch"], PAR["train_seq"]
    ocfg = optim.AdamWConfig(lr=optim.warmup_cosine(PAR["lr"], 20, 10_000))
    qmodel = get_model(qcfg)
    q32 = get_model(dataclasses.replace(qcfg, dtype="float32"))
    base = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as td:
        _, _, U, optU, stepU, stream, extras, _ = ttrain.build(
            PAR["train_arch"], smoke=False, batch=B2, seq=S2, lr=PAR["lr"], seed=PAR["seed"],
            device=dev)

        def batch_fn(s):
            return stream.batch(s, extras, device=dev)

        t0 = time.perf_counter()
        U, optU, _ = train_loop(stepU, U, optU, batch_fn,
                                TrainLoopConfig(steps=1, ckpt_dir=td, ckpt_every=1,
                                                async_ckpt=False, handle_signals=False),
                                log_fn=lambda s: None)
        ckpt_s = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in Path(td).rglob("*") if f.is_file())
        nq = qcfg.param_count()
        print(f"[phase 18] (b) memory reckoned: {nq / 1e9:.3f}e9 parameters, as pieces "
              f"{2 * nq / 1e9:.2f} GB of bfloat16 weights and {4 * nq / 1e9:.2f} GB of AdamW "
              f"moments; at use a dp cell gathers {2 * nq / 1e9:.2f} GB and makes as much "
              f"gradient, summed into {2 * nq / 1e9:.2f} GB of gradient pieces, plus its "
              f"half batch's activations; beside them the unsharded model and state, "
              f"{6 * nq / 1e9:.2f} GB")
        *_, S, optS, stepS, _, _, (p_sh, o_sh) = ttrain.build(
            PAR["train_arch"], smoke=False, batch=B2, seq=S2, lr=PAR["lr"],
            seed=PAR["seed"] + 1, mesh=mesh, device=dev)
        t0 = time.perf_counter()
        S, optS, rep = train_loop(stepS, S, optS, batch_fn,
                                  TrainLoopConfig(steps=1, ckpt_dir=td, handle_signals=False),
                                  shardings=(p_sh, o_sh), log_fn=lambda s: None)
        restore_s = time.perf_counter() - t0
    check(rep["final_step"] == 1 and isinstance(S, sharding.ShardedParams),
          "(b) restored into the mesh's pieces")
    restored = all(torch.equal(S.leaves[n].gather(dev), t)
                   for n, t in tlm.leaves(U).items())
    check(restored and int(optS["step"].gather("cpu")) == 1,
          "(b) the restored pieces are the unsharded checkpoint's, bitwise")
    # (d)'s members: each data cell's gradient of the loss on its half of the
    # next batch at the restored weights (the step sums them, halved)
    b1 = batch_fn(1)
    members = []
    for r, row in enumerate(dp_cells(mesh)):
        cell = S.materialize(dev, requires_grad=True)
        with hints.activate(row):
            loss_r, _ = qmodel.loss_fn(cell, {"tokens": b1["tokens"][r * B2 // data:
                                                                     (r + 1) * B2 // data]})
            named = tlm.leaves(cell)
            members.append(dict(zip(named, torch.autograd.grad(loss_r,
                                                               list(named.values())))))
        del cell, named, loss_r
    # -- (d) compress_allreduce of (b)'s gradient over its two data members -----
    # the payload in float32, as the reference's compression takes it, a leaf
    # at a time (the members' float32 trees whole would be 12 GB more)
    comp_s, worst, same, n_el = 0.0, 0.0, True, 0
    for n in members[0]:
        gs = [m[n].float() for m in members]
        states = [compress.CompressionState.init(g) for g in gs]
        (red, _), s_ = sync_s(lambda: compress.compress_allreduce(gs, states, mesh,
                                                                   axis="data"))
        comp_s += s_
        plain = sum(gs) / data
        bound = torch.stack([compress._pad_flat(g)[0].reshape(-1, compress.BLOCK).abs().amax(1)
                             for g in gs]).amax(0) / 127.0 * 0.51
        diff = compress._pad_flat(red[0] - plain)[0].reshape(-1, compress.BLOCK)
        worst = max(worst, float((diff.abs().amax(1) / torch.clamp(bound, min=1e-30)).max()))
        same = same and all(torch.equal(red[0], r) for r in red[1:])
        n_el += gs[0].numel()
        del gs, states, red, plain, bound, diff
    check(worst <= 1.0, f"(d) an entry {worst:.3f} x blockmax / 127 * 0.51 from the mean")
    check(same, "(d) the members' results are not bitwise equal")
    report["compress"] = {"members": data, "elements": n_el, "seconds": comp_s,
                          "worst_over_bound": worst, "bitwise_across_members": same}
    print(f"[phase 18] {smi}: compress_allreduce of {n_el / 1e9:.3f}e9 float32 gradient "
          f"entries over {data} data members, a leaf a call: {comp_s * 1e3:.1f} ms in all; "
          f"worst entry {worst:.3f} of blockmax / 127 * 0.51 from the plain mean; bitwise "
          f"equal across members {same}")
    del members
    gc.collect()
    torch.cuda.empty_cache()

    # the unsharded reference in bfloat16 and in float32 from the same state
    U32 = copy.deepcopy(U).float()
    opt32 = {"mu": {n: {"m": s["m"].float(), "v": s["v"].float()}
                    for n, s in optU["mu"].items()}, "step": optU["step"].clone()}
    _, _, m32 = make_train_step(q32, ocfg)(U32, opt32, b1)
    del opt32
    _, _, mU = stepU(U, optU, b1)
    del optU
    gc.collect()
    torch.cuda.empty_cache()
    leaves_u = tlm.leaves(U)
    p_dist = max(float((a.float() - b).abs().max())
                 for a, b in zip(leaves_u.values(), tlm.leaves(U32).values()))
    l_dist = abs(float(mU["loss"]) - float(m32["loss"]))
    del U32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_b = torch.cuda.memory_allocated()
    (_, _, mS), first_s = sync_s(lambda: stepS(S, optS, b1))
    loss_gap = abs(float(mS["loss"]) - float(mU["loss"]))
    # leaf by leaf (a float32 copy of every leaf at once would be 12 GB)
    b_err = max(float((S.leaves[n].gather(dev).float() - t.float()).abs().max())
                for n, t in leaves_u.items())
    ok = b_err <= 2.0 * p_dist
    print(f"[check] sharded vs unsharded step ({PAR['train_arch']} uncut, {B2} x {S2}, a "
          f"{data} x {model_ax} mesh; every parameter after the step): max_abs_err="
          f"{b_err:.3e} tol=rtol 0, atol {2.0 * p_dist:g} (twice the unsharded step's "
          f"bfloat16-vs-float32 distance, {p_dist:.4e}); worst error/tolerance "
          f"{b_err / (2.0 * p_dist):.3f} -> {'ok' if ok else 'FAIL'}")
    check(ok, "(b) the sharded step's parameters disagree with the unsharded step's")
    check(loss_gap <= 2.0 * l_dist,
          f"(b) the sharded loss {loss_gap:.3e} from the unsharded, over twice its "
          f"bf16-vs-f32 {l_dist:.3e}")
    (_, _, mS2), warm_s = sync_s(lambda: stepS(S, optS, batch_fn(2)))
    peak_b = torch.cuda.max_memory_allocated() - base_b
    check(math.isfinite(float(mS2["loss"])), "(b) the warm step's loss")
    t13 = r13["train"]
    report["train"] = {
        "ckpt_bytes": ckpt_bytes, "ckpt_write_s": ckpt_s, "restore_s": restore_s,
        "loss": {"sharded": float(mS["loss"]), "unsharded": float(mU["loss"]),
                 "unsharded_f32": float(m32["loss"])}, "loss_gap": loss_gap,
        "loss_bf16_vs_f32": l_dist, "param_max_abs_err": b_err, "param_bf16_vs_f32": p_dist,
        "grad_norm": {"sharded": float(mS["grad_norm"]), "unsharded": float(mU["grad_norm"])},
        "first_step_s": first_s, "warm_step_s": warm_s, "peak_above_state": peak_b,
        "state_pieces_bytes": S.nbytes + sum(v.nbytes for v in
                                             [*(x for m in optS["mu"].values()
                                                for x in m.values()), optS["step"]]),
        "phase13_warm_median_s": t13["warm_median_s"], "phase13_peak_bytes": t13["peak_bytes"],
        "seconds": time.perf_counter() - t_b}
    print(f"[phase 18] {smi}: train({PAR['train_arch']} uncut on the mesh, {B2} x {S2}): "
          f"checkpoint {ckpt_bytes / 1e9:.2f} GB written in {ckpt_s:.1f} s, restored into "
          f"the pieces in {restore_s:.1f} s; loss sharded {float(mS['loss']):.6f} unsharded "
          f"{float(mU['loss']):.6f} f32 {float(m32['loss']):.6f}; first sharded step "
          f"{first_s * 1e3:.1f} ms, warm {warm_s * 1e3:.1f} ms (phase 13, unsharded: warm "
          f"median {t13['warm_median_s'] * 1e3:.1f} ms); peak {peak_b / 1e9:.3f} GB above "
          f"the {report['train']['state_pieces_bytes'] / 1e9:.3f} GB of state pieces (phase "
          f"13: {t13['peak_bytes'] / 1e9:.3f} GB above its model and AdamW state); (b) took "
          f"{report['train']['seconds']:.1f} s")
    del S, optS
    gc.collect()
    torch.cuda.empty_cache()

    # -- (c) gpipe over qwen2's 28 blocks ---------------------------------------
    S_, M_ = PAR["stages"], PAR["micro"]
    per = qcfg.n_layers // S_
    pipe_mesh = make_local_mesh(1, S_, devices=[dev] * S_)
    stage_blocks = [list(U.blocks[s * per:(s + 1) * per]) for s in range(S_)]
    ptoks = torch.from_numpy(np.random.default_rng(PAR["seed"] + 18).integers(
        0, qcfg.vocab, size=(M_ * PAR["micro_batch"], S2))).to(dev)

    def stage_fn(blocks, x):
        return tlm._run_stack(blocks, x, qcfg)[0]

    def pipe_run(pipelined):
        with tlm.trainable(U):
            x = tlm._embed(U, ptoks, qcfg).detach().reshape(M_, PAR["micro_batch"], S2, -1)
            if pipelined:
                y = gpipe(stage_fn, stage_blocks, x, pipe_mesh, axis="model")
            else:
                outs = []
                for m in range(M_):
                    h = x[m]
                    for s in range(S_):
                        h = stage_fn(stage_blocks[s], h)
                    outs.append(h)
                y = torch.stack(outs)
            params = [p for blocks in stage_blocks for b in blocks for p in b.parameters()]
            grads = torch.autograd.grad(torch.mean(torch.square(y.float())), params)
        return y.detach(), grads

    (y_p, g_p), pipe_s = sync_s(lambda: pipe_run(True))
    (y_s, g_s), seq_s = sync_s(lambda: pipe_run(False))
    fwd_bitwise = torch.equal(y_p, y_s)
    grad_bitwise = all(torch.equal(a, b) for a, b in zip(g_p, g_s))
    check(fwd_bitwise and grad_bitwise, f"(c) gpipe against the stages in sequence: forward "
                                        f"bitwise {fwd_bitwise}, gradients {grad_bitwise}")
    del g_p, g_s
    with torch.no_grad():
        x = tlm._embed(U, ptoks, qcfg)
        y_u = tlm._run_stack(list(U.blocks), x, qcfg)[0]

        def last_logits(y):
            h = tlayers.rmsnorm(y.reshape(M_ * PAR["micro_batch"], S2, -1)[:, -1],
                                U.final_norm, qcfg.norm_eps)
            return tlm._logits(U, h, qcfg)

        c_err = compare(f"gpipe ({S_} stages of {per} blocks, {M_} microbatches of "
                        f"{PAR['micro_batch']} x {S2}) vs the unpipelined forward (last-token "
                        f"logits)", [last_logits(y_p)], [last_logits(y_u)], rtol=0.15,
                        atol=0.15, why="tests/test_arch_smoke.py:81-83 gate")
    bubble = (S_ - 1) / (M_ + S_ - 1)
    report["pipeline"] = {"stages": S_, "microbatches": M_, "bubble_share": bubble,
                          "forward_bitwise": fwd_bitwise, "grads_bitwise": grad_bitwise,
                          "vs_unpipelined_max_abs_err": c_err, "pipelined_s": pipe_s,
                          "sequential_s": seq_s}
    print(f"[phase 18] {smi}: gpipe over {qcfg.n_layers} blocks, {S_} stages of {per}, "
          f"{M_} microbatches of {PAR['micro_batch']} x {S2}: forward and gradients bitwise "
          f"the stages in sequence; bubble share (S - 1) / (M + S - 1) = {S_ - 1}/"
          f"{M_ + S_ - 1} = {bubble:.4f}; forward + backward {pipe_s:.2f} s pipelined, "
          f"{seq_s:.2f} s in sequence (one card: the stages share it)")
    del U, y_p, y_s, y_u, x, stage_blocks
    check(ops.launch_counts() == NO_LAUNCHES,
          f"the parallel/ paths launched a kernel: {ops.launch_counts()}")
    gc.collect()
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    print("[phase 18] " + json.dumps(report))
    print(f"[phase 18] took {report['seconds']:.1f} s")
    return report


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
    from repro_torch.optim import adamw, gp_hyperopt

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

    # rank-K sweep: L = chol(B), W = Phi_new D / sigma (K = 64).  The plain
    # sweep (a Python loop of K x M rotations) is held against the kernel on
    # W's first PLAIN_SWEEP_K rows and timed once there; the kernel at K = 64
    # is held against chol(LL^T + W^TW) and timed below
    W = (ops.expansion_phi(Xn, tile) * sqrtlam[None, :] / spec.noise).contiguous()
    K = W.shape[0]
    W8 = W[:PLAIN_SWEEP_K].contiguous()
    L8 = ops.chol_update(chol, W8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Lp = kchol.chol_update_plain(chol, W8)
    torch.cuda.synchronize()
    plain_sweep_ms = (time.perf_counter() - t0) * 1e3
    tol_chol = dict(rtol=5e-3, atol=1e-3, why="tests/test_streaming_fit.py:214 chol gate")
    err = compare(f"chol_update vs plain sweep (M={M}, K={PLAIN_SWEEP_K}: W's first "
                  f"{PLAIN_SWEEP_K} rows)", [L8], [Lp], **tol_chol)
    print(f"[chol_update] the plain sweep at M={M}, K={PLAIN_SWEEP_K}: {plain_sweep_ms:.1f} ms, "
          f"timed once (the kernels line's plain_ms)")
    del Lp, L8, W8
    L1 = ops.chol_update(chol, W)
    lib_L = torch.linalg.cholesky(chol @ chol.T + W.T @ W)
    err = max(err, compare(f"chol_update vs chol(LL^T + W^TW) (M={M}, K={K})", [L1], [lib_L],
                           **tol_chol))
    del lib_L, L1
    s_flops = 6 * K * M * (M - 1) / 2
    s_bytes = 4 * (2 * M * (M + 1) / 2 + K * M)
    rows["chol_update"] = dict(
        source="src/repro_torch/kernels/csrc/chol_update.cu",
        replaces="src/repro/core/fagp.py:1052", max_abs_err=err,
        ms=cuda_ms(lambda: ops.chol_update(chol, W), reps=20, warmup=1),
        plain_ms=plain_sweep_ms, plain_K=PLAIN_SWEEP_K,
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
    main_fit_s = out["fit_s"]
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
    # microbatch (256 rows of mixed tenants), the pipelined engine's top
    # rung (4 coalesced microbatches, 1,024 rows: phase 9's usual block) and
    # an ingest round's rows (every slot's 16-row group, 8,192 rows)
    K = F["ingest_chunk"]
    Xk = torch.from_numpy(np.stack([pool[0][N:N + K] for pool in pools])).to(dev)
    yk = torch.from_numpy(np.stack([pool[1][N:N + K] for pool in pools])).to(dev)
    Xq1k = torch.from_numpy(np.random.default_rng(23).uniform(
        -1.0, 1.0, (4 * F["microbatch"], p)).astype(np.float32)).to(dev)
    tol_fphi = dict(tol_phi, rtol=4e-5 * max(4, F["n"]))
    for r in (Xq16, Xq1k, Xk.reshape(-1, p)):
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
    # the serving cache rode along, its refreshed slots (one slot in each
    # mutation) bitwise a fresh cache's (fagp._bank_binv)
    check("_binv_cache" in b1.__dict__ and "_binv_cache" in b2.__dict__,
          "evict/insert did not carry the B^-1 cache")
    for name, bk in (("evict", b1), ("insert", b2)):
        check(torch.equal(bk._binv, fagp._bank_binv(bk.stack.chol)),
              f"the B^-1 cache carried through {name} differs from a fresh one")
    print("[fleet] B^-1 cache carried through evict and insert == a fresh cache, bitwise")
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

    # -- 7. GP.optimize: the differentiable NLML and the lane engine ---------
    opt_t0 = time.perf_counter()
    N, p, n = MAIN["n_train"], MAIN["p"], MAIN["n"]
    ones_N = torch.ones(N, device=dev)

    def nlml_row(sp):
        with torch.no_grad():
            return float(fagp.nlml(X0, y0, sp)) / N

    # (a) the Figure 1 point at full width, its fused-fit launches exact
    seen = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ogp = GP.optimize(X0, y0, spec, steps=OPT["steps"], restarts=1,
                      callback=lambda step, v, sp: seen.append(v))
    torch.cuda.synchronize()
    optimize_s = time.perf_counter() - t0
    ocounts = ops.launch_counts()
    print(f"[optimize] N={N} M={M} steps={OPT['steps']}: optimize_s={optimize_s:.4f} "
          f"launches={json.dumps(ocounts)}")
    check(ocounts == OPT_EXPECTED, f"GP.optimize launch counts {ocounts} != {OPT_EXPECTED}")
    v_init, v_end = nlml_row(spec), nlml_row(ogp.spec)
    print(f"[optimize] nlml per row: at the init {v_init:.6f}, per step "
          f"{[round(v, 6) for v in seen]}, at the learned spec {v_end:.6f}; learned "
          f"eps={[round(float(e), 5) for e in ogp.spec.eps]} "
          f"rho={[round(float(r), 5) for r in ogp.spec.rho]} noise={float(ogp.spec.noise):.5f}")
    check(v_end < v_init, "GP.optimize did not lower the NLML per row")
    mu_o, var_o, _ = microbatched_mean_var(ogp, Xq_all, microbatch=MAIN["microbatch"])
    rmse_o = float(np.sqrt(np.mean((mu_o - ysq) ** 2)))
    print(f"[optimize] the optimized GP on {Xq_all.shape[0]} queries: rmse={rmse_o:.5f}")
    check(rmse_o < 0.1 and np.all(np.isfinite(var_o)),
          "the optimized GP's rmse >= 0.1 on the cos target, or its variance is not finite")
    del ogp
    torch.cuda.empty_cache()

    def log_leaves():
        return {f"log_{f}": torch.log(getattr(spec, f)).detach().clone().requires_grad_()
                for f in ("eps", "rho", "noise")}

    def lane_value(backend, lv):
        sp = gp_hyperopt._hp_to_spec(spec.replace(backend=backend), lv)
        return fagp._nlml_core(X0, y0, sp, ones_N)

    # where a step's time goes (CUDA events): the value alone (the fused
    # fit, the M x M Cholesky and the solve), the Cholesky alone, the
    # backward pass alone (through the Cholesky and the streamed blocks),
    # the streamed blocks alone (the moments' VJP of a random cotangent),
    # and one whole step with its peak memory
    lv = log_leaves()
    with torch.no_grad():
        value_ms = cuda_ms(lambda: lane_value("pallas", lv), reps=5, warmup=1)
        G7, _ = fagp._moments_via_registry(spec, X0, y0, ones_N)
        B7, _ = fagp._assemble_scaled_system(
            G7, get_expansion("hermite").log_eigenvalues(fagp._idx_tensor(spec), spec),
            spec.noise**2)
        chol_ms = cuda_ms(lambda: torch.linalg.cholesky(B7), reps=5, warmup=1)
    del G7, B7
    v7 = lane_value("pallas", lv)
    backward_ms = cuda_ms(lambda: torch.autograd.grad(v7, list(lv.values()), retain_graph=True),
                          reps=3, warmup=1)
    del v7
    sp7 = gp_hyperopt._hp_to_spec(spec, lv)
    Gm, bm = fagp._MomentsDiff.apply(sp7.eps, sp7.rho, sp7.noise, sp7.omega, X0, y0, ones_N, sp7)
    cot = (torch.randn(M, M, generator=gen).to(dev), torch.randn(M, generator=gen).to(dev))
    blocks_ms = cuda_ms(lambda: torch.autograd.grad(
        (Gm, bm), [lv["log_eps"], lv["log_rho"]], cot, retain_graph=True), reps=3, warmup=1)
    del Gm, bm, cot, sp7
    torch.cuda.empty_cache()
    hp7 = {f: t.detach()[None, None] for f, t in lv.items()}
    ocfg = adamw.AdamWConfig(lr=5e-2, weight_decay=0.0, clip_norm=None)

    def one_step():
        return gp_hyperopt._lane_step(
            hp7, adamw.init(hp7, ocfg), torch.zeros((1, 1), dtype=torch.bool, device=dev),
            torch.full((1, 1), float("inf"), device=dev), [(X0, y0, ones_N)], spec,
            float("-inf"), ocfg)

    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(one_step, reps=3, warmup=1)
    step_peak = torch.cuda.max_memory_allocated()
    print(f"[optimize] value_ms={value_ms:.3f} (cholesky_ms={chol_ms:.3f}) "
          f"backward_ms={backward_ms:.3f} (streamed blocks {blocks_ms:.3f}) "
          f"step_ms={step_ms:.3f}; step peak {step_peak} bytes allocated "
          f"({step_peak - base_bytes} above the {base_bytes} held before it)")

    # the value and its gradient in (log eps, log rho, log noise) on both
    # backends, and a float64 witness of the same NLML (ROADMAP.md section
    # C, C5): in float32 at this width both backends sit outside the JAX
    # package's gates from it (printed); the streamed backward pass itself,
    # run in float64, is held against direct float64 autograd at them
    grads7 = {}
    for be in ("pallas", "jnp"):
        lvb = log_leaves()
        vb = lane_value(be, lvb)
        grads7[be] = [vb.detach().double().reshape(1)] + [
            g.double() for g in torch.autograd.grad(vb, list(lvb.values()))]
        del vb

    def leaves64():
        return {f: t.detach().double().clone().requires_grad_() for f, t in log_leaves().items()}

    X64, y64, ones64 = X0.double(), y0.double(), ones_N.double()
    l_s = leaves64()
    v_s = fagp._nlml_core(X64, y64, gp_hyperopt._hp_to_spec(spec.replace(backend="jnp"), l_s),
                          ones64)
    streamed = [v_s.detach().reshape(1)] + list(torch.autograd.grad(v_s, list(l_s.values())))
    del v_s
    l_d = leaves64()
    sp_d = gp_hyperopt._hp_to_spec(spec, l_d)
    exp_h, idx_h = get_expansion("hermite"), fagp._idx_tensor(spec)
    G64 = torch.zeros((M, M), dtype=torch.float64, device=dev)
    b64 = torch.zeros(M, dtype=torch.float64, device=dev)
    for lo in range(0, N, 2048):
        Ph = exp_h.features(X64[lo:lo + 2048], idx_h, sp_d)
        G64 = G64 + Ph.T @ Ph
        b64 = b64 + Ph.T @ y64[lo:lo + 2048]
    del Ph
    B64, d64 = fagp._assemble_scaled_system(G64, exp_h.log_eigenvalues(idx_h, sp_d),
                                            sp_d.noise**2)
    L64 = torch.linalg.cholesky(B64)
    s2 = sp_d.noise**2
    bs64 = d64 * b64 / s2
    w64 = torch.cholesky_solve(bs64[:, None], L64)[:, 0]
    v_d = 0.5 * ((y64 @ y64) / s2 - bs64 @ w64 + 2.0 * torch.log(torch.diagonal(L64)).sum()
                 + N * torch.log(s2) + N * math.log(2.0 * math.pi))
    direct = [v_d.detach().reshape(1)] + list(torch.autograd.grad(v_d, list(l_d.values())))
    del G64, b64, B64, L64, v_d, sp_d, l_d
    torch.cuda.empty_cache()
    compare(f"float64 nlml value, streamed (jnp backend) vs direct autograd ({N}x{M})",
            streamed[:1], direct[:1], rtol=1e-4, atol=0.0, why="tests/test_gp_hyperopt.py:123")
    compare(f"float64 nlml gradient in log eps, log rho, log noise, streamed vs direct "
            f"({N}x{M})", streamed[1:], direct[1:], rtol=1e-3, atol=1e-2,
            why="tests/test_gp_hyperopt.py:126")

    def gate_ratio(got, want, rtol, atol):
        return max(float(((g - w).abs() / (atol + rtol * w.abs())).max())
                   for g, w in zip(got, want))

    f32_gap = {be: dict(value_rel=float((g[0] - direct[0]).abs() / direct[0].abs()),
                        value_ratio=gate_ratio(g[:1], direct[:1], 1e-4, 0.0),
                        grad_ratio=gate_ratio(g[1:], direct[1:], 1e-3, 1e-2))
               for be, g in grads7.items()}
    f32_gap["pallas_vs_jnp"] = dict(
        value_ratio=gate_ratio(grads7["pallas"][:1], grads7["jnp"][:1], 1e-4, 0.0),
        grad_ratio=gate_ratio(grads7["pallas"][1:], grads7["jnp"][1:], 1e-3, 1e-2))
    print(f"[optimize] float32 against the float64 witness ({N}x{M}; error/tolerance at the "
          f"JAX gates, no gate here: ROADMAP.md section C, C5): {json.dumps(f32_gap)}")
    del grads7, streamed, direct, X64, y64, ones64
    torch.cuda.empty_cache()

    # the two backends at the JAX package's gates where float32 holds them
    # (C5): that test's own case (tests/test_gp_hyperopt.py:108-128: N = 200,
    # p = 2, n = 6, seed 3, at log eps = 0), its value and its gradient in
    # log eps; the gradients in log rho and log noise printed beside
    G_ = OPT_GATE
    Xg, yg, _, _ = make_gp_dataset(G_["n_train"], G_["p"], noise=0.05, seed=G_["seed"],
                                   device=dev)
    gspec = GPSpec.create(G_["n"], eps=np.ones(G_["p"], np.float32), rho=2.0, noise=0.05,
                          device=dev)
    gate7 = {}
    for be in ("pallas", "jnp"):
        lvg = {f"log_{f}": torch.log(getattr(gspec, f)).detach().clone().requires_grad_()
               for f in ("eps", "rho", "noise")}
        vg = fagp._nlml_core(Xg, yg, gp_hyperopt._hp_to_spec(gspec.replace(backend=be), lvg),
                             torch.ones(Xg.shape[0], device=dev))
        gate7[be] = [vg.detach().reshape(1)] + list(torch.autograd.grad(vg, list(lvg.values())))
    gw = f"N={G_['n_train']}, p={G_['p']}, n={G_['n']}"
    compare(f"nlml value, pallas vs jnp backend ({gw})", gate7["pallas"][:1], gate7["jnp"][:1],
            rtol=1e-4, atol=0.0, why="tests/test_gp_hyperopt.py:123")
    compare(f"nlml gradient in log eps, pallas vs jnp backend ({gw})", gate7["pallas"][1:2],
            gate7["jnp"][1:2], rtol=1e-3, atol=1e-2, why="tests/test_gp_hyperopt.py:126")
    print(f"[optimize] gradient in log rho / log noise, pallas vs jnp ({gw}), error/tolerance "
          f"at rtol 1e-3, atol 1e-2 (no gate, C5): "
          f"{gate_ratio(gate7['pallas'][2:3], gate7['jnp'][2:3], 1e-3, 1e-2):.3f} / "
          f"{gate_ratio(gate7['pallas'][3:], gate7['jnp'][3:], 1e-3, 1e-2):.3f}")
    del gate7, Xg, yg

    # (b) the lane engine at the fleet's width: 8 tenants x 4 restarts of
    # phase 5's per-tenant shape, the fused-fit launches exact, tenants 0
    # and 1 alone through optimize_restarts bitwise equal to their lanes
    OF = OPT_FLEET
    _, Xf, yf, _ = fleet_dataset(np.random.default_rng(OF["seed"]), tenants=OF["tenants"],
                                 n_train=OF["n_train"], p=OF["p"], rounds=1,
                                 observations_per_round=OF["tenants"], noise=OF["noise"],
                                 seed=OF["seed"])
    Xf, yf = torch.from_numpy(Xf).to(dev), torch.from_numpy(yf).to(dev)
    fspec = spec_for("hermite", OF["p"], OF["n"])
    marks = []

    def mark(step, vals, hp):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fres = gp_hyperopt.optimize_fleet(Xf, yf, fspec, restarts=OF["restarts"],
                                      steps=OF["steps"], seed=OF["seed"], callback=mark)
    torch.cuda.synchronize()
    fleet_opt_s = time.perf_counter() - t0
    fcounts7 = ops.launch_counts()
    lanes = OF["tenants"] * OF["restarts"]
    step_s = [b_ - a_ for a_, b_ in zip([t0] + marks[:-1], marks)]
    print(f"[optimize fleet] {OF['tenants']} tenants x {OF['restarts']} restarts, "
          f"N={OF['n_train']} M={fspec.n_features()} steps={OF['steps']}: "
          f"optimize_fleet_s={fleet_opt_s:.4f} step_s={[round(x, 4) for x in step_s]} "
          f"lane_ms={1e3 * statistics.median(step_s) / lanes:.3f} "
          f"launches={json.dumps(fcounts7)}")
    want7 = lanes * (OF["steps"] + 1)
    check(fcounts7["phi_gram"] == {"moments": want7} and not fcounts7["phi_features"],
          f"optimize_fleet launch counts {fcounts7} != {want7} fused fits")
    for t in (0, 1):
        one = gp_hyperopt.optimize_restarts(Xf[t], yf[t], fspec, restarts=OF["restarts"],
                                            steps=OF["steps"], seed=OF["seed"])
        for f in ("eps", "rho", "noise", "nlml", "lane_nlml"):
            check(torch.equal(getattr(fres, f)[t], getattr(one, f)[0]),
                  f"tenant {t}: the fleet's {f} is not bitwise its single run's")
    print(f"[optimize fleet] tenants 0 and 1 alone: bitwise the fleet's lanes; best "
          f"restarts {fres.best_restart.tolist()}, nlml per row "
          f"{[round(float(v), 5) for v in fres.nlml]}")
    print("[optimize] " + json.dumps({
        "optimize_s": optimize_s, "value_ms": value_ms, "cholesky_ms": chol_ms,
        "backward_ms": backward_ms, "blocks_ms": blocks_ms, "step_ms": step_ms,
        "step_peak_bytes": step_peak, "bytes_before_step": base_bytes, "rmse": rmse_o,
        "nlml_row_init": v_init, "nlml_row_end": v_end, "fleet_optimize_s": fleet_opt_s,
        "fleet_step_s": step_s, "fleet_lane_ms": 1e3 * statistics.median(step_s) / lanes}))
    del Xf, yf, fres
    rows["phi_gram"]["launches"] = sum(counts["phi_gram"].values()) \
        + sum(ocounts["phi_gram"].values()) + sum(fcounts7["phi_gram"].values())
    print(f"[optimize] phase took {time.perf_counter() - opt_t0:.1f} s")

    # -- 8. re-optimizing fleets, the downdate and refit_window -------------
    phase8_t0 = time.perf_counter()
    from repro_torch.kernels.hermite_phi import slot_tile

    RF = REOPT_FLEET
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rout = serve_fleet(engine="sync", backend="pallas", device="cuda", **RF)
    part_a_serve_s = time.perf_counter() - t0
    rcounts8 = ops.launch_counts()
    hbank = rout.pop("bank")
    B, N, p, FM = RF["tenants"], RF["n_train"], RF["p"], rout["M"]
    for h in rout["rounds"]:
        print(f"[reopt fleet] round {h['round']}: rows_absorbed={h['rows_absorbed']} "
              f"ingest_rounds={h['ingest_rounds']} ingest_s={h['ingest_s']:.4f} "
              f"reopt_tenants={h['reopt_tenants']} reopt_s={h['reopt_s']:.4f} "
              f"query_mean_s={h['query_mean_s']:.5f} queries_per_s={h['queries_per_s']:.1f} "
              f"rmse={h['rmse']:.5f}")
    stale_n = sum(h["reopt_tenants"] for h in rout["rounds"])
    first = min(h["round"] for h in rout["rounds"] if h["reopt_tenants"])
    blocks = -(-RF["queries_per_round"] // RF["microbatch"])
    homo_ingest = sum(h["ingest_rounds"] for h in rout["rounds"] if h["round"] <= first)
    het_ingest = sum(h["ingest_rounds"] for h in rout["rounds"] if h["round"] > first)
    het_rounds = RF["rounds"] - first
    # the fit; per ingest round a feature launch (per-row once heterogeneous)
    # and a batched sweep; per microbatch a feature launch, per-row on the
    # heterogeneous bank; per lane a fused fit a step and one for its final
    # value; one bank fused fit with per-slot constants for the refit
    reopt_expected = {
        "phi_features": {k: v for k, v in (
            ("", (RF["rounds"] - het_rounds) * blocks + homo_ingest),
            ("slots", het_rounds * blocks + het_ingest)) if v},
        "phi_gram": {"bank": 1, "bank_slots": 1,
                     "moments": stale_n * RF["reopt_restarts"] * (RF["reopt_steps"] + 1)},
        "diag_quad": {},
        "chol_update": {"batched": homo_ingest + het_ingest},
        "scaled_gram": {},
    }
    print(f"[reopt fleet] stale tenants re-optimized: {stale_n} of {B}; launches="
          f"{json.dumps(rcounts8)}")
    check(stale_n > 0 and hbank.hypers is not None,
          "the re-optimizing fleet re-optimized no tenant, or its bank is not heterogeneous")
    check(rcounts8 == reopt_expected,
          f"re-optimizing fleet launch counts {rcounts8} != expected {reopt_expected}")
    check(all(h["rmse"] < 0.1 and h["var_finite"] for h in rout["rounds"]),
          "re-optimizing fleet: rmse >= 0.1 or non-finite variances")
    h8 = hbank.hypers
    moved = torch.nonzero((h8.eps != hbank.spec.eps).any(1) | (h8.noise != hbank.spec.noise))
    opt_slots = [int(s) for s in moved[:, 0].tolist()]
    check(len(opt_slots) == stale_n, f"{len(opt_slots)} slots hold learned hypers, "
          f"{stale_n} were re-optimized")
    for t in opt_slots[:2]:
        m1, v1 = GP.from_state(hbank.state(t)).mean_var(Xq16)
        m2, v2 = hbank.mean_var([t] * Xq16.shape[0], Xq16)
        compare(f"re-optimized tenant {t}: bank vs its own session, mean", [m2], [m1],
                rtol=0.0, atol=1e-5, why="tests/test_gp_bank.py:90 gate")
        compare(f"re-optimized tenant {t}: bank vs its own session, variance", [v2], [v1],
                rtol=0.0, atol=1e-5, why="tests/test_gp_bank.py:91 gate")
    print(f"[reopt fleet] tenant {opt_slots[0]}: learned eps="
          f"{[round(float(e), 5) for e in h8.eps[opt_slots[0]]]} "
          f"noise={float(h8.noise[opt_slots[0]]):.5f}")

    # the per-row features launch (TPU #2) on one 256-row mixed microbatch of
    # the heterogeneous bank: bitwise its plain version, each row bitwise the
    # plain version under its own slot's tile, bitwise the shared launch
    # where every slot's constants are equal; timed beside the shared launch
    hexp, hidx = get_expansion("hermite"), hbank.stack.idx
    htile = hexp.slot_tile_args(hbank.spec, hidx, h8.eps, h8.rho)
    ftile8 = hexp.tile_args(hbank.spec, hidx)
    q_mix = torch.tensor(np.random.default_rng(12).choice(opt_slots + list(range(min(64, B))), 256),
                         dtype=torch.int32, device=dev)
    ph_k = ops.expansion_phi(Xq16, htile, q_mix)
    ph_p = plain(lambda: kphi.phi_features_plain(Xq16, htile, q_mix))
    rows_ok = all(bool(torch.equal(ph_k[q_mix == s], kphi.phi_features_plain(
        Xq16[q_mix == s], slot_tile(htile, s)))) for s in torch.unique(q_mix).tolist())
    same8 = dataclasses.replace(ftile8, consts=ftile8.consts.expand(B, p, 3).contiguous())
    shared_ok = bool(torch.equal(ops.expansion_phi(Xq16, same8, q_mix),
                                 ops.expansion_phi(Xq16, ftile8)))
    print(f"[check] per-row features (256x{FM}): bitwise plain {bool(torch.equal(ph_k, ph_p))}, "
          f"each row bitwise its slot's tile {rows_ok}, equal constants bitwise the shared "
          f"launch {shared_ok}")
    check(bool(torch.equal(ph_k, ph_p)) and rows_ok and shared_ok,
          "the per-row features launch is not bitwise its plain version or the shared launch")
    out8 = torch.empty((256, FM), device=dev)
    feat8 = dict(slots_kernel_ms=graph_ms(lambda: kphi.phi_features_launch(Xq16, htile, out8,
                                                                           q_mix)),
                 shared_kernel_ms=graph_ms(lambda: kphi.phi_features_launch(Xq16, ftile8, out8)),
                 slots_call_ms=cuda_ms(lambda: ops.expansion_phi(Xq16, htile, q_mix)),
                 shared_call_ms=cuda_ms(lambda: ops.expansion_phi(Xq16, ftile8)),
                 slots_plain_ms=cuda_ms(lambda: kphi.phi_features_plain(Xq16, htile, q_mix),
                                        reps=5, warmup=1))
    print(f"[kernel] phi_features per-row (256x{FM}): {json.dumps(feat8)}")
    del out8, ph_k, ph_p

    # the bank fused fit (TPU #4) with per-slot constants on 8 re-optimized
    # tenants' pool data: each slot bitwise the shared launch under its own
    # map, every map equal bitwise the shared launch, against its plain
    # version at the fit gate; timed beside the shared launch
    sel = opt_slots[:8]
    _, _, _, pools8 = fleet_dataset(
        np.random.default_rng(RF["seed"]), tenants=B, n_train=N, p=p, rounds=RF["rounds"],
        observations_per_round=RF["observations_per_round"], noise=RF["noise"],
        seed=RF["seed"])
    Xs8 = torch.from_numpy(np.stack([pools8[t][0] for t in sel])).to(dev)
    ys8 = torch.from_numpy(np.stack([pools8[t][1] for t in sel])).to(dev)
    ms8 = torch.ones(ys8.shape, device=dev)
    stile = hexp.slot_tile_args(hbank.spec, hidx, h8.eps[sel], h8.rho[sel])
    G8, b8 = ops.bank_fused_fit_moments(Xs8, ys8, stile, ms8)
    bit8 = all(bool(torch.equal(G8[i], ops.bank_fused_fit_moments(
        Xs8, ys8, slot_tile(stile, i), ms8)[0][i])) for i in (0, len(sel) - 1))
    same_s = dataclasses.replace(ftile8, consts=ftile8.consts.expand(len(sel), p, 3).contiguous())
    eq8 = all(bool(torch.equal(a, c)) for a, c in zip(
        ops.bank_fused_fit_moments(Xs8, ys8, same_s, ms8),
        ops.bank_fused_fit_moments(Xs8, ys8, ftile8, ms8)))
    sG8 = torch.empty_like(G8)
    sb8 = torch.empty_like(b8)
    for i in range(len(sel)):
        sG8[i], sb8[i] = gram_scales(Xs8[i], ys8[i], ms8[i], slot_tile(stile, i), None, 1.0,
                                     False)
    err8 = compare(f"bank phi_gram per-slot constants ({len(sel)} x {Xs8.shape[1]} x {FM})",
                   [G8, b8], plain(lambda: kgram.bank_phi_gram_plain(Xs8, ys8, ms8, stile)),
                   scales=[sG8, sb8], **tol_fit)
    print(f"[check] bank phi_gram per-slot: each slot bitwise the shared launch under its "
          f"map {bit8}; equal maps bitwise the shared launch {eq8}")
    check(bit8 and eq8, "the per-slot bank launch is not bitwise the shared launch")
    rows["phi_gram.bank"]["max_abs_err"] = max(rows["phi_gram.bank"]["max_abs_err"], err8)
    bank8 = dict(slots_ms=cuda_ms(lambda: ops.bank_fused_fit_moments(Xs8, ys8, stile, ms8)),
                 shared_ms=cuda_ms(lambda: ops.bank_fused_fit_moments(Xs8, ys8, ftile8, ms8)),
                 slots=len(sel), rows=int(Xs8.shape[1]))
    print(f"[kernel] phi_gram.bank per-slot constants: {json.dumps(bank8)}")
    del G8, b8, sG8, sb8, Xs8, ys8, ms8, pools8
    het_q = [h["query_mean_s"] for h in rout["rounds"] if h["round"] >= first]
    print(f"[reopt fleet] reopt_s={[h['reopt_s'] for h in rout['rounds']]} heterogeneous "
          f"query_mean_s={het_q} beside phase 5's homogeneous "
          f"{[round(h['query_mean_s'], 5) for h in fout['rounds']]}; serve_fleet took "
          f"{part_a_serve_s:.1f} s; part (a) {time.perf_counter() - phase8_t0:.1f} s")
    del hbank, htile, stile, same8, same_s
    torch.cuda.empty_cache()

    # (b) the downdate at full width: a homogeneous bank of the fleet's data,
    # every tenant forgets its first 16 rows
    part_b_t0 = time.perf_counter()
    _, Xb_np, yb_np, _ = fleet_dataset(
        np.random.default_rng(F["seed"]), tenants=B, n_train=N, p=p, rounds=F["rounds"],
        observations_per_round=F["observations_per_round"], noise=F["noise"], seed=F["seed"])
    Xd, yd = torch.from_numpy(Xb_np).to(dev), torch.from_numpy(yb_np).to(dev)
    del Xb_np, yb_np
    dbank = GPBank.fit(Xd, yd, fspec)
    Kf = FORGET
    ids = list(range(B))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    down, ok8 = dbank.downdate(ids, Xd[:, :Kf], yd[:, :Kf])
    torch.cuda.synchronize()
    downdate_s = time.perf_counter() - t0
    dcounts = ops.launch_counts()
    print(f"[downdate] GPBank.downdate G={B} K={Kf} M={FM}: {downdate_s:.4f} s, all ok "
          f"{bool(ok8.all())}, launches={json.dumps(dcounts)}")
    check(bool(ok8.all()), f"the full-width downdate lost a pivot in {int((~ok8).sum())} groups")
    check(dcounts["chol_update"] == {"downdate": 1} and dcounts["phi_features"] == {"": 1},
          f"GPBank.downdate launches {dcounts} != one downdate sweep and one features launch")
    Lg = dbank.stack.chol
    Wg = (ops.expansion_phi(Xd[:, :Kf].reshape(-1, p), ftile).reshape(B, Kf, FM)
          * dbank.stack.sqrtlam[:, None, :] / fspec.noise).contiguous()
    Lg0, Wg0 = Lg.clone(), Wg.clone()
    Ld, okd = ops.chol_downdate(Lg, Wg)
    check(torch.equal(Lg, Lg0) and torch.equal(Wg, Wg0), "the downdate sweep wrote its inputs")
    check(bool(okd.all()) and torch.equal(Ld, down.stack.chol)
          and bool(torch.all(torch.triu(Ld, 1) == 0)),
          "the downdate sweep is not the bank's factor, or lost a pivot")
    del Lg0, Wg0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Lp, okp = plain(lambda: kchol.chol_downdate_plain(Lg, Wg))
    torch.cuda.synchronize()
    down_plain_ms = (time.perf_counter() - t0) * 1e3
    check(bool(okp.all()), "the plain downdate lost a pivot")
    derr = compare(f"batched chol_downdate vs plain sweep (G={B}, M={FM}, K={Kf})",
                   [Ld], [Lp], **tol_chol)
    compare(f"batched chol_downdate vs chol(LL^T - W^TW) (G={B}, M={FM}, K={Kf})",
            [Ld], [torch.linalg.cholesky(Lg @ Lg.mT - Wg.mT @ Wg)], **tol_chol)
    del Lp, Ld
    dd_bytes = B * 4 * (2 * FM * (FM + 1) / 2 + Kf * FM)
    dd_flops = B * 6 * Kf * FM * (FM - 1) / 2
    rows["chol_downdate.batched"] = dict(
        source="src/repro_torch/kernels/csrc/chol_update.cu",
        replaces="src/repro/bank/bank.py:138", max_abs_err=derr,
        launches=dcounts["chol_update"]["downdate"],
        ms=cuda_ms(lambda: ops.chol_downdate(Lg, Wg), reps=20, warmup=2),
        plain_ms=down_plain_ms,
        library_ms=cuda_ms(lambda: torch.linalg.cholesky(Lg @ Lg.mT - Wg.mT @ Wg),
                           reps=20, warmup=2),
        bound=bound(dd_flops, dd_bytes))
    print(f"[plan chol_downdate.batched] G={B} M={FM} K={Kf}: "
          f"{json.dumps(kchol.chol_downdate_batch_plan(FM, Kf))}; "
          f"{regs_of('chol_downdate_batch_kernel')}")
    print(f"[kernel] chol_downdate.batched chain bound (one step {step_us:.4f} us): "
          f"(K + M - 1) steps {(Kf + FM - 1) * step_us / 1e3:.4f} ms; {-(-FM // 32)} panels "
          f"x (K + 31) steps {-(-FM // 32) * (Kf + 31) * step_us / 1e3:.4f} ms")
    del Wg

    # refit_window on the retained rows (one bank launch, each slot under
    # its own map) against the downdated bank on mixed-tenant queries
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rbank = dbank.refit_window(ids, Xd[:, Kf:], yd[:, Kf:])
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    fcounts8 = ops.launch_counts()
    check(fcounts8["phi_gram"] == {"bank_slots": 1} and not fcounts8["phi_features"],
          f"refit_window launches {fcounts8} != one bank launch")
    q8 = [int(t) for t in np.random.default_rng(13).integers(0, B, 256)]
    mu_d, var_d = down.mean_var(q8, Xq16)
    mu_r, var_r = rbank.mean_var(q8, Xq16)
    dist = dict(mean=float((mu_d - mu_r).abs().max()), var=float((var_d - var_r).abs().max()))
    # float64 refits of 8 tenants' retained rows: where each float32 result sits
    idx8 = fagp._idx_tensor(fspec)
    sp64 = dataclasses.replace(fspec, eps=fspec.eps.double(), rho=fspec.rho.double(),
                               noise=fspec.noise.double())
    ll64 = get_expansion("hermite").log_eigenvalues(idx8, sp64)
    d64 = torch.exp(0.5 * ll64)
    far = {"downdate": dict(mean=0.0, var=0.0), "refit_window": dict(mean=0.0, var=0.0)}
    for t in range(8):
        Ph = get_expansion("hermite").features(Xd[t, Kf:].double(), idx8, sp64)
        B64 = torch.eye(FM, dtype=torch.float64, device=dev) \
            + d64[:, None] * (Ph.T @ Ph) * d64[None, :] / sp64.noise**2
        L64 = torch.linalg.cholesky(B64)
        u64 = d64 * torch.cholesky_solve((d64 * (Ph.T @ yd[t, Kf:].double()))[:, None],
                                         L64)[:, 0] / sp64.noise**2
        Pq = get_expansion("hermite").features(Xq16.double(), idx8, sp64)
        V = torch.linalg.solve_triangular(L64, (Pq * d64).T, upper=False)
        m64, v64 = Pq @ u64, (V * V).sum(0)
        for name, bk in (("downdate", down), ("refit_window", rbank)):
            m32, v32 = bk.mean_var([t] * 256, Xq16)
            far[name]["mean"] = max(far[name]["mean"], float((m32.double() - m64).abs().max()))
            far[name]["var"] = max(far[name]["var"], float((v32.double() - v64).abs().max()))
    print(f"[downdate] downdate vs refit_window at full width (G={B}, N={N}, K={Kf}, M={FM}, "
          f"256 mixed queries): {json.dumps(dist)} (gate 1e-5, "
          f"{'holds' if max(dist.values()) <= 1e-5 else 'does not hold: ROADMAP.md section C, C7'});"
          f" from a float64 refit of the retained rows (8 tenants): {json.dumps(far)}; "
          f"downdate_s={downdate_s:.4f} refit_s={refit_s:.4f}")
    del rbank, mu_d, var_d, mu_r, var_r

    # a mixed call: odd groups downdate 16 copies of a row they never
    # absorbed, from outside the data's box (a pivot is lost: ok False,
    # their slots bitwise unchanged; inside the box, at 10^4 rows, the
    # posterior variance is so small that 16 copies leave B positive
    # definite), even groups downdate their own first rows (the bits of
    # the all-tenant call)
    mix = list(range(min(32, B)))
    Xm, ym = Xd[:len(mix), :Kf].clone(), yd[:len(mix), :Kf].clone()
    Xm[1::2], ym[1::2] = 1.5, 50.0
    mbank, okm = dbank.downdate(mix, Xm, ym)
    want_ok = [g % 2 == 0 for g in mix]
    kept = all(torch.equal(getattr(mbank.stack, f)[g], getattr(dbank.stack, f)[g])
               for f in ("chol", "u", "b") for g in mix[1::2])
    good = all(torch.equal(mbank.stack.chol[g], down.stack.chol[g]) for g in mix[0::2])
    print(f"[check] mixed downdate (16 good, 16 bogus groups): ok as expected "
          f"{okm.tolist() == want_ok}, bogus slots bitwise unchanged {kept}, good factors "
          f"bitwise the all-tenant call's {good}")
    check(okm.tolist() == want_ok and kept and good, "the mixed downdate broke its contract")
    del down, mbank, dbank, Xd, yd, Lg
    torch.cuda.empty_cache()
    print(f"[downdate] part (b) took {time.perf_counter() - part_b_t0:.1f} s")

    # (c) the JAX package's own gate (benchmarks/tenant_churn.py:48-53, its
    # queries: 256 over the first 8 tenants from seed 11): the downdate
    # equals refit_window within 1e-5, on both backends
    C_ = CHURN
    Xc = np.zeros((C_["tenants"], C_["n_train"], C_["p"]), np.float32)
    yc = np.zeros((C_["tenants"], C_["n_train"]), np.float32)
    for s_ in range(C_["tenants"]):
        Xs_, ys_, _, _ = make_gp_dataset(C_["n_train"], C_["p"], seed=s_, device="cpu")
        Xc[s_], yc[s_] = Xs_.numpy(), ys_.numpy()
    crng = np.random.default_rng(11)
    cb = []
    for _ in range(4):
        cb.append(([int(i) for i in crng.integers(0, 8, 64)],
                   torch.from_numpy(crng.uniform(-1, 1, size=(64, C_["p"])).astype(np.float32))
                   .to(dev)))
    for be in ("pallas", "jnp"):
        cspec = GPSpec.create(C_["n"], eps=np.full((C_["p"],), 0.8, np.float32), rho=2.0,
                              noise=C_["noise"], backend=be, device=dev)
        cbank = GPBank.fit(torch.from_numpy(Xc).to(dev), torch.from_numpy(yc).to(dev), cspec)
        k_ = C_["forget"]
        cdown, cok = cbank.downdate(list(range(C_["tenants"])), Xc[:, :k_], yc[:, :k_])
        crefit = cbank.refit_window(list(range(C_["tenants"])), Xc[:, k_:], yc[:, k_:])
        check(bool(cok.all()), f"the churn-shape downdate lost a pivot ({be})")
        got = [cdown.mean_var(q, X_) for q, X_ in cb]
        want = [crefit.mean_var(q, X_) for q, X_ in cb]
        compare(f"downdate vs refit_window, churn shape ({be}) mean",
                [g[0] for g in got], [w[0] for w in want], rtol=0.0, atol=1e-5,
                why="benchmarks/tenant_churn.py:192 gate")
        compare(f"downdate vs refit_window, churn shape ({be}) variance",
                [g[1] for g in got], [w[1] for w in want], rtol=0.0, atol=1e-5,
                why="benchmarks/tenant_churn.py:193 gate")
    r = rows["chol_downdate.batched"]
    print(f"[kernel] chol_downdate.batched: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
          f"library_ms={r['library_ms']:.4f} bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}) "
          f"max_abs_err={r['max_abs_err']:.3e}")
    print("[reopt] " + json.dumps({
        "stale_tenants": stale_n, "reopt_s": [h["reopt_s"] for h in rout["rounds"]],
        "hetero_query_mean_s": het_q,
        "homo_query_mean_s": [h["query_mean_s"] for h in fout["rounds"]],
        "features_per_row": feat8, "bank_per_slot": bank8, "downdate_s": downdate_s,
        "refit_s": refit_s, "downdate_vs_refit": dist, "from_float64": far}))
    print(f"[reopt] phase took {time.perf_counter() - phase8_t0:.1f} s")

    # -- 9. pipelined fleet serving and the tiered bank (ROADMAP A4) -------
    _, ref9 = phase9(dev, fspec, fout, compare, Xq16)

    # -- 10. the Vecchia family (ROADMAP A6) ----------------------------------
    phase10(dev, compare, cuda_ms)

    # -- 11. the sharded fleet and the row-sharded fit (ROADMAP A5) ----------
    phase11(dev, fspec, compare, cuda_ms, ref9,
            dict(X=X0, y=y0, spec=spec, Xq=Xs[:MAIN["queries"]], fit_s=main_fit_s))

    # -- 12. the LM half's dense serving path (ROADMAP A8) ------------------
    phase12(dev, smi, compare)

    # -- 13. the LM half's training path (ROADMAP A8) -------------------------
    r13 = phase13(dev, smi, compare)

    # -- 14. the LM half's MoE family (ROADMAP A8) ----------------------------
    r14 = phase14(dev, smi, compare)

    # -- 15. the LM half's MLA family: deepseek-v3 (ROADMAP A8) ---------------
    phase15(dev, smi, compare)

    # -- 16. the LM half's SSM and hybrid families (ROADMAP A8) -----------------
    phase16(dev, smi, compare)

    # -- 17. the LM half's audio and VLM families (ROADMAP A8) ------------------
    phase17(dev, smi, compare)

    # -- 18. the production mesh and parallel/ (ROADMAP A8.7) ------------------
    phase18(dev, smi, compare, r13, r14)

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
        for extra in ("call_ms", "plain_K"):
            if extra in r:
                kernels[-1][extra] = r[extra]
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
