"""Where the hand-written kernels' time goes on the card.

    python3 benchmarks/torch_phi_gram_ablation.py             # from the repository root, one NVIDIA card
    python3 benchmarks/torch_phi_gram_ablation.py --src DIR   # also DIR's phi_features.cu (another checkout)

Builds ``src/repro_torch/kernels/csrc/phi_gram.cu`` (the fused fit),
``scaled_gram.cu`` (the Gram of a stored Phi) and ``phi_features.cu`` (the
features) as they are and variants of them, each the source with
statements replaced (compiled by ``nvcc`` with the port's own flags into
``build/phi_gram_ablation/``, in parallel), and times them on the same
inputs at the paper-scale shapes of ``chip_smoke.py``: the one-model fused
fit (N = 10^4, p = 4, n = 11, M = 14,641), its RFF path (R = 4,096,
M = 8,192), the fleet's bank kernel (512 slots, n = 5, M = 625) and the
scaled Gram of the stored Phi (10^4 x 14,641 float32).  The variants:

* ``fma_only``: features built for the first two steps only, then the FMAs
  alone on those tiles (the FMA core's time);
* ``build_only``: the FMAs of the first two steps only (the row tables and
  feature builds alone);
* ``lanes_16x16``: a warp's lanes as 16 x 2 threads, each 8 x 8 tile
  split 64 apart (the thread layout of diag_quad.cu), against the kernel's
  4 x 8 lanes;
* ``sg_l2_slice``: the scaled Gram with every step loading the first 32
  rows of Phi, an L2-resident slice (the same loads and FMAs, no HBM
  traffic after the first step);
* ``sg_fma_only``: the scaled Gram loading the first two steps only, then
  the FMAs alone (its FMA core with the ring's barriers).

The cut variants compute wrong Grams: they exist to time the phases.
``lanes_16x16`` computes the same bits, which is checked.

The features kernel is timed at the six shapes its paths give it (p = 4):
a phase-3 query microbatch (128 x 14,641) and update (64 x 14,641), a
fleet microbatch (256 x 625) and ingest round (8,192 x 625), phase 6's
stored Phi (10^4 x 14,641) and the RFF path's microbatch (128 x 8,192),
the kernel beside its ``ft_*`` variants (``FEATURE_VARIANTS``) and, with
``--src DIR``, the ``phi_features.cu`` of the checkout at DIR (a parent
commit from ``git archive``; the C signature is the same) as ``src``.  At
each shape: ``kernel_ms``, one launch's device time (R launches into one
output captured in a CUDA graph, the replays timed with CUDA events,
divided by R; the 586 MB of the largest shape exceed the 50 MB L2, so
each of its launches runs cold); ``call_ms``, CUDA events around
``ops.expansion_phi`` (host checks, allocation and launch); ``plain_ms``;
``bound_ms`` (inputs read and output written once at 3.35 TB/s);
``fill_ms``, ``out.fill_(0)`` timed as the kernel is (the card's own rate
for the same bytes from aligned 16-byte stores: a yardstick, not the same
function); the output's ``sha256``; and whether each variant's output is
bitwise the kernel's (required of all but the two that time the stores
alone).  At the two microbatch shapes the host time of a call and of its
pieces (host clock, no synchronization).  Prints one JSON line per shape
(the Gram kernels) or per library (the features) with the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# variant -> (source it builds, [(statement, replacement), ...])
VARIANTS = {
    "kernel": ("phi_gram", []),
    "fma_only": ("phi_gram", [("    if (k + 1 < steps) build(k + 1);\n",
                               "    if (k + 1 < steps && k < 1) build(k + 1);\n")]),
    "build_only": ("phi_gram", [("    if (k >= 0) {\n", "    if (k >= 0 && k < 2) {\n")]),
    "lanes_16x16": ("phi_gram", [
        ("  const int r0 = (warp / 2) * 32 + (lane / 8) * 4;\n"
         "  const int q0 = (warp % 2) * 64 + (lane % 8) * 4;\n",
         "  const int r0 = (tid / 16) * 4, q0 = (tid % 16) * 4;\n"),
        ("fi + r * kT + 16 + r0)", "fi + r * kT + 64 + r0)"),
        ("fj + r * kT + 32 + q0)", "fj + r * kT + 64 + q0)"),
        ("r0 + (u / 4) * 16 + u % 4", "r0 + (u / 4) * 64 + u % 4"),
        ("q0 + (v / 4) * 32 + v % 4", "q0 + (v / 4) * 64 + v % 4"),
    ]),
    "sg_kernel": ("scaled_gram", []),
    "sg_l2_slice": ("scaled_gram", [("const int row0 = s * kK + q * kQuarter + r;",
                                     "const int row0 = (s & 0) * kK + q * kQuarter + r;")]),
    "sg_fma_only": ("scaled_gram", [("      if (s < steps) ld.fetch(s, q, N, held);\n",
                                     "      if (s < 2) ld.fetch(s, q, N, held);\n"),
                                    ("      if (s < steps) ld.deposit(q, dst, held);\n",
                                     "      if (s < 2) ld.deposit(q, dst, held);\n")]),
}
# the features kernel's variants.  "ft_stores_only" builds the first tile's
# row table only; "ft_stores_constant" also stores 1.0 with no table read
# (the kernel's store pattern alone): those two write wrong values.
_SKIP_BUILD = ("    if (i + 1 < count) build(t + 1, nxt);\n", "")
FEATURE_VARIANTS = {
    "ft_kernel": [],
    "ft_streaming_stores": [("{ *dst = v; }", "{ __stcs(dst, v); }")],
    "ft_one_column": [("  for (int wide = 1; wide >= 0; --wide) {\n",
                       "  for (int wide = 0; wide >= 0; --wide) {\n")],
    "ft_eight_columns": [("    if (!wide || cb * tiles >= cap) break;\n", "    break;\n")],
    "ft_two_waves": [("    cap = (long long)P->resident * sms;\n",
                      "    cap = 2LL * P->resident * sms;\n")],
    "ft_threads_256": [("constexpr int kThreads = 128;", "constexpr int kThreads = 256;"),
                       ("(p <= 4 || c == 1) ? 8 : 4; }", "(p <= 4 || c == 1) ? 4 : 2; }")],
    "ft_rows_16": [("constexpr int kRows = 32;", "constexpr int kRows = 16;")],
    "ft_stores_only": [_SKIP_BUILD],
    "ft_stores_constant": [_SKIP_BUILD,
                           ("          float v = tab[off[c][0] + r];\n",
                            "          float v = 1.f;\n"),
                           ("          for (int j = 1; j < kP; ++j) v *= tab[off[c][j] + r];\n",
                            "")],
}
VARIANTS.update({name: ("phi_features", edits) for name, edits in FEATURE_VARIANTS.items()})
# (label, N, expansion, n or R) of the features kernel's paths; p = 4
FEATURE_SHAPES = (
    ("128x14641", 128, "hermite", 11),
    ("64x14641", 64, "hermite", 11),
    ("256x625", 256, "hermite", 5),
    ("8192x625", 8192, "hermite", 5),
    ("10000x14641", 10_000, "hermite", 11),
    ("128x8192 rff", 128, "rff_se", 4096),
)
PEAK_BYTES = 3.35e12  # B/s, H100 SXM HBM3


def build(out_dir: Path, other: Path = None) -> dict:
    """One shared library per variant, compiled in parallel; ``other``, a
    checkout's root, adds its phi_features.cu as ``src``."""
    from repro_torch.kernels import _build

    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise SystemExit("nvcc not found")
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {name: (_build.CSRC, source, edits) for name, (source, edits) in VARIANTS.items()}
    if other is not None:
        jobs["src"] = (other / "src" / "repro_torch" / "kernels" / "csrc", "phi_features", [])
    procs = {}
    for name, (csrc, source, edits) in jobs.items():
        text = (csrc / f"{source}.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: {source}.cu no longer contains {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    return libs


def cuda_ms(fn, reps=5, warmup=1):
    """Median CUDA-event time of ``fn`` (host work inside it included)."""
    import torch

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


def graph_ms(fn, reps, replays=10):
    """Device time of one ``fn``: ``reps`` calls captured in a CUDA graph,
    the replays timed with CUDA events, divided by ``reps``."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
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
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=None,
                    help="a checkout's root whose phi_features.cu is timed beside this one's")
    ap.add_argument("--reps", type=int, default=50,
                    help="features launches a CUDA graph captures")
    opts = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_phi_gram_ablation: needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.core import fagp
    from repro_torch.core.expansions import get_expansion
    from repro_torch.core.gp import GPSpec
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import hermite_phi as kphi
    from repro_torch.kernels.hermite_phi import KINDS

    dev = torch.device("cuda")
    libs = build(ROOT / "build" / "phi_gram_ablation", opts.src)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    P = ctypes.c_void_p
    stream = P(torch.cuda.current_stream().cuda_stream)

    def tile_of(spec):
        idx = fagp._idx_tensor(spec)
        exp = get_expansion(spec.expansion)
        return (exp.tile_args(spec, idx), torch.exp(0.5 * exp.log_eigenvalues(idx, spec)),
                float(spec.noise**2))

    eps = np.full((4,), 0.8, np.float32)
    main_t = tile_of(GPSpec.create(11, eps=eps, rho=2.0, noise=0.05, backend="pallas",
                                   device=dev))
    rff_t = tile_of(GPSpec.create_rff(eps, 0.05, num_features=4096, seed=0,
                                      backend="pallas", device=dev))
    bank_t = tile_of(GPSpec.create(5, eps=eps, rho=2.0, noise=0.05, backend="pallas",
                                   device=dev))
    gen = torch.Generator().manual_seed(0)
    N, slots = 10_000, 512
    X = (torch.rand(N, 4, generator=gen) * 2 - 1).to(dev)
    y = torch.randn(N, generator=gen).to(dev)
    Xb = (torch.rand(slots, N, 4, generator=gen) * 2 - 1).to(dev)
    yb = torch.randn(slots, N, generator=gen).to(dev)
    ones, onesb = torch.ones(N, device=dev), torch.ones(slots, N, device=dev)

    def one_model(lib, tile_sq_sig2):
        tile, d, sig2 = tile_sq_sig2
        out = torch.empty(tile.M, tile.M, device=dev)
        b = torch.empty(tile.M, device=dev)
        fn = lib.repro_phi_gram
        fn.restype = ctypes.c_int
        fn.argtypes = [P, P, P] + [ctypes.c_int] * 5 + [P] * 5 + [ctypes.c_float,
                                                                   ctypes.c_int, P, P, P]
        rc = fn(_build.ptr(X), _build.ptr(y), _build.ptr(ones), N, 4, tile.M,
                KINDS[tile.kind], tile.n_max, _build.ptr(tile.consts),
                _build.ptr(tile.coef), _build.ptr(tile.idx), _build.ptr(tile.table),
                _build.ptr(d), sig2, 1, _build.ptr(out), _build.ptr(b), stream)
        _build.check_launch(rc, "phi_gram (ablation)")
        return out, b

    def bank(lib, tile_sq_sig2):
        tile = tile_sq_sig2[0]
        G = torch.empty(slots, tile.M, tile.M, device=dev)
        b = torch.empty(slots, tile.M, device=dev)
        fn = lib.repro_bank_phi_gram
        fn.restype = ctypes.c_int
        fn.argtypes = [P, P, P] + [ctypes.c_int] * 6 + [P] * 7
        rc = fn(_build.ptr(Xb), _build.ptr(yb), _build.ptr(onesb), slots, N, 4, tile.M,
                KINDS[tile.kind], tile.n_max, _build.ptr(tile.consts),
                _build.ptr(tile.coef), _build.ptr(tile.idx), _build.ptr(tile.table),
                _build.ptr(G), _build.ptr(b), stream)
        _build.check_launch(rc, "phi_gram bank (ablation)")
        return G, b

    def scaled(lib, tile_sq_sig2):
        tile, d, sig2 = tile_sq_sig2
        out = torch.empty(tile.M, tile.M, device=dev)
        fn = lib.repro_scaled_gram_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [P, ctypes.c_int, ctypes.c_int, P, ctypes.c_float, P, P]
        rc = fn(_build.ptr(Phi), N, tile.M, _build.ptr(d), sig2, _build.ptr(out), stream)
        _build.check_launch(rc, "scaled_gram (ablation)")
        return (out,)

    def source_of(name):
        return VARIANTS[name][0] if name in VARIANTS else "phi_features"

    fused = {n: lib for n, lib in libs.items() if source_of(n) == "phi_gram"}
    sgram = {n: lib for n, lib in libs.items() if source_of(n) == "scaled_gram"}
    feats = {n: lib for n, lib in libs.items() if source_of(n) == "phi_features"}
    ok = True
    for shape, call, args in (("one model, N=10^4, M=14,641", one_model, main_t),
                              ("one model RFF, N=10^4, M=8,192", one_model, rff_t),
                              ("bank, 512 x 10^4, M=625", bank, bank_t)):
        ref = call(libs["kernel"], args)
        same = all(torch.equal(a, c) for a, c in zip(ref, call(libs["lanes_16x16"], args)))
        ok &= same
        del ref
        ms = {name: cuda_ms(lambda: call(lib, args)) for name, lib in fused.items()}
        print(json.dumps({"shape": shape, "card": card, "ms": ms,
                          "lanes_16x16_bitwise_equal": same}))
    del Xb, yb, onesb
    Phi = ops.expansion_phi(X, main_t[0])
    ms = {name: cuda_ms(lambda: scaled(lib, main_t)) for name, lib in sgram.items()}
    print(json.dumps({"shape": "scaled Gram, Phi 10^4 x 14,641 float32", "card": card,
                      "ms": ms}))
    del Phi, X, y, ones
    torch.cuda.empty_cache()
    ok &= features(feats, card, dev, opts.reps)
    return 0 if ok else 1


def features(libs: dict, card: str, dev, reps: int) -> bool:
    """The features kernel (``ft_kernel``), its variants and ``src`` at the
    paths' shapes; False if a variant that must keep the bits does not."""
    import numpy as np
    import torch
    from repro_torch.core import fagp
    from repro_torch.core.expansions import get_expansion
    from repro_torch.core.gp import GPSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels import hermite_phi as kphi

    entries = {}
    for name, lib in libs.items():
        fn = lib.repro_phi_features
        fn.restype = ctypes.c_int
        fn.argtypes = kphi.ARGTYPES["repro_phi_features"]
        entries[name] = fn

    def launch(fn, X, t, out):
        rc = fn(X.data_ptr(), X.shape[0], X.shape[1], t.M, kphi.KINDS[t.kind], t.n_max,
                kphi._addr(t.consts), kphi._addr(t.coef), kphi._addr(t.idx),
                kphi._addr(t.table), out.data_ptr(), kphi._current_stream(X.get_device()))
        if rc != 0:
            raise RuntimeError(f"repro_phi_features returned cudaError {rc}")

    eps = np.full((4,), 0.8, np.float32)
    gen = torch.Generator().manual_seed(0)
    rows = {name: [] for name in libs}
    host, ok = {}, True
    for label, N, expansion, nr in FEATURE_SHAPES:
        if expansion == "hermite":
            spec = GPSpec.create(nr, eps=eps, rho=2.0, noise=0.05, backend="pallas", device=dev)
        else:
            spec = GPSpec.create_rff(eps, 0.05, num_features=nr, seed=0, backend="pallas",
                                     device=dev)
        tile = get_expansion(spec.expansion).tile_args(spec, fagp._idx_tensor(spec))
        X = (torch.rand(N, 4, generator=gen) * 2 - 1).to(dev)
        out = torch.empty(N, tile.M, device=dev)
        want = ops.expansion_phi(X, tile)
        nbytes = 4 * (X.numel() + N * tile.M) + sum(
            t.numel() * t.element_size() for t in tile.tensors())
        row = dict(shape=label, N=N, M=tile.M,
                   call_ms=cuda_ms(lambda: ops.expansion_phi(X, tile), reps=50, warmup=5),
                   plain_ms=cuda_ms(lambda: kphi.phi_features_plain(X, tile), reps=10),
                   bound_ms=nbytes / PEAK_BYTES * 1e3,
                   fill_ms=graph_ms(lambda: out.fill_(0.0), reps))
        for name, fn in entries.items():
            launch(fn, X, tile, out)
            torch.cuda.synchronize()
            same = bool(torch.equal(out, want))
            if not same and name not in ("ft_stores_only", "ft_stores_constant"):
                print(f"{name} at {label}: not bitwise the kernel's output", file=sys.stderr)
                ok = False
            rows[name].append(dict(
                row, kernel_ms=graph_ms(lambda: launch(fn, X, tile, out), reps), bitwise_equal=same,
                sha256=hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]))
        if label in ("128x14641", "256x625"):
            pieces = {
                "expansion_phi": lambda: ops.expansion_phi(X, tile),
                "launch": lambda: kphi._launch(X, tile, out),
                "current_stream": lambda: kphi._current_stream(X.get_device()),
                "checks": lambda: (ops._check_tile("x", tile, 4),
                                   ops._on_cuda("x", X, *tile.tensors())),
                "torch_empty": lambda: torch.empty((N, tile.M), device=dev),
            }
            host[label] = {}
            for what, fn in pieces.items():
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(2000):
                    fn()
                host[label][what + "_us"] = (time.perf_counter() - t0) / 2000 * 1e6
                torch.cuda.synchronize()
        del X, out, want
        torch.cuda.empty_cache()
    for name, r in rows.items():
        print(json.dumps({"features": name, "card": card, "reps": reps, "shapes": r}))
    print(json.dumps({"features host": host, "card": card}))
    return ok


if __name__ == "__main__":
    sys.exit(main())
