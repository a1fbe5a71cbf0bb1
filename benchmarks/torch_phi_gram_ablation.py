"""Where the two Gram kernels' time goes on the card.

    python3 benchmarks/torch_phi_gram_ablation.py    # from the repository root, one NVIDIA card

Builds ``src/repro_torch/kernels/csrc/phi_gram.cu`` (the fused fit) and
``scaled_gram.cu`` (the Gram of a stored Phi) as they are and variants of
them, each the source with statements replaced (compiled by ``nvcc`` with
the port's own flags into ``build/phi_gram_ablation/``), and times them on
the same inputs at the paper-scale shapes of ``chip_smoke.py``: the
one-model fused fit (N = 10^4, p = 4, n = 11, M = 14,641), its RFF path
(R = 4,096, M = 8,192), the fleet's bank kernel (512 slots, n = 5,
M = 625) and the scaled Gram of the stored Phi (10^4 x 14,641 float32).
The variants:

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
``lanes_16x16`` computes the same bits, which is checked.  Prints one
JSON line per shape with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
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


def build(out_dir: Path) -> dict:
    """One shared library per variant, compiled in parallel."""
    from repro_torch.kernels import _build

    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise SystemExit("nvcc not found")
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (source, edits) in VARIANTS.items():
        text = (_build.CSRC / f"{source}.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: {source}.cu no longer contains {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    return libs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_phi_gram_ablation: needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.core import fagp
    from repro_torch.core.expansions import get_expansion
    from repro_torch.core.gp import GPSpec
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.hermite_phi import KINDS

    dev = torch.device("cuda")
    libs = build(ROOT / "build" / "phi_gram_ablation")
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

    def cuda_ms(fn, reps=5, warmup=1):
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

    def scaled(lib, tile_sq_sig2):
        tile, d, sig2 = tile_sq_sig2
        out = torch.empty(tile.M, tile.M, device=dev)
        fn = lib.repro_scaled_gram_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [P, ctypes.c_int, ctypes.c_int, P, ctypes.c_float, P, P]
        rc = fn(_build.ptr(Phi), N, tile.M, _build.ptr(d), sig2, _build.ptr(out), stream)
        _build.check_launch(rc, "scaled_gram (ablation)")
        return (out,)

    fused = {n: lib for n, lib in libs.items() if VARIANTS[n][0] == "phi_gram"}
    sgram = {n: lib for n, lib in libs.items() if VARIANTS[n][0] == "scaled_gram"}
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
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
