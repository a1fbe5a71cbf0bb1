#!/usr/bin/env python3
"""Where an LM train step's time goes on the card.

    python3 benchmarks/torch_lm_train_profile.py     # from the repository root; one card

Builds qwen2-1.5b at full width through ``repro_torch.launch.train.build``
(random weights from seed 0, batch 4 x 1,024 tokens, the schedule the
launcher builds), takes 3 warm-up steps, then:

1. the step's parts, each on the host clock closed by
   ``torch.cuda.synchronize()`` and with CUDA events: the batch
   (``TokenStream``), the forward pass and loss (``loss_fn`` with
   gradients on), the backward pass (``torch.autograd.grad``: the blocks'
   and the loss chunk's recomputation included) and the AdamW update
   (``optim.apply_updates_``), over 5 steps, medians;
2. one ``torch.profiler`` window over 2 whole steps (``make_train_step``):
   the device's busy time a step (the sum of the kernels' device time),
   the wall time a step and the idle share, the launches a step, and the
   kernels that take the most device time.

Prints a JSON line ``[train profile] {...}`` and the card's name and power
limit.  Exits non-zero without a card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH, BATCH, SEQ, WARM, TIMED, PROFILED = "qwen2-1.5b", 4, 1024, 3, 5, 2


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_lm_train_profile: needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch import optim
    from repro_torch.launch import train as ttrain
    from repro_torch.models import lm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg, model, params, opt, step_fn, stream, extras, _ = ttrain.build(
        ARCH, smoke=False, batch=BATCH, seq=SEQ, lr=3e-4, device=dev)
    ocfg = optim.AdamWConfig(lr=optim.warmup_cosine(3e-4, 20, 10_000))
    for s in range(WARM):
        step_fn(params, opt, stream.batch(s, extras, device=dev))
    torch.cuda.synchronize()

    parts = {k: [] for k in ("batch", "forward", "backward", "adamw")}
    dev_parts = {k: [] for k in ("forward", "backward", "adamw")}
    for s in range(WARM, WARM + TIMED):
        t0 = time.perf_counter()
        batch = stream.batch(s, extras, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        named = lm.leaves(params)
        ev[0].record()
        with lm.trainable(params):
            loss, _ = model.loss_fn(params, batch)
            ev[1].record()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            grads = torch.autograd.grad(loss, list(named.values()))
        ev[2].record()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        optim.apply_updates_(named, dict(zip(named, grads)), opt, ocfg,
                             ndims=lm.ref_ndims(params))
        ev[3].record()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        del grads, loss
        for k, a, b in (("batch", t0, t1), ("forward", t1, t2), ("backward", t2, t3),
                        ("adamw", t3, t4)):
            parts[k].append((b - a) * 1e3)
        for k, i in (("forward", 0), ("backward", 1), ("adamw", 2)):
            dev_parts[k].append(ev[i].elapsed_time(ev[i + 1]))

    from torch.profiler import ProfilerActivity, profile

    s0 = WARM + TIMED
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(s0, s0 + PROFILED):
            _, _, m = step_fn(params, opt, stream.batch(s, extras, device=dev))
            float(m["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / PROFILED
    launches = sum(e.count for e in kernels) / PROFILED
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    report = {
        "card": smi, "arch": ARCH, "batch": BATCH, "seq": SEQ,
        "host_ms": {k: statistics.median(v) for k, v in parts.items()},
        "device_ms": {k: statistics.median(v) for k, v in dev_parts.items()},
        "profiled_step_wall_ms": wall_ms, "profiled_step_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms, "kernels_a_step": launches,
        "top_kernels": [{"name": e.key[:90], "ms_a_step": dev_us(e) / 1e3 / PROFILED,
                         "calls_a_step": e.count / PROFILED} for e in top],
    }
    print(smi)
    print("[train profile] " + json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
