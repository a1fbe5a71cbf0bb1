"""Training launcher of the LM half (the port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \\
      --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]

Runs on the card unless ``--device cpu``; weights are random, drawn from
``--seed``; batches come from the synthetic ``TokenStream``; the schedule
is ``warmup_cosine(lr, 20, 10_000)``.  The train step updates the model
and the AdamW state in place; checkpoints are the reference's tree, so a
run started by either package resumes in the other.  Every family is
ported: dense, MoE (olmoe-1b-7b, its load-balance aux loss added to the
loss), MLA (deepseek-v3, its MTP term in the loss), SSM (mamba2-130m),
hybrid (zamba2-7b: the shared block's gradient summed over its
invocations), VLM (llama-3.2-vision-11b) and audio (whisper-small); the
latter two train on fixed ``extras`` (image embeddings or frames, drawn
once from ``--seed``, bfloat16), merged into every batch.  ``build(mesh=)``
places the parameters and the AdamW state on a mesh
(``parallel.sharding.param_shardings`` / ``opt_state_shardings``); the
step function then runs the sharded step of ``launch/steps.py``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import optim
from ..configs import ARCHS
from ..data import TokenStream
from ..device import resolve_device
from ..models import get_model, lm
from ..parallel import sharding
from ..runtime import TrainLoopConfig, train_loop
from .serve import extra_input
from .steps import make_train_step

__all__ = ["build", "main"]


def build(arch_id: str, *, smoke: bool, batch: int, seq: int, lr: float,
          mesh=None, seed: int = 0, device=None):
    """(cfg, model, params, opt_state, step_fn, stream, extras, shardings)
    as the reference's ``build`` returns them, on ``device`` (default the
    card); ``shardings`` is ``(None, None)``.  With ``mesh`` (a
    ``launch.mesh.Mesh``) the weights are drawn on ``device`` as without
    it, then placed as pieces on the mesh's cells: ``params`` a
    ``parallel.sharding.ShardedParams``, ``opt_state`` a dict of
    ``Sharded`` leaves, ``shardings`` their ``(param_shardings,
    opt_state_shardings)``.  ``extras`` holds the audio
    family's ``frames`` (batch, enc_len, d) or the VLM's ``img`` (batch,
    n_img_tokens, d): standard normal from numpy's generator at ``seed``,
    cast to float32 then bfloat16, as the reference draws them; {} for the
    other families."""
    dev = resolve_device(device)
    mod = ARCHS[arch_id]
    cfg = mod.SMOKE if smoke else mod.CONFIG
    model = get_model(cfg)
    params = model.init_params(seed, device=dev)
    ocfg = optim.AdamWConfig(lr=optim.warmup_cosine(lr, 20, 10_000))
    opt_state = optim.init(lm.leaves(params), ocfg)
    step_fn = make_train_step(model, ocfg)
    stream = TokenStream(vocab=cfg.vocab, seq=seq, global_batch=batch, seed=seed)
    extras = {}
    spec = extra_input(cfg, batch)
    if spec is not None:
        x = np.random.default_rng(seed).standard_normal(spec[1]).astype(np.float32)
        extras[spec[0]] = torch.from_numpy(x).to(dev).to(torch.bfloat16)
    p_sh = o_sh = None
    if mesh is not None:
        p_sh = sharding.param_shardings(params, cfg, mesh)
        o_sh = sharding.opt_state_shardings(opt_state, params, cfg, mesh)
        params = sharding.place(params, p_sh)
        opt_state = sharding.place(opt_state, o_sh)
    return cfg, model, params, opt_state, step_fn, stream, extras, (p_sh, o_sh)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, model, params, opt_state, step_fn, stream, extras, _ = build(
        args.arch, smoke=args.smoke, batch=args.batch, seq=args.seq, lr=args.lr,
        seed=args.seed, device=dev)
    loop_cfg = TrainLoopConfig(
        steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir
    )
    params, opt_state, report = train_loop(
        step_fn, params, opt_state,
        lambda step: stream.batch(step, extras, device=dev),
        loop_cfg,
    )
    h = report["history"]
    print(f"\narch={cfg.arch_id} steps={report['final_step']} "
          f"first_loss={h[0]['loss']:.4f} last_loss={h[-1]['loss']:.4f} "
          f"stragglers={report['stragglers']}")
    return report


if __name__ == "__main__":
    main()
