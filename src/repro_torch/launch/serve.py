"""Serving launcher of the LM half: batched prefill + greedy decode loop
(the port of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \\
      --batch 4 --prompt-len 64 --gen 32 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b --full

Runs on the card unless ``--device cpu``; weights are random, drawn from
``--seed``.  Times are on the card's clock: ``torch.cuda.synchronize()``
closes each timed region (the reference's ``block_until_ready``).  The
cache is written in place by every decode step.  The dense family, the
MoE family (olmoe-1b-7b), the MLA family (deepseek-v3: its latent cache,
the absorbed form at every step), the SSM family (mamba2-130m: an O(1)
state cache, conv windows and SSD states) and the hybrid family
(zamba2-7b: those states and the shared attention block's K/V, one a
group) are ported (``repro_torch.models.get_model`` refuses the audio and
VLM families, ROADMAP A8).  An SSM or hybrid prompt needs at least
``ssm_conv - 1`` tokens.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS
from ..device import resolve_device
from ..models import get_model
from .steps import make_decode_step, make_prefill_step

__all__ = ["serve", "generate"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def generate(model, params, tokens: torch.Tensor, gen: int) -> dict:
    """Prefill ``tokens`` (B, S), then ``gen`` greedy decode steps: the
    first generated token is the prefill's argmax, each next one the
    argmax of the step fed the previous one.  Returns the reference's keys
    (``generated`` (B, gen) numpy, ``prefill_s``, ``decode_s_per_token``,
    ``tokens_per_s``)."""
    dev = params.device
    batch, prompt_len = tokens.shape
    prefill = make_prefill_step(model, cache_len=prompt_len + gen)
    decode = make_decode_step(model)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens.to(dev)})
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out_tokens = []
    tok = torch.argmax(logits, dim=-1)[:, None]
    t0 = time.perf_counter()
    for i in range(gen):
        out_tokens.append(tok)
        logits, cache = decode(params, {"token": tok, "pos": prompt_len + i}, cache)
        tok = torch.argmax(logits, dim=-1)[:, None]
    _sync(dev)
    t_decode = time.perf_counter() - t0

    return {
        "generated": torch.cat(out_tokens, dim=1).cpu().numpy(),
        "prefill_s": t_prefill,
        "decode_s_per_token": t_decode / gen,
        "tokens_per_s": batch * gen / t_decode,
    }


def serve(arch_id: str, *, smoke: bool, batch: int, prompt_len: int, gen: int,
          seed: int = 0, greedy: bool = True, device=None) -> dict:
    """Random weights from ``seed`` and a random prompt (numpy's generator
    at ``seed``, as the reference draws it) through :func:`generate`.
    ``greedy`` is the reference's flag: only greedy decoding exists."""
    dev = resolve_device(device)
    cfg = ARCHS[arch_id].SMOKE if smoke else ARCHS[arch_id].CONFIG
    model = get_model(cfg)
    params = model.init_params(seed, device=dev)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(batch, prompt_len)))
    return generate(model, params, tokens.to(dev), gen)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    r = serve(args.arch, smoke=args.smoke, batch=args.batch,
              prompt_len=args.prompt_len, gen=args.gen, seed=args.seed, device=args.device)
    print(f"prefill {r['prefill_s']*1e3:.1f} ms; "
          f"decode {r['decode_s_per_token']*1e3:.2f} ms/tok; "
          f"{r['tokens_per_s']:.1f} tok/s; sample row: {r['generated'][0][:16]}")
    return r


if __name__ == "__main__":
    main()
