"""Serving launcher of the LM half: batched prefill + greedy decode loop
(the port of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \\
      --batch 4 --prompt-len 64 --gen 32 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b --full

Runs on the card unless ``--device cpu``; weights are random, drawn from
``--seed``.  Times are on the card's clock: ``torch.cuda.synchronize()``
closes each timed region (the reference's ``block_until_ready``).  The
cache is written in place by every decode step.  Every family is
ported: dense, MoE (olmoe-1b-7b), MLA (deepseek-v3: its latent cache, the
absorbed form at every step), SSM (mamba2-130m: an O(1) state cache, conv
windows and SSD states), hybrid (zamba2-7b: those states and the shared
attention block's K/V, one a group), VLM (llama-3.2-vision-11b: the self
blocks' K/V and the cross blocks' image K/V, written once by the prefill)
and audio (whisper-small: the decoder's self K/V and the encoder output's
cross K/V, written once by the prefill).  The audio family's stub frontend
output ``frames`` (B, enc_len, d) and the VLM's image embeddings ``img``
(B, n_img_tokens, d) are drawn in bfloat16 from the same generator as the
prompt, after it, as the reference draws them.  An SSM or hybrid prompt
needs at least ``ssm_conv - 1`` tokens.
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

__all__ = ["serve", "generate", "extra_input", "draw_extras"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def generate(model, params, tokens: torch.Tensor, gen: int, extras=None) -> dict:
    """Prefill ``tokens`` (B, S) (with ``extras``, the audio family's
    ``frames`` or the VLM's ``img``, in the prefill's batch), then ``gen``
    greedy decode steps: the first generated token is the prefill's argmax,
    each next one the argmax of the step fed the previous one.  Returns the
    reference's keys (``generated`` (B, gen) numpy, ``prefill_s``,
    ``decode_s_per_token``, ``tokens_per_s``); the inputs are on the
    device before ``prefill_s``'s clock starts, as in the reference."""
    dev = params.device
    batch, prompt_len = tokens.shape
    prefill = make_prefill_step(model, cache_len=prompt_len + gen)
    decode = make_decode_step(model)

    batch_in = {"tokens": tokens.to(dev)}
    batch_in.update({k: v.to(dev) for k, v in (extras or {}).items()})
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch_in)
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
    at ``seed``, as the reference draws it; then the audio family's frames
    or the VLM's image embeddings from the same generator, in bfloat16)
    through :func:`generate`.  ``greedy`` is the reference's flag: only
    greedy decoding exists."""
    dev = resolve_device(device)
    cfg = ARCHS[arch_id].SMOKE if smoke else ARCHS[arch_id].CONFIG
    model = get_model(cfg)
    params = model.init_params(seed, device=dev)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(batch, prompt_len)))
    return generate(model, params, tokens.to(dev), gen, extras=draw_extras(cfg, batch, rng))


def extra_input(cfg, batch: int):
    """(key, shape) of the input a batch carries beside its tokens: the
    audio family's ``frames`` (batch, enc_len, d), the VLM's ``img``
    (batch, n_img_tokens, d); None for the other families."""
    if cfg.family == "audio":
        return "frames", (batch, cfg.enc_len, cfg.d_model)
    if cfg.family == "vlm":
        return "img", (batch, cfg.n_img_tokens, cfg.d_model)
    return None


def draw_extras(cfg, batch: int, rng: np.random.Generator) -> dict:
    """The :func:`extra_input`, standard normal from ``rng``, bfloat16 on
    the host, as the reference's serve draws it; {} for the families
    without one."""
    spec = extra_input(cfg, batch)
    if spec is None:
        return {}
    return {spec[0]: torch.from_numpy(rng.standard_normal(spec[1])).to(torch.bfloat16)}


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
