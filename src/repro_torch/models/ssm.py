"""Mamba2 / SSD (state-space duality) blocks, arXiv:2405.21060: the port of
``repro/models/ssm.py`` as plain functions on tensors.

Chunked block decomposition of the SSD recurrence: a quadratic,
attention-like term inside each chunk (batched products), per-chunk
states, and a sequential inter-chunk recurrence carrying the (b, h, p, n)
state, a loop over chunks here where the reference runs ``lax.scan``.
The full mamba2 block (in_proj -> causal depthwise conv -> SSD -> gated
RMSNorm -> out_proj) and its O(1)-state single-token decode, which writes
the conv windows and the SSM state in place (the reference returns new
ones; its caller donates the cache).

Dtypes are the reference's, operation for operation (its three-operand
einsums taken in the pairs its contraction order takes): ``mamba_apply``
casts dt (softplus in float32) and A = -exp(A_log) to the model dtype
*before* SSD, so in bfloat16 the cumulative sum of dA over a chunk and the
``exp`` of its differences run in bfloat16; ``mamba_decode`` takes
exp(dt A) in float32 and then casts it; the SSM state is kept in the model
dtype; ``A_log``, ``D``, ``dt_bias`` and ``norm_w`` are float32 leaves.

The reference's sequence-parallel pins stand where it has them
(``_ssm_mode`` and ``_act``, under ``cfg.ssm_seq_parallel``); on the port's
single controller a pin returns its argument itself.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import hints
from .layers import dense_init, rmsnorm

__all__ = ["mamba_init", "mamba_apply", "mamba_prefill", "mamba_decode", "ssd_chunked"]


def _segsum(x):
    """x (..., q) -> (..., q, q): S[i, j] = sum_{k=j+1..i} x_k (i >= j), -inf
    else (differences of one cumulative sum, in x's dtype)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~keep, -math.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None):
    """SSD: y_t = C_t^T S_t,  S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_t^T.

    x (b, l, h, p), dt (b, l, h) [post-softplus], A (h,) negative,
    B, C (b, l, g, n) with h % g == 0.  Returns (y (b, l, h, p),
    final_state (b, h, p, n)).  A length that is no multiple of ``chunk``
    is padded with dt = 0 (decay 1, no state update), which is exact."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g

    l_orig = l
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        l = l + pad
    nc = l // chunk

    xc = x.reshape(b, nc, chunk, h, p)                              # (b,c,q,h,p)
    dtc = dt.reshape(b, nc, chunk, h)                               # (b,c,q,h)
    Bc = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)  # (b,c,q,h,n)
    Cc = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    dA = dtc * A                                                    # (b,c,q,h)
    dA_cs = torch.cumsum(dA, dim=2)
    xdt = xc * dtc[..., None]

    # 1) intra-chunk (quadratic within the chunk, like masked attention)
    L = torch.exp(_segsum(dA.movedim(2, 3)))                        # (b,c,h,q,q)
    scores = torch.einsum("bcqhn,bcshn->bchqs", Cc, Bc)             # (b,c,h,q,s)
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", scores * L, xdt)

    # 2) per-chunk outgoing states
    decay_out = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)              # (b,c,q,h)
    states = torch.einsum("bcqhn,bcqhp->bchpn", Bc, decay_out[..., None] * xdt)

    # 3) inter-chunk recurrence: the state before each chunk, then the final
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                     # (b,c,h)
    s = init_state if init_state is not None else x.new_zeros((b, h, p, n))
    before = []
    for c in range(nc):
        before.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    states_prev = torch.stack(before, dim=1)                        # (b,c,h,p,n)

    # 4) inter-chunk contribution
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", Cc, states_prev) * torch.exp(dA_cs)[..., None]
    y = (y_diag + y_off).reshape(b, l, h, p)[:, :l_orig]
    return y, s


# --------------------------------------------------------------------------
# Full mamba2 block
# --------------------------------------------------------------------------


def mamba_init(gen: torch.Generator, cfg, dtype) -> dict:
    """The reference's leaves on the generator's device, its fused in_proj
    and conv split per role (z | x | BC | dt and conv_x | conv_BC): the
    projections N(0, 1) / sqrt(d_in) in ``dtype`` (``out_proj`` scaled
    1/sqrt(d_inner)), the conv weights N(0, 1) / sqrt(K), zero conv
    biases; float32 ``A_log`` = log(1..h), ``D`` = 1, ``dt_bias`` the
    inverse softplus of dt drawn log-uniform in [1e-3, 1e-1] by numpy's
    ``RandomState(0)`` (the reference's own draw, so equal), ``norm_w`` =
    1."""
    d = cfg.d_model
    din, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    g, K = cfg.ssm_ngroups, cfg.ssm_conv
    dev = gen.device
    dt = np.exp(np.random.RandomState(0).uniform(np.log(1e-3), np.log(1e-1), size=(h,)))

    def conv(ch):
        w = torch.randn((K, ch), generator=gen, dtype=torch.float32, device=dev)
        return (w / math.sqrt(K)).to(dtype)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return {
        "in_z": dense_init(gen, d, din, dtype),
        "in_x": dense_init(gen, d, din, dtype),
        "in_BC": dense_init(gen, d, 2 * g * n, dtype),
        "in_dt": dense_init(gen, d, h, dtype),
        "conv_x_w": conv(din),
        "conv_x_b": torch.zeros((din,), dtype=dtype, device=dev),
        "conv_BC_w": conv(2 * g * n),
        "conv_BC_b": torch.zeros((2 * g * n,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32, device=dev)),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": f32(dt + np.log(-np.expm1(-dt))),
        "norm_w": torch.ones((din,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, din, d, dtype, scale=1.0 / math.sqrt(din)),
    }


def _causal_depthwise_conv(xBC, w, b):
    """(b, l, ch) causal depthwise conv, kernel K (an unrolled sum over the
    K taps, each rounded in xBC's dtype as the reference's)."""
    K = w.shape[0]
    out = xBC * w[K - 1]
    for k in range(1, K):
        shifted = F.pad(xBC, (0, 0, k, 0))[:, : xBC.shape[1], :]
        out = out + shifted * w[K - 1 - k]
    return out + b


def _ssm_mode(cfg) -> str:
    """'sp_tp': Megatron-SP (a sequence-sharded residual, a channel- or
    head-sharded interior); 'sp_only': replicated weights, everything
    sequence-sharded (heads do not divide the model axis); 'off': no mesh
    active, or a hybrid outside training (its attention blocks need the
    whole sequence).  'sp_tp' only under ``REPRO_SSM_TP=1``, as in the
    reference."""
    mesh = hints.active_mesh()
    if mesh is None or not cfg.ssm_seq_parallel:
        return "off"
    if cfg.family == "hybrid" and not hints.sp_enabled():
        return "off"
    msize = mesh.shape.get("model", 1)
    if (os.environ.get("REPRO_SSM_TP") == "1"
            and cfg.ssm_heads % msize == 0 and cfg.d_inner % msize == 0):
        return "sp_tp"
    return "sp_only"


def _act(t, cfg, role: str):
    """The mode's sharding pin for (b, l, ch...) activations."""
    mode = _ssm_mode(cfg)
    if mode == "off":
        return t
    tail = (None,) * (t.ndim - 3)
    if mode == "sp_only":
        return hints.constrain(t, ("dp", "model", None) + tail)
    if role == "chan":      # z / x / dt: channel- or head-sharded, whole sequence
        return hints.constrain(t, ("dp", None, "model") + tail)
    if role == "bc":        # B/C: small, every head shard needs all of it
        return hints.constrain(t, ("dp", None, None) + tail)
    if role == "seq":       # the residual exit: back to sequence-sharded
        return hints.constrain(t, ("dp", "model", None) + tail)
    raise ValueError(role)


def _project(p, u, cfg, raw=None):
    """u (b, l, d) -> z (b,l,din), x_conv (b,l,din), BC_conv (b,l,2gn),
    dt_raw (b,l,h); conv+silu applied (the depthwise conv factorizes exactly
    across the x | BC split).  ``raw``, a list, receives the projections
    before the conv (x, then BC)."""
    z = _act(u @ p["in_z"], cfg, "chan")
    x_raw, bc_raw = u @ p["in_x"], u @ p["in_BC"]
    if raw is not None:
        raw += [x_raw, bc_raw]
    xc = _act(F.silu(_causal_depthwise_conv(x_raw, p["conv_x_w"], p["conv_x_b"])), cfg,
              "chan")
    bc = _act(F.silu(_causal_depthwise_conv(bc_raw, p["conv_BC_w"], p["conv_BC_b"])), cfg,
              "bc")
    return z, xc, bc, _act(u @ p["in_dt"], cfg, "chan")


def _split_heads(xc, bc, cfg):
    b, l, _ = xc.shape
    n, h, g = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_ngroups
    x = xc.reshape(b, l, h, cfg.ssm_headdim)
    B = bc[..., : g * n].reshape(b, l, g, n)
    C = bc[..., g * n:].reshape(b, l, g, n)
    return x, B, C


def _mamba(p, u, cfg, init_state=None, raw=None):
    b, l, d = u.shape
    z, xc, bc, dt_raw = _project(p, u, cfg, raw)
    x, B, C = _split_heads(xc, bc, cfg)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])        # (b,l,h)
    A = -torch.exp(p["A_log"])                                       # (h,)
    y, state = ssd_chunked(x, dt.to(u.dtype), A.to(u.dtype), B, C, cfg.ssm_chunk,
                           init_state=init_state)
    y = y + x * p["D"].to(u.dtype)[None, None, :, None]
    y = _act(y.reshape(b, l, cfg.d_inner), cfg, "chan")
    y = rmsnorm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return _act(y @ p["out_proj"], cfg, "seq"), state


def mamba_apply(p, u, cfg, *, return_state: bool = False, init_state=None):
    """Full-sequence mamba2 block. u (b, l, d) -> (b, l, d) (and, with
    ``return_state``, SSD's final state (b, h, p, n))."""
    out, state = _mamba(p, u, cfg, init_state)
    return (out, state) if return_state else out


def mamba_prefill(p, u, cfg):
    """``mamba_apply`` keeping what a decode continues from, as the
    reference's ``lm._ssm_prefill_cache`` rebuilds it: (out, conv_x_state
    (b, K-1, din), conv_BC_state (b, K-1, 2gn), ssm_state (b, h, p, n)),
    the conv states the last K - 1 rows of the *raw* projections (before
    the conv and the SiLU).  Needs l >= K - 1."""
    Kc = cfg.ssm_conv - 1
    if u.shape[1] < Kc:
        raise ValueError(f"a prompt of {u.shape[1]} tokens is shorter than the conv window's "
                         f"{Kc} rows (ssm_conv {cfg.ssm_conv}): no prefill cache for it")
    raw: list = []
    out, state = _mamba(p, u, cfg, raw=raw)
    return out, raw[0][:, -Kc:], raw[1][:, -Kc:], state


def mamba_decode(p, u, cfg, conv_x_state, conv_BC_state, ssm_state):
    """Single-token decode. u (b, 1, d); conv_*_state (b, K-1, ch);
    ssm_state (b, h, p, n).  O(1) in context length.  The three states
    are written in place (each conv window is shifted through a copy of
    the new K-long window, never by an overlapping copy) and returned with
    the output (b, 1, d)."""
    b = u.shape[0]
    din, h, g = cfg.d_inner, cfg.ssm_heads, cfg.ssm_ngroups
    z = u @ p["in_z"]
    dt_raw = u @ p["in_dt"]

    win_x = torch.cat([conv_x_state, u @ p["in_x"]], dim=1)         # (b, K, din)
    xc = F.silu(torch.einsum("bkc,kc->bc", win_x, p["conv_x_w"]) + p["conv_x_b"])
    conv_x_state.copy_(win_x[:, 1:])
    win_bc = torch.cat([conv_BC_state, u @ p["in_BC"]], dim=1)      # (b, K, 2gn)
    bc = F.silu(torch.einsum("bkc,kc->bc", win_bc, p["conv_BC_w"]) + p["conv_BC_b"])
    conv_BC_state.copy_(win_bc[:, 1:])

    x, B, C = _split_heads(xc[:, None, :], bc[:, None, :], cfg)      # l = 1
    x, B, C = x[:, 0], B[:, 0], C[:, 0]                              # (b,h,p), (b,g,n)
    dt = F.softplus(dt_raw[:, 0].to(torch.float32) + p["dt_bias"])   # (b,h)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A[None, :]).to(u.dtype)                      # (b,h)
    rep = h // g
    Bh = B.repeat_interleave(rep, dim=1)                             # (b,h,n)
    Ch = C.repeat_interleave(rep, dim=1)
    xdt = x * dt.to(u.dtype)[..., None]                              # (b,h,p)
    ssm_state.copy_(ssm_state * dA[..., None, None]
                    + torch.einsum("bhp,bhn->bhpn", xdt, Bh))
    y = (torch.einsum("bhpn,bhn->bhp", ssm_state, Ch)
         + x * p["D"].to(u.dtype)[None, :, None])
    y = rmsnorm(y.reshape(b, 1, din) * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], conv_x_state, conv_BC_state, ssm_state
