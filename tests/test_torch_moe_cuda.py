"""The port's MoE FFN on the card (``repro_torch.models.moe``), against
itself and against its CPU run; no JAX here.  Skips without a card.

* Two runs of ``moe_apply`` and its backward pass at olmoe's width are
  bitwise equal: the combine and the gather's backward pass sum in a
  fixed order, and every other scatter writes distinct positions.
* The card's float32 result (TF32 off, the default) against the CPU's at
  the reference's MoE gate (rtol = atol = 2e-5,
  tests/test_distributed.py:195-196), on the tokens whose experts and
  kept slots agree; a token whose top-k differs must sit at a near-tie
  (the CPU's float64 probabilities of the two picks within 1e-6).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

MOE_TOL = dict(rtol=2e-5, atol=2e-5)
FLIP_MARGIN = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_moe_apply_bitwise_repeatable(cuda_device, dtype):
    """olmoe's width (d 2,048, 64 experts top-8, capacity factor 1.25),
    1,024 tokens: y, aux and every gradient bitwise equal across two
    runs."""
    cfg = ARCHS["olmoe-1b-7b"].CONFIG
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = tmoe.moe_init(gen, cfg, dtype)
    x = torch.randn((1024, cfg.d_model), generator=gen, device=cuda_device).to(dtype)
    outs = []
    for _ in range(2):
        pp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xx = x.clone().requires_grad_(True)
        y, aux = tmoe.moe_apply(pp, xx, cfg)
        outs.append((y, aux) + torch.autograd.grad(y.float().sum() + aux,
                                                   [xx] + list(pp.values())))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _kept(topi, topv, T, cfg):
    C = tmoe.capacity(T, cfg)
    _, _, slot_of = tmoe._dispatch_tables(topi.cpu(), topv.cpu(), T, cfg.top_k, C, 0,
                                          cfg.n_experts, torch.float32)
    return (slot_of < cfg.n_experts * C).numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [{}, {"capacity_factor": 1.0}, {"n_shared_experts": 1}])
def test_cuda_moe_apply_matches_the_cpu(cuda_device, case):
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(ARCHS["olmoe-1b-7b"].SMOKE, **case)
    p = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((256, cfg.d_model))
                         .astype(np.float32))
    pc = {k: v.to(cuda_device) for k, v in p.items()}
    xc = x.to(cuda_device)
    cy, caux = tmoe.moe_apply(p, x, cfg)
    gy, gaux = tmoe.moe_apply(pc, xc, cfg)
    cv, ci, _ = tmoe._route(p, x, cfg)
    gv, gi, _ = tmoe._route(pc, xc, cfg)
    probs = torch.softmax(x.double() @ p["router"].double(), dim=-1).numpy()
    ci, gi = ci.numpy(), gi.cpu().numpy()
    flips = np.any(ci != gi, axis=1)
    for t in np.nonzero(flips)[0]:
        assert np.abs(probs[t, ci[t]] - probs[t, gi[t]]).max() <= FLIP_MARGIN, t
    T = x.shape[0]
    same = ~flips & np.all(_kept(torch.from_numpy(ci), cv, T, cfg)
                           == _kept(torch.from_numpy(gi), gv, T, cfg), axis=1)
    np.testing.assert_allclose(gy.cpu().numpy()[same], cy.numpy()[same], **MOE_TOL)
    np.testing.assert_allclose(float(gaux), float(caux), **MOE_TOL)
