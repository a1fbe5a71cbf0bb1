"""The port's mamba2 / SSD blocks (``repro_torch.models.ssm``) against the
JAX package's (``repro.models.ssm``) on the same numpy inputs and weights:
``_segsum``; ``ssd_chunked`` at chunks 8-64, at a length that needs
padding, from an initial state and with two heads a group; the port's
``ssd_chunked`` against the naive per-step recurrence in float64 and
against itself at one chunk; ``_causal_depthwise_conv``; ``mamba_init``'s
leaves; ``mamba_apply`` (and its final state) on mamba2-130m's and
zamba2's SMOKE widths and with two groups; ``mamba_prefill``'s conv
windows and state (the reference's ``lm._ssm_prefill_cache``);
``mamba_decode`` step by step against the JAX package's and against
``mamba_apply``'s outputs and final state.  The conv biases, ``D`` and
``norm_w`` are seeded random values (zeros and ones would hide a fault).

Gates: float32 at ``tests/test_layers.py:96-141``'s rtol 2e-3 / atol 2e-4
(the naive recurrence's gate, here in float64 too); bfloat16 within twice
the JAX package's own bfloat16-vs-float32 distance on the same values.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_lm_common import f32, smoke  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-4)          # tests/test_layers.py:110-111, 139-140
F32_LEAVES = ("A_log", "D", "dt_bias", "norm_w")
PERTURB = {"conv_x_b": "bias", "conv_BC_b": "bias", "D": "norm", "norm_w": "norm"}


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _tdt(dtype):
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def _ssd_inputs(b, l, h, p, g, n, seed, dtype=np.float32):
    """x, dt, A, B, C, initial state as tests/test_layers.py draws them."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, h, p)).astype(dtype),
            rng.uniform(0.001, 0.1, (b, l, h)).astype(dtype),
            -rng.uniform(0.1, 2.0, (h,)).astype(dtype),
            rng.standard_normal((b, l, g, n)).astype(dtype),
            rng.standard_normal((b, l, g, n)).astype(dtype),
            (0.5 * rng.standard_normal((b, h, p, n))).astype(dtype))


def _close(got, want, what=""):
    np.testing.assert_allclose(f32(got), f32(want), err_msg=what, **TOL)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------


def test_segsum_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 16)).astype(np.float32)
    got = tssm._segsum(torch.from_numpy(x))
    want = np.asarray(jssm._segsum(jnp.asarray(x)))
    assert np.array_equal(np.isneginf(f32(got)), np.isneginf(want))
    np.testing.assert_allclose(np.where(np.isneginf(want), 0, f32(got)),
                               np.where(np.isneginf(want), 0, want), rtol=1e-6, atol=1e-6)


# (b, l, h, p, g, n, with an initial state): the JAX test's shape, a length
# that needs padding at every chunk but 8, an initial state, and 2 heads a
# group
SSD_CASES = {"plain": (2, 64, 4, 8, 1, 16, False), "padded": (2, 50, 4, 8, 1, 16, False),
             "init_state": (2, 64, 4, 8, 1, 16, True), "two_groups": (2, 40, 4, 8, 2, 16, False)}


@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_chunked_matches_jax(case, chunk):
    b, l, h, p, g, n, with_state = SSD_CASES[case]
    x, dt, A, B, C, s0 = _ssd_inputs(b, l, h, p, g, n, seed=chunk)
    s0 = s0 if with_state else None
    y, s = tssm.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, B, C)), chunk,
                            init_state=None if s0 is None else torch.from_numpy(s0))
    jy, js = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C)), chunk,
                              init_state=None if s0 is None else jnp.asarray(s0))
    assert tuple(y.shape) == (b, l, h, p) and tuple(s.shape) == (b, h, p, n)
    _close(y, jy, "y")
    _close(s, js, "final state")


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_chunk_size_invariance(chunk):
    """tests/test_layers.py:97-111 in the port: the output does not depend
    on the chunk decomposition (one chunk of the whole length is the
    reference)."""
    x, dt, A, B, C, _ = _ssd_inputs(2, 64, 4, 8, 1, 16, seed=3)
    args = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    y1, s1 = tssm.ssd_chunked(*args, chunk)
    y2, s2 = tssm.ssd_chunked(*args, 64)
    _close(y1, y2)
    _close(s1, s2)


def _naive(x, dt, A, B, C, s0):
    """The per-step recurrence of tests/test_layers.py:113-141, in x's
    dtype."""
    b, l, h, p = x.shape
    g = B.shape[2]
    y = np.zeros_like(x)
    state = s0.copy()
    for t in range(l):
        dA = np.exp(dt[:, t] * A[None, :])
        Bh = np.repeat(B[:, t], h // g, axis=1)
        Ch = np.repeat(C[:, t], h // g, axis=1)
        state = state * dA[..., None, None] + np.einsum(
            "bhp,bhn->bhpn", x[:, t] * dt[:, t][..., None], Bh)
        y[:, t] = np.einsum("bhpn,bhn->bhp", state, Ch)
    return y, state


@pytest.mark.parametrize("case", ["test_layers", "padded_two_groups_init_state"])
def test_ssd_matches_naive_recurrence_float64(case):
    """The port's chunked SSD against the direct per-step recurrence, both
    in float64: the JAX test's case (l 32, chunk 8) and one with padding,
    two heads a group and an initial state."""
    if case == "test_layers":
        b, l, h, p, g, n, chunk, seed = 1, 32, 2, 4, 1, 8, 8, 7
    else:
        b, l, h, p, g, n, chunk, seed = 2, 45, 4, 4, 2, 8, 16, 11
    x, dt, A, B, C, s0 = _ssd_inputs(b, l, h, p, g, n, seed, dtype=np.float64)
    if case == "test_layers":
        s0 = np.zeros_like(s0)
    y, s = tssm.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, B, C)), chunk,
                            init_state=torch.from_numpy(s0))
    assert y.dtype == torch.float64
    want_y, want_s = _naive(x, dt, A, B, C, s0)
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    np.testing.assert_allclose(s.numpy(), want_s, **TOL)


@pytest.mark.parametrize("K", [2, 4])
def test_causal_depthwise_conv_matches_jax(K):
    rng = np.random.default_rng(K)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((K, 12)).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    got = tssm._causal_depthwise_conv(*(torch.from_numpy(a) for a in (x, w, bias)))
    want = jssm._causal_depthwise_conv(*(jnp.asarray(a) for a in (x, w, bias)))
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    # causal: row t sees rows t - K + 1 .. t only
    x2 = x.copy()
    x2[:, 5:] += 1.0
    got2 = tssm._causal_depthwise_conv(*(torch.from_numpy(a) for a in (x2, w, bias)))
    assert torch.equal(got2[:, :5], got[:, :5])


# ---------------------------------------------------------------------------
# the mamba2 block
# ---------------------------------------------------------------------------


def _cfg(which, dtype):
    """(jcfg, tcfg): mamba2-130m's or zamba2's SMOKE widths, or mamba2's
    with two groups (8 heads, 4 a group)."""
    if which == "two_groups":
        jcfg, tcfg = smoke("mamba2-130m", dtype)
        return (dataclasses.replace(jcfg, ssm_ngroups=2),
                dataclasses.replace(tcfg, ssm_ngroups=2))
    return smoke({"mamba2": "mamba2-130m", "zamba2": "zamba2-7b"}[which], dtype)


def _setup(which, dtype, seed=0):
    """(jcfg, tcfg, JAX params, port params, numpy tree): the JAX
    package's ``mamba_init`` at ``seed`` with the conv biases, ``D`` and
    ``norm_w`` perturbed, in the reference's dtypes in both packages."""
    jcfg, tcfg = _cfg(which, dtype)
    jp = jssm.mamba_init(jax.random.key(seed), jcfg, jnp.float32)
    rng = np.random.default_rng(100 + seed)

    def value(k, v):
        v = np.asarray(v, np.float32)
        if PERTURB.get(k) == "bias":
            return (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        if PERTURB.get(k) == "norm":
            return (1.0 + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
        return v

    tree = {k: value(k, v) for k, v in jp.items()}
    jp = {k: jnp.asarray(v, jnp.float32 if k in F32_LEAVES else _jdt(dtype))
          for k, v in tree.items()}
    tp = {k: torch.from_numpy(v.copy()).to(torch.float32 if k in F32_LEAVES else _tdt(dtype))
          for k, v in tree.items()}
    return jcfg, tcfg, jp, tp, tree


def _u(jcfg, l, seed=1, b=2):
    return np.random.default_rng(seed).standard_normal((b, l, jcfg.d_model)).astype(np.float32)


def _gate(got, want, want32, dtype, what=""):
    """float32: TOL; bfloat16: within twice the reference's own
    bfloat16-vs-float32 distance."""
    if dtype == "float32":
        _close(got, want, what)
        return
    bound = 2.0 * float(np.abs(f32(want) - f32(want32)).max())
    err = float(np.abs(f32(got) - f32(want)).max())
    assert 0.0 < bound and err <= bound, (what, err, bound)


def test_mamba_init_matches_reference_leaves():
    """Leaf names, shapes and dtypes (A_log, D, dt_bias and norm_w
    float32), the deterministic leaves equal to the reference's
    (``dt_bias`` drawn by the same numpy generator; ``A_log`` the correctly
    rounded log, within 1 ulp of the reference's), the random ones at its
    spread, repeatable from a seed."""
    jcfg, tcfg = smoke("zamba2-7b")
    jp = jssm.mamba_init(jax.random.key(0), jcfg, jnp.bfloat16)
    tp = tssm.mamba_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.items()} == {
        k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in tp.items()}
    for k in ("D", "dt_bias", "norm_w", "conv_x_b", "conv_BC_b"):
        np.testing.assert_array_equal(f32(tp[k]), f32(jp[k]), err_msg=k)
    # A_log = log(1..h): the port's is the correctly rounded float32 log;
    # XLA's float32 log is 1 ulp off it at some entries on some hosts
    h = tcfg.ssm_heads
    np.testing.assert_array_equal(
        f32(tp["A_log"]), np.log(np.arange(1, h + 1, dtype=np.float64)).astype(np.float32))
    np.testing.assert_array_max_ulp(f32(tp["A_log"]), f32(jp["A_log"]), maxulp=1)
    for k in ("in_z", "in_x", "in_BC", "in_dt", "conv_x_w", "conv_BC_w", "out_proj"):
        want = float(np.asarray(jp[k], np.float32).std())
        assert abs(float(tp[k].float().std()) - want) < 0.15 * want, k
    again = tssm.mamba_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    assert all(torch.equal(tp[k], again[k]) for k in tp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["mamba2", "zamba2", "two_groups"])
def test_mamba_apply_matches_jax(which, dtype):
    """The block's output and SSD's final state, at a length that needs
    padding (40 = 2 chunks of 16 + 8)."""
    jcfg, tcfg, jp, tp, _ = _setup(which, dtype)
    u = _u(jcfg, 40)
    got, gs = tssm.mamba_apply(tp, torch.from_numpy(u).to(_tdt(dtype)), tcfg,
                               return_state=True)
    want, ws = jssm.mamba_apply(jp, jnp.asarray(u, _jdt(dtype)), jcfg, return_state=True)
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    want32, ws32 = jssm.mamba_apply({k: jnp.asarray(v, jnp.float32) for k, v in jp.items()},
                                    jnp.asarray(u), jcfg32, return_state=True)
    assert got.shape == want.shape and got.dtype == _tdt(dtype) and gs.dtype == _tdt(dtype)
    _gate(got, want, want32, dtype, "out")
    _gate(gs, ws, ws32, dtype, "final state")


def test_mamba_apply_from_an_initial_state_matches_jax():
    jcfg, tcfg, jp, tp, _ = _setup("mamba2", "float32")
    u = _u(jcfg, 24)
    s0 = 0.3 * np.random.default_rng(5).standard_normal(
        (2, tcfg.ssm_heads, tcfg.ssm_headdim, tcfg.ssm_state)).astype(np.float32)
    got, gs = tssm.mamba_apply(tp, torch.from_numpy(u), tcfg, return_state=True,
                               init_state=torch.from_numpy(s0))
    want, ws = jssm.mamba_apply(jp, jnp.asarray(u), jcfg, return_state=True,
                                init_state=jnp.asarray(s0))
    _close(got, want)
    _close(gs, ws)


def _jax_prefill_cache(jp, u, jcfg):
    """The reference's ``lm._ssm_prefill_cache.mamba_with_state`` less the
    residual: the raw projections' last K - 1 rows and SSD's final state."""
    Kc = jcfg.ssm_conv - 1
    out, state = jssm.mamba_apply(jp, u, jcfg, return_state=True)
    return out, (u @ jp["in_x"])[:, -Kc:], (u @ jp["in_BC"])[:, -Kc:], state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_prefill_states_match_jax(dtype):
    """``mamba_prefill``: the output, the conv windows (the *raw*
    projections, before the conv and the SiLU) and the state; a prompt
    shorter than the window raises."""
    jcfg, tcfg, jp, tp, _ = _setup("zamba2", dtype)
    u = _u(jcfg, 21)
    got = tssm.mamba_prefill(tp, torch.from_numpy(u).to(_tdt(dtype)), tcfg)
    want = _jax_prefill_cache(jp, jnp.asarray(u, _jdt(dtype)), jcfg)
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    want32 = _jax_prefill_cache({k: jnp.asarray(v, jnp.float32) for k, v in jp.items()},
                                jnp.asarray(u), jcfg32)
    assert tuple(got[1].shape) == (2, tcfg.ssm_conv - 1, tcfg.d_inner)
    assert tuple(got[2].shape) == (2, tcfg.ssm_conv - 1, 2 * tcfg.ssm_ngroups * tcfg.ssm_state)
    for name, g, w, w32 in zip(("out", "conv_x", "conv_BC", "ssm"), got, want, want32):
        assert g.dtype == _tdt(dtype), name
        _gate(g, w, w32, dtype, name)
    with pytest.raises(ValueError, match="shorter than the conv window"):
        tssm.mamba_prefill(tp, torch.from_numpy(u[:, :tcfg.ssm_conv - 2]).to(_tdt(dtype)),
                           tcfg)


def _decode_run(mod, p, u, cfg, states, to):
    """``mod.mamba_decode`` over u's tokens one at a time from ``states``:
    (the outputs stacked (b, l, d), the final states)."""
    outs = []
    for t in range(u.shape[1]):
        y, *states = mod.mamba_decode(p, to(u[:, t:t + 1]), cfg, *states)
        outs.append(y)
    return outs, states


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["mamba2", "zamba2", "two_groups"])
def test_mamba_decode_matches_jax(which, dtype):
    """Step by step from a prefill's states: each step's output and the
    three states after the last, the port writing them in place."""
    jcfg, tcfg, jp, tp, _ = _setup(which, dtype)
    u = _u(jcfg, 12, seed=2)
    P = 7
    tdt, jdt = _tdt(dtype), _jdt(dtype)
    _, *ts = tssm.mamba_prefill(tp, torch.from_numpy(u[:, :P]).to(tdt), tcfg)
    ts = [t.clone() for t in ts]
    held = list(ts)
    touts, tstates = _decode_run(tssm, tp, u[:, P:], tcfg, ts,
                                 lambda a: torch.from_numpy(a).to(tdt))
    assert all(a is b for a, b in zip(tstates, held))          # in place

    def jrun(p, cfg, dt_):
        _, *st = _jax_prefill_cache(p, jnp.asarray(u[:, :P], dt_), cfg)
        return _decode_run(jssm, p, u[:, P:], cfg, st, lambda a: jnp.asarray(a, dt_))

    jouts, jstates = jrun(jp, jcfg, jdt)
    jouts32, jstates32 = jrun({k: jnp.asarray(v, jnp.float32) for k, v in jp.items()},
                              dataclasses.replace(jcfg, dtype="float32"), jnp.float32)
    for t, (g, w, w32) in enumerate(zip(touts, jouts, jouts32)):
        assert g.dtype == tdt
        _gate(g, w, w32, dtype, f"step {t}")
    for name, g, w, w32 in zip(("conv_x", "conv_BC", "ssm"), tstates, jstates, jstates32):
        _gate(g, w, w32, dtype, name)


@pytest.mark.parametrize("which", ["mamba2", "two_groups"])
def test_mamba_decode_steps_match_mamba_apply(which):
    """Decoding a sequence one token at a time from zero states gives
    ``mamba_apply``'s outputs and its final SSM state, and the conv
    windows hold the last K - 1 raw projections (float32)."""
    _, tcfg, _, tp, _ = _setup(which, "float32")
    u = torch.from_numpy(_u(tcfg, 19, seed=4))
    want, ws = tssm.mamba_apply(tp, u, tcfg, return_state=True)
    Kc, gn2 = tcfg.ssm_conv - 1, 2 * tcfg.ssm_ngroups * tcfg.ssm_state
    states = [torch.zeros(2, Kc, tcfg.d_inner), torch.zeros(2, Kc, gn2),
              torch.zeros(2, tcfg.ssm_heads, tcfg.ssm_headdim, tcfg.ssm_state)]
    outs, states = _decode_run(tssm, tp, u.numpy(), tcfg, states, torch.from_numpy)
    _close(torch.cat(outs, dim=1), want, "outputs")
    _close(states[2], ws, "final state")
    _, cx, cb, _ = tssm.mamba_prefill(tp, u, tcfg)
    _close(states[0], cx, "conv_x window")
    _close(states[1], cb, "conv_BC window")
