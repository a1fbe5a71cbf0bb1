"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the same numpy inputs and weights, in
three configurations: olmoe's SMOKE (capacity factor 8, nothing dropped),
the same at capacity factor 1.0 (assignments dropped, as
tests/test_layers.py:153) and with one shared expert (as
tests/test_distributed.py:183-186).

Gates, each stated where it is used:
* ``capacity``, ``_expert_ranks`` and the dispatch tables
  (``token_for_slot``, ``w_for_slot``) on the same ``topi`` / ``topv``:
  bitwise;
* ``_route`` in float32: gates and aux at 1e-6;
* ``_expert_ffn`` and ``moe_apply`` in float32: rtol = atol = 2e-5, the
  reference's own MoE gate (tests/test_distributed.py:195-196);
* gradients of ``moe_apply``'s (y, aux) against ``jax.grad`` at
  tests/test_torch_lm.py's ``F32_TOL`` (rtol 1e-4, atol 1e-5).

Top-k flips.  The two packages sum the router's float32 product in other
orders, so where a token's k-th and (k+1)-th probabilities lie within a
rounding of each other the packages may pick different experts.  Each
test counts the tokens whose selection differs, requires every such flip
to sit at a probability margin of at most ``FLIP_MARGIN``, and holds the
other tokens (those whose experts and kept slots agree) at the gate.  A
flip moves the aux loss's token fractions by 1/T, which no gradient gate
absorbs, so the gradient test requires none (checked, not assumed).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402

F32_TOL = dict(rtol=1e-4, atol=1e-5)       # tests/test_torch_lm.py
MOE_TOL = dict(rtol=2e-5, atol=2e-5)       # tests/test_distributed.py:195-196
FLIP_MARGIN = 1e-6                         # in probability
T_TOKENS = 64

CASES = {
    "smoke": {},                                   # capacity factor 8: no drops
    "drops": {"capacity_factor": 1.0},             # over capacity: drops
    "shared": {"n_shared_experts": 1},             # a shared expert
}


def _cfgs(case):
    jcfg = dataclasses.replace(JARCHS["olmoe-1b-7b"].SMOKE, **CASES[case])
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _setup(case, seed=0, T=T_TOKENS):
    """(jcfg, tcfg, JAX params, port params, x numpy) in float32: the JAX
    package's init at ``seed``, carried across."""
    jcfg, tcfg = _cfgs(case)
    jp = jmoe.moe_init(jax.random.key(seed), jcfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(100 + seed).standard_normal((T, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _flipped(jp, x, jtopi, ttopi):
    """Tokens whose ordered top-k differs between the packages; asserts
    that each sits at a near-tie (the JAX package's probabilities of the
    two picks within FLIP_MARGIN, position by position)."""
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1), np.float64)
    jtopi, ttopi = _np(jtopi), _np(ttopi)
    diff = np.any(jtopi != ttopi, axis=1)
    for t in np.nonzero(diff)[0]:
        margin = np.abs(probs[t, jtopi[t]] - probs[t, ttopi[t]]).max()
        assert margin <= FLIP_MARGIN, (int(t), jtopi[t], ttopi[t], float(margin))
    return diff


def _kept(topi, topv, T, cfg):
    """(T, k) bool: each assignment kept (the port's tables, bitwise the
    reference's, see test_dispatch_tables_bitwise)."""
    C = tmoe.capacity(T, cfg)
    _, _, slot_of = tmoe._dispatch_tables(torch.as_tensor(_np(topi)), torch.as_tensor(_np(topv)),
                                          T, cfg.top_k, C, 0, cfg.n_experts, torch.float32)
    return _np(slot_of) < cfg.n_experts * C


# ---------------------------------------------------------------------------
# capacity, ranks, tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("cf", [None, 1.0, 1.25, 8.0])
def test_capacity_matches_jax(arch, which, cf):
    jcfg = getattr(JARCHS[arch], which)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    for T in (1, 2, 4, 7, 64, 66, 256, 1024, 1028, 4096, 8192):
        assert tmoe.capacity(T, tcfg) == jmoe.capacity(T, jcfg), T


@pytest.mark.parametrize("n,E,seed", [(16, 4, 0), (128, 8, 1), (1000, 64, 2), (8, 64, 3)])
def test_expert_ranks_bitwise(n, E, seed):
    e = np.random.default_rng(seed).integers(0, E, size=n).astype(np.int32)
    want = np.asarray(jmoe._expert_ranks(jnp.asarray(e), n))
    got = tmoe._expert_ranks(torch.from_numpy(e), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("T", [1, 4, T_TOKENS, 200])
def test_dispatch_tables_bitwise(case, T):
    """``token_for_slot`` and ``w_for_slot`` bitwise the reference's on the
    same topi / topv (float32 and bfloat16 gates); ``slot_of`` is their
    inverse: each kept assignment's slot holds its token and its gate, and
    a dropped one points past the last slot."""
    jcfg, tcfg, jp, _, x = _setup(case, T=T)
    topv, topi, _ = jmoe._route(jp, jnp.asarray(x), jcfg)
    C = jmoe.capacity(T, jcfg)
    k, E = jcfg.top_k, jcfg.n_experts
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jtok, jw = jmoe._dispatch_tables(topi, topv, T, k, C, 0, E, jdt)
        tok, w, slot_of = tmoe._dispatch_tables(torch.from_numpy(np.array(topi)),
                                                torch.from_numpy(np.array(topv)),
                                                T, k, C, 0, E, tdt)
        assert tok.dtype == torch.int32 and w.dtype == tdt and slot_of.shape == (T, k)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(w.float().numpy(), np.asarray(jw, np.float32))
        so = slot_of.numpy()
        kept = so < E * C
        rows = np.repeat(np.arange(T), k).reshape(T, k)
        np.testing.assert_array_equal(tok.numpy()[so[kept]], rows[kept])
        gates = torch.from_numpy(np.array(topv)).to(tdt)
        assert torch.equal(w[slot_of[torch.from_numpy(kept)]], gates[torch.from_numpy(kept)])
        assert len(set(so[kept].tolist())) == int(kept.sum())      # one slot each
        # every slot not named by slot_of is a padding slot
        pad = np.ones(E * C, bool)
        pad[so[kept]] = False
        assert np.all(tok.numpy()[pad] == T) and np.all(w.float().numpy()[pad] == 0)
        if case == "drops" and T == T_TOKENS:
            assert not kept.all()
        if case != "drops":
            assert kept.all()


def test_dispatch_tables_of_a_shard_drop_other_experts():
    """[e_lo, e_lo + n_local): the tables of experts 2-5 of 8, ranks over
    all assignments, bitwise the reference's."""
    jcfg, _, jp, _, x = _setup("drops")
    T = T_TOKENS
    topv, topi, _ = jmoe._route(jp, jnp.asarray(x), jcfg)
    C = jmoe.capacity(T, jcfg)
    jtok, jw = jmoe._dispatch_tables(topi, topv, T, jcfg.top_k, C, 2, 4, jnp.float32)
    tok, w, slot_of = tmoe._dispatch_tables(torch.from_numpy(np.array(topi)),
                                            torch.from_numpy(np.array(topv)), T,
                                            jcfg.top_k, C, 2, 4, torch.float32)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    local = (np.asarray(topi) >= 2) & (np.asarray(topi) < 6)
    assert np.all(slot_of.numpy()[~local] == 4 * C)


# ---------------------------------------------------------------------------
# routing, the expert products, moe_apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_route_matches_jax(case, seed):
    jcfg, tcfg, jp, tp, x = _setup(case, seed)
    jv, ji, jaux = jmoe._route(jp, jnp.asarray(x), jcfg)
    tv, ti, taux = tmoe._route(tp, torch.from_numpy(x), tcfg)
    assert tv.dtype == torch.float32 and taux.dtype == torch.float32
    flips = _flipped(jp, x, ji, ti)
    same = ~flips
    np.testing.assert_array_equal(_np(ti)[same], np.asarray(ji)[same])
    np.testing.assert_allclose(_np(tv)[same], np.asarray(jv)[same], rtol=0, atol=1e-6)
    # a flip moves two experts' token fractions by 1/T each
    slack = 2.0 * flips.sum() * tcfg.router_aux_coef * tcfg.n_experts / x.shape[0]
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=slack)
    assert float(taux) > 0


def test_route_keeps_the_lower_index_on_a_tie():
    """Exact ties in the probabilities: ``jax.lax.top_k``'s order (the
    lower index first), which the stable sort keeps."""
    jcfg, tcfg = _cfgs("smoke")
    d, E = jcfg.d_model, jcfg.n_experts
    router = np.zeros((d, E), np.float32)
    router[0] = [0.5, 2.0, 1.0, 2.0, 1.0, 2.0, 0.0, 1.0]   # ties at 1, 3, 5 and 2, 4, 7
    x = np.zeros((3, d), np.float32)
    x[:, 0] = [1.0, -1.0, 0.0]                            # the last row: all tied
    jp = {"router": jnp.asarray(router)}
    _, ji, _ = jmoe._route(jp, jnp.asarray(x), jcfg)
    _, ti, _ = tmoe._route({"router": torch.from_numpy(router)}, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(_np(ti), [[1, 3], [6, 0], [0, 1]])


@pytest.mark.parametrize("case", sorted(CASES))
def test_expert_ffn_matches_jax(case):
    """``_expert_ffn`` on the reference's own tables: float32 at the
    reference's MoE gate."""
    jcfg, tcfg, jp, tp, x = _setup(case)
    T, d = x.shape
    topv, topi, _ = jmoe._route(jp, jnp.asarray(x), jcfg)
    C = jmoe.capacity(T, jcfg)
    args = (T, jcfg.top_k, C, 0, jcfg.n_experts)
    jtok, jw = jmoe._dispatch_tables(topi, topv, *args, jnp.float32)
    want = jmoe._expert_ffn(jnp.asarray(x), jtok, jw, jp["wg"], jp["wu"], jp["wd"], T, d, C)
    tok, w, slot_of = tmoe._dispatch_tables(torch.from_numpy(np.array(topi)),
                                            torch.from_numpy(np.array(topv)), *args,
                                            torch.float32)
    got = tmoe._expert_ffn(torch.from_numpy(x), tok, w, tp["wg"], tp["wu"], tp["wd"], T, d,
                           C, slot_of)
    assert got.shape == (T, d) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **MOE_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_apply_matches_jax(case, seed):
    jcfg, tcfg, jp, tp, x = _setup(case, seed)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert ty.dtype == torch.float32 and ty.shape == x.shape
    jv, ji, _ = jmoe._route(jp, jnp.asarray(x), jcfg)
    tv, ti, _ = tmoe._route(tp, torch.from_numpy(x), tcfg)
    flips = _flipped(jp, x, ji, ti)
    T = x.shape[0]
    same = ~flips & np.all(_kept(ji, jv, T, tcfg) == _kept(ti, tv, T, tcfg), axis=1)
    if not flips.any():
        assert same.all()
    np.testing.assert_allclose(_np(ty)[same], np.asarray(jy)[same], **MOE_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **MOE_TOL)
    assert tmoe.moe_dispatch(tp, torch.from_numpy(x), tcfg)[0].equal(ty)


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_grads_match_jax(case):
    """d/d(x, every leaf) of sum(y * r) + c * aux against ``jax.grad``."""
    jcfg, tcfg, jp, tp, x = _setup(case)
    rng = np.random.default_rng(7)
    r = rng.standard_normal(x.shape).astype(np.float32)
    c = 3.0
    _, ji, _ = jmoe._route(jp, jnp.asarray(x), jcfg)
    _, ti, _ = tmoe._route(tp, torch.from_numpy(x), tcfg)
    assert not _flipped(jp, x, ji, ti).any()

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, xx, jcfg)
        return jnp.sum(y * r) + c * aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_apply(tp, tx, tcfg)
    loss = torch.sum(y * torch.from_numpy(r)) + c * aux
    grads = torch.autograd.grad(loss, [tx] + list(tp.values()))
    np.testing.assert_allclose(_np(grads[0]), np.asarray(jgx), err_msg="x", **F32_TOL)
    for (name, _), g in zip(tp.items(), grads[1:]):
        np.testing.assert_allclose(_np(g), np.asarray(jgp[name]), err_msg=name, **F32_TOL)
    assert float(grads[list(tp).index("router") + 1].abs().max()) > 0


@pytest.mark.parametrize("case", ["smoke", "drops"])
def test_moe_apply_bfloat16_within_jax_own_distance(case):
    """In bfloat16: the port within twice the JAX package's own bfloat16-vs-
    float32 distance of the JAX package's bfloat16 output."""
    jcfg, tcfg, jp, tp, x = _setup(case)
    jp16 = {k: (v if k == "router" else v.astype(jnp.bfloat16)) for k, v in jp.items()}
    x16 = jnp.asarray(x, jnp.bfloat16)
    jy, jaux = jmoe.moe_apply(jp16, x16, jcfg)
    jy32, _ = jmoe.moe_apply({k: v.astype(jnp.float32) for k, v in jp16.items()},
                             x16.astype(jnp.float32), jcfg)
    tp16 = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.float32 if k == "router" else torch.bfloat16) for k, v in jp16.items()}
    ty, taux = tmoe.moe_apply(tp16, torch.from_numpy(np.asarray(x16, np.float32)).bfloat16(),
                              tcfg)
    assert ty.dtype == torch.bfloat16
    bound = 2.0 * float(np.abs(np.asarray(jy, np.float32) - np.asarray(jy32)).max())
    err = float(np.abs(ty.float().numpy() - np.asarray(jy, np.float32)).max())
    assert 0.0 < bound and err <= bound, (err, bound)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


# ---------------------------------------------------------------------------
# the fixed-order combine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_and_gather_backward_sum_in_assignment_order(dtype):
    """The combine and the gather's backward pass add a token's rows in
    the order of ``slot_of``, one rounding an add in the rows' dtype:
    bitwise a left-to-right loop; the drop slot adds nothing."""
    jcfg, tcfg, jp, tp, x = _setup("drops")
    T, d = x.shape
    tv, ti, _ = tmoe._route(tp, torch.from_numpy(x), tcfg)
    C = tmoe.capacity(T, tcfg)
    E = tcfg.n_experts
    tok, w, slot_of = tmoe._dispatch_tables(ti, tv, T, tcfg.top_k, C, 0, E, dtype)
    rows = torch.from_numpy(np.random.default_rng(3).standard_normal((E * C, d))
                            .astype(np.float32)).to(dtype)
    got = tmoe._Combine.apply(rows, slot_of, tok)
    want = torch.zeros((T, d), dtype=dtype)
    for t in range(T):
        for j in range(tcfg.top_k):
            s = int(slot_of[t, j])
            if s < E * C:
                want[t] = want[t] + rows[s]
    assert torch.equal(got, want)
    # the gather and its backward pass: the same sums
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    xe = tmoe._Dispatch.apply(xt, tok, slot_of)
    assert torch.equal(xe[tok < T], xt.detach()[tok[tok < T].long()])
    assert torch.all(xe[tok == T] == 0)
    (gx,) = torch.autograd.grad(xe, xt, rows)
    assert torch.equal(gx, want)
    # and the combine's backward pass gathers y's gradient at each slot's token
    gy = torch.from_numpy(np.random.default_rng(4).standard_normal((T, d))
                          .astype(np.float32)).to(dtype)
    rr = rows.clone().requires_grad_(True)
    (gr,) = torch.autograd.grad(tmoe._Combine.apply(rr, slot_of, tok), rr, gy)
    pad = torch.cat([gy, torch.zeros((1, d), dtype=dtype)])
    assert torch.equal(gr, pad[tok.long()])


def test_moe_apply_is_bitwise_repeatable_on_the_cpu():
    jcfg, tcfg, jp, tp, x = _setup("drops")
    outs = []
    for _ in range(2):
        p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        xx = torch.from_numpy(x).requires_grad_(True)
        y, aux = tmoe.moe_apply(p, xx, tcfg)
        outs.append((y, aux) + torch.autograd.grad(y.sum() + aux, [xx] + list(p.values())))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_moe_init_leaves_and_dtypes():
    for case in ("smoke", "shared"):
        jcfg, tcfg = _cfgs(case)
        jp = jmoe.moe_init(jax.random.key(0), jcfg, jnp.bfloat16)
        tp = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.items()} == {
            k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in tp.items()}
        assert tp["router"].dtype == torch.float32
        # N(0, 1) / sqrt(fan-in): the spread of each leaf near the reference's
        for k, v in tp.items():
            want = float(np.asarray(jp[k], np.float32).std())
            assert abs(float(v.float().std()) - want) < 0.1 * want, k
        again = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
        assert all(torch.equal(tp[k], again[k]) for k in tp)


def test_moe_apply_sharded_refuses_naming_a8():
    """The expert-parallel path is ported (ROADMAP A8.7): it refuses only a
    call without an active mesh, naming what it needs; under a (2, 2)
    mesh of the CPU it equals the JAX package's dense path on the SMOKE
    config (nothing drops at its capacity factor) at the float32 gate."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import hints

    jcfg, tcfg, jp, tp, x = _setup("smoke")
    with pytest.raises(ValueError, match="parallel.hints.activate"):
        tmoe.moe_apply_sharded(tp, torch.from_numpy(x), tcfg)
    with hints.activate(make_local_mesh(2, 2, devices=["cpu"] * 4)):
        y, aux = tmoe.moe_apply_sharded(tp, torch.from_numpy(x), tcfg)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=1e-4, atol=1e-5)
    # the aux is the mean of the dp shards' own load-balance losses
    half = len(x) // 2
    halves = [jmoe.moe_apply(jp, jnp.asarray(x[h * half:(h + 1) * half]), jcfg)[1]
              for h in range(2)]
    np.testing.assert_allclose(float(aux), float(np.mean(halves)), rtol=1e-5)


# ---------------------------------------------------------------------------
# tests/test_layers.py::TestMoEDispatch on the port
# ---------------------------------------------------------------------------


@given(T=st.sampled_from([32, 64, 96]), seed=st.integers(0, 30))
@settings(max_examples=10, deadline=None)
def test_port_dispatch_keeps_tokens_once_and_gate_mass(T, seed):
    """No token appears twice in one expert's slots, and the gates of a
    token's kept assignments sum to <= 1 (capacity factor 1.0)."""
    _, cfg = _cfgs("drops")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((T, cfg.d_model)).astype(np.float32))
    p = tmoe.moe_init(torch.Generator().manual_seed(seed), cfg, torch.float32)
    topv, topi, aux = tmoe._route(p, x, cfg)
    C = tmoe.capacity(T, cfg)
    tok, w, slot_of = tmoe._dispatch_tables(topi, topv, T, cfg.top_k, C, 0, cfg.n_experts,
                                            x.dtype)
    tok = tok.numpy().reshape(cfg.n_experts, C)
    for e in range(cfg.n_experts):
        kept = tok[e][tok[e] < T]
        assert len(set(kept.tolist())) == len(kept)
    assert float(aux) > 0
    sums = np.zeros(T + 1)
    np.add.at(sums, tok.reshape(-1), w.numpy())
    assert sums[:T].max() <= 1.0 + 1e-4
    # the inverse table names each token's kept slots
    so = slot_of.numpy()
    for t in range(T):
        mine = sorted(s for s in so[t] if s < cfg.n_experts * C)
        assert mine == sorted(np.nonzero(tok.reshape(-1) == t)[0].tolist())
