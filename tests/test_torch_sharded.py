"""The port's sharded bank (``bank/sharded.py``), its mesh
(``launch/mesh.py``) and the sharded branches of the router, the engine,
the tier, the watchdog and ``serve_fleet``, on an 8-device CPU mesh
(``devices=["cpu"] * 8``), case by case as ``tests/test_shard_bank.py``
runs the JAX package's on 8 virtual devices.

Each case holds the port against its own resident bank and against the
JAX package's, in-process; serving, fits and updates also against the JAX
package's own ``ShardedGPBank``, run once in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` that writes its
answers to an ``.npz``."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_common import gp_data, nn, specs, tt, uniform  # noqa: E402

from repro.bank import GPBank as JBank  # noqa: E402
from repro_torch.bank import (  # noqa: E402
    BankRouter,
    FleetEngine,
    GPBank,
    ShardedGPBank,
    TieredBank,
)
from repro_torch.bank import sharded as sh_mod  # noqa: E402
from repro_torch.core.convert import bank_from_numpy  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.serve_gp import serve_fleet  # noqa: E402
from repro_torch.obs import MetricsRegistry, Tracer, serving_watchdog  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_shard_bank.py's fleet: 16 tenants of 8 rows, p = 2, n = 8, 4 shards
B, N_ROWS, P, S = 16, 8, 2, 4
CPU8 = ["cpu"] * 8


def _inputs() -> dict:
    """The fleet, its queries and a mixed-tenant update, as numpy."""
    Xb = np.zeros((B, N_ROWS, P), np.float32)
    yb = np.zeros((B, N_ROWS), np.float32)
    for s in range(B):
        Xb[s], yb[s] = gp_data(N_ROWS, P, s)
    rng = np.random.default_rng(0)
    return dict(Xb=Xb, yb=yb, Xq=uniform(rng, (64, P)),
                tenants=rng.integers(0, B, 64).astype(np.int64),
                upd=np.array([0, 3, 7, 12], np.int64), Xk=uniform(rng, (4, 2, P)),
                yk=rng.normal(size=(4, 2)).astype(np.float32))


D = _inputs()
TEN = [int(t) for t in D["tenants"]]


def _carry(jbank, ts) -> GPBank:
    """A JAX bank carried across as its numpy leaves."""
    st = jbank.stack
    return bank_from_numpy(
        idx=np.asarray(st.idx), lam=np.asarray(st.lam), sqrtlam=np.asarray(st.sqrtlam),
        chol=np.asarray(st.chol), u=np.asarray(st.u), b=np.asarray(st.b),
        slots=dict(jbank.slots), active=jbank.active, spec=ts)


def _fleet(backend):
    """(jax resident, port resident (carried: the same states), port
    resident (fitted), port spec)."""
    js, ts = specs("hermite", P, n=8, backend=backend)
    jb = JBank.fit(jnp.asarray(D["Xb"]), jnp.asarray(D["yb"]), js)
    return jb, _carry(jb, ts), GPBank.fit(tt(D["Xb"]), tt(D["yb"]), ts), ts


def _mv(bank, tenants=TEN, Xq=None):
    Xq = D["Xq"] if Xq is None else Xq
    if isinstance(bank, JBank):
        mu, var = bank.mean_var(tenants, jnp.asarray(Xq))
    else:
        mu, var = bank.mean_var(tenants, tt(Xq))
    return nn(mu), nn(var)


def _close(got, want, rtol=0.0, atol=1e-5):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# the JAX package's own sharded bank on 8 virtual devices, both backends
JAX_SHARDED = """
    import jax, numpy as np, jax.numpy as jnp
    from repro.bank import GPBank, ShardedGPBank
    from repro.core.gp import GPSpec
    from repro.launch.mesh import make_bank_mesh

    d = dict(np.load({inp!r}))
    tenants = [int(t) for t in d["tenants"]]
    Xq = jnp.asarray(d["Xq"])
    out = {{}}
    for backend in ("jnp", "pallas"):
        spec = GPSpec.create(8, eps=[0.8] * 2, rho=2.0, noise=0.05, backend=backend)
        resident = GPBank.fit(jnp.asarray(d["Xb"]), jnp.asarray(d["yb"]), spec)
        sharded = ShardedGPBank.from_bank(resident, make_bank_mesh(4))
        fitted = ShardedGPBank.fit(jnp.asarray(d["Xb"]), jnp.asarray(d["yb"]), spec,
                                   make_bank_mesh(4))
        fit2 = ShardedGPBank.fit(jnp.asarray(d["Xb"]), jnp.asarray(d["yb"]), spec,
                                 make_bank_mesh(4, 2))
        upd = sharded.update([int(t) for t in d["upd"]], jnp.asarray(d["Xk"]),
                             jnp.asarray(d["yk"]))
        for name, bank in (("sharded", sharded), ("fitted", fitted), ("fit2", fit2),
                           ("update", upd)):
            mu, var = bank.mean_var(tenants, Xq)
            out[backend + "_" + name + "_mu"] = np.asarray(mu)
            out[backend + "_" + name + "_var"] = np.asarray(var)
        out[backend + "_fitted_slots"] = np.array([fitted.slot_of(t) for t in range(16)])
    np.savez({out!r}, **out)
"""


def run_jax(body: str, timeout: int = 600):
    """Run ``body`` in a fresh python with 8 virtual host devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(body)], capture_output=True,
                       text=True, timeout=timeout, env=env)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-3000:]}"


# the mixed-tenant update of the JAX package's resident bank in float64 (the
# jnp backend, the spec's float32 hyperparameters): the witness the float32
# runs of both packages are held to
JAX_FLOAT64 = """
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np, jax.numpy as jnp
    from repro.bank import GPBank
    from repro.core.gp import GPSpec

    d = dict(np.load({inp!r}))
    f64 = lambda k: jnp.asarray(d[k], jnp.float64)
    spec = GPSpec.create(8, eps=[0.8] * 2, rho=2.0, noise=0.05, backend="jnp")
    bank = GPBank.fit(f64("Xb"), f64("yb"), spec)
    upd = bank.update([int(t) for t in d["upd"]], f64("Xk"), f64("yk"))
    mu, _ = upd.mean_var([int(t) for t in d["tenants"]], f64("Xq"))
    assert mu.dtype == jnp.float64
    np.savez({out!r}, update_mu=np.asarray(mu))
"""


@pytest.fixture(scope="module")
def update_mu64(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_float64")
    inp, out = str(tmp / "inputs.npz"), str(tmp / "out.npz")
    np.savez(inp, **D)
    run_jax(JAX_FLOAT64.format(inp=inp, out=out))
    return np.load(out)["update_mu"]


def _close_to_float64(got_mu, jax_mu, mu64):
    """The port's float32 update mean against the float64 run, at the larger
    of 1e-5 and twice the JAX package's own float32 distance from it: the
    float32 summation order of the update differs between hosts."""
    gate = max(1e-5, 2.0 * float(np.abs(np.asarray(jax_mu, np.float64) - mu64).max()))
    err = float(np.abs(np.asarray(got_mu, np.float64) - mu64).max())
    assert err <= gate, (err, gate)


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_sharded")
    inp, out = str(tmp / "inputs.npz"), str(tmp / "out.npz")
    np.savez(inp, **D)
    run_jax(JAX_SHARDED.format(inp=inp, out=out))
    return dict(np.load(out))


# ---------------------------------------------------------------------------
# TestShardedParity (tests/test_shard_bank.py:73-157)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_fit_mean_var_update_match_resident(backend, update_mu64):
    """tests/test_shard_bank.py:73-118 on the port: serving the same states
    matches the resident bank (1e-5), a sharded fit serves as the resident
    fit (1e-4), a mixed-tenant update tracks the resident update (1e-5 on
    jnp, 1e-4 on pallas) and ``to_bank`` hands back the same answers; the
    same states serve as the JAX resident bank does (1e-5).  The update's
    mean against the JAX package's: on pallas at 1e-4; on jnp both are held
    to a float64 run of the update (``_close_to_float64``)."""
    jb, carried, resident, ts = _fleet(backend)
    mesh = tmesh.make_bank_mesh(S, devices=CPU8)
    sharded = ShardedGPBank.from_bank(carried, mesh)
    _close(_mv(sharded), _mv(carried))
    _close(_mv(sharded), _mv(jb))
    fitted = ShardedGPBank.fit(tt(D["Xb"]), tt(D["yb"]), ts, mesh)
    _close(_mv(fitted), _mv(resident), atol=1e-4)
    _close(_mv(fitted), _mv(jb), atol=1e-4)
    upd = [int(t) for t in D["upd"]]
    res2 = carried.update(upd, tt(D["Xk"]), tt(D["yk"]))
    sh2 = sharded.update(upd, tt(D["Xk"]), tt(D["yk"]))
    j2 = jb.update(upd, jnp.asarray(D["Xk"]), jnp.asarray(D["yk"]))
    atol = 1e-5 if backend == "jnp" else 1e-4
    _close(_mv(sh2)[:1], _mv(res2)[:1], atol=atol)
    if backend == "jnp":
        _close_to_float64(_mv(sh2)[0], _mv(j2)[0], update_mu64)
    else:
        _close(_mv(sh2)[:1], _mv(j2)[:1], atol=atol)
    _close(_mv(sharded.to_bank()), _mv(carried))


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_matches_the_jax_sharded_bank(backend, jax_sharded, update_mu64):
    """The port's sharded bank against the JAX package's own, on the same
    inputs: serving (1e-5; the port's states carried from the JAX resident
    fit, as ``from_bank`` took them there), the 1-D and the (bank, data)
    fits (tests/test_shard_bank.py:93, 111 gates), the mixed-tenant update
    (1e-4 on pallas; on jnp both held to a float64 run of the update,
    ``_close_to_float64``), and the round-robin placement slot for slot."""
    j = {k[len(backend) + 1:]: v for k, v in jax_sharded.items() if k.startswith(backend)}
    jb, carried, _, ts = _fleet(backend)
    sharded = ShardedGPBank.from_bank(carried, tmesh.make_bank_mesh(S, devices=CPU8))
    _close(_mv(sharded), (j["sharded_mu"], j["sharded_var"]))
    fitted = ShardedGPBank.fit(tt(D["Xb"]), tt(D["yb"]), ts, tmesh.make_bank_mesh(S, devices=CPU8))
    _close(_mv(fitted), (j["fitted_mu"], j["fitted_var"]), atol=1e-4)
    assert [fitted.slot_of(t) for t in range(B)] == j["fitted_slots"].tolist()
    fit2 = ShardedGPBank.fit(tt(D["Xb"]), tt(D["yb"]), ts,
                             tmesh.make_bank_mesh(S, 2, devices=CPU8))
    _close(_mv(fit2), (j["fit2_mu"], j["fit2_var"]), atol=1e-4)
    upd = sharded.update([int(t) for t in D["upd"]], tt(D["Xk"]), tt(D["yk"]))
    if backend == "jnp":
        _close_to_float64(_mv(upd)[0], j["update_mu"], update_mu64)
    else:
        _close(_mv(upd)[:1], (j["update_mu"],), atol=1e-4)


def test_2d_bank_data_mesh_fit():
    """tests/test_shard_bank.py:120-136: a (bank 4, data 2) fit serves as
    the resident fit (1e-4), in the port and against the JAX resident
    fit."""
    jb, _, resident, ts = _fleet("jnp")
    mesh2 = tmesh.make_bank_mesh(4, 2, devices=CPU8)
    assert mesh2.shape == {"bank": 4, "data": 2}
    fitted = ShardedGPBank.fit(tt(D["Xb"]), tt(D["yb"]), ts, mesh2)
    _close(_mv(fitted), _mv(resident), atol=1e-4)
    _close(_mv(fitted), _mv(jb), atol=1e-4)
    # ragged rows: N = 7 over 2 data cells pads one masked row per tenant
    ragged = ShardedGPBank.fit(tt(D["Xb"][:, :7]), tt(D["yb"][:, :7]), ts, mesh2)
    flat = GPBank.fit(tt(D["Xb"][:, :7]), tt(D["yb"][:, :7]), ts)
    _close(_mv(ragged), _mv(flat), atol=1e-4)


def test_homogeneous_only_and_capacity_guards():
    """tests/test_shard_bank.py:138-157, and the refusals around them."""
    _, carried, _, ts = _fleet("jnp")
    mesh = tmesh.make_bank_mesh(S, devices=CPU8)
    het = GPBank(stack=carried.stack, active=carried.active, slots=dict(carried.slots),
                 hypers=carried._stacked_hypers())
    with pytest.raises(ValueError, match="heterogeneous"):
        ShardedGPBank.from_bank(het, mesh)
    with pytest.raises(ValueError, match="multiple"):
        ShardedGPBank.create(ts, 10, mesh)
    with pytest.raises(ValueError, match="bank"):
        ShardedGPBank.create(ts, 8, tmesh.make_local_mesh(2, devices=CPU8))
    with pytest.raises(ValueError, match="homogeneous"):
        ShardedGPBank(shards=(), mesh=mesh, slots={}, hypers=carried._stacked_hypers())
    sharded = ShardedGPBank.from_bank(carried, mesh)
    with pytest.raises(NotImplementedError, match="to_bank"):
        sharded.optimize(tt(D["Xb"]), tt(D["yb"]))
    with pytest.raises(ValueError, match="already in the bank"):
        sharded.insert(0, sharded.state(0))
    with pytest.raises(ValueError, match="duplicate"):
        sharded.update([1, 1], tt(D["Xk"][:2]), tt(D["yk"][:2]))


def test_from_bank_pads_capacity_and_keeps_slots():
    """``pad_capacity`` rounds 10 slots up to 12 with prior slots; slots
    keep their global ids; ``create`` holds only prior states."""
    js, ts = specs("hermite", P, n=8)
    jb = JBank.fit(jnp.asarray(D["Xb"][:10]), jnp.asarray(D["yb"][:10]), js)
    carried = _carry(jb, ts)
    mesh = tmesh.make_bank_mesh(S, devices=CPU8)
    with pytest.raises(ValueError, match="multiple"):
        ShardedGPBank.from_bank(carried, mesh)
    sharded = ShardedGPBank.from_bank(carried, mesh, pad_capacity=True)
    assert sharded.capacity == 12 and sharded.shard_capacity == 3
    assert dict(sharded.slots) == dict(carried.slots)
    assert sharded.shard_occupancy().tolist() == [3, 3, 3, 1]
    ten10 = [t % 10 for t in TEN]
    _close(_mv(sharded, ten10), _mv(jb, ten10))
    empty = ShardedGPBank.create(ts, 8, mesh)
    assert len(empty) == 0 and empty.active.sum() == 0
    for sh in empty.shards:
        np.testing.assert_array_equal(nn(sh.stack.chol), np.broadcast_to(
            np.eye(empty.n_features), sh.stack.chol.shape))


# ---------------------------------------------------------------------------
# TestShardedChurn (tests/test_shard_bank.py:160-248)
# ---------------------------------------------------------------------------


TRACKED = ("_sh_write_slot", "_sh_read_slot", "_sh_mean_var", "_sh_update_scatter")


def test_insert_evict_rebalance_add_no_shape_signature():
    """The churn pin of tests/test_shard_bank.py:161-212: once one churn
    cycle (evictions off shard 0, inserts, a rebalance, a serve of every
    tenant, a state read) has run, an identical cycle adds no new shape
    signature to any shard-local step."""
    _, carried, _, _ = _fleet("jnp")
    sharded = ShardedGPBank.from_bank(carried, tmesh.make_bank_mesh(S, devices=CPU8))
    rng = np.random.default_rng(3)

    def churn_cycle(bank, tag):
        victims = [t for t in bank.tenants if bank.shard_of(t) == 0][:2]
        for t in victims:
            st = bank.state(t)
            bank = bank.evict(t)
        for i, _ in enumerate(victims):
            bank = bank.insert((tag, i), st)
        bank, _ = bank.rebalance()
        tl = list(bank.tenants)
        bank.mean_var(tl, tt(uniform(rng, (len(tl), P))))
        bank.state(bank.tenants[0])
        return bank

    bank = churn_cycle(sharded, "warm")
    sizes0 = {name: getattr(sh_mod, name)._cache_size() for name in TRACKED}
    bank = churn_cycle(bank, "pin")
    assert {name: getattr(sh_mod, name)._cache_size() for name in TRACKED} == sizes0
    wd = serving_watchdog(mode="raise")
    churn_cycle(bank, "again")
    assert wd.check("churn") == {}


def test_placement_determinism():
    """tests/test_shard_bank.py:214-248: round-robin fit placement,
    least-loaded insert (ties to the lowest id), the fullest shard donating
    its highest occupied local slot until the spread is <= 1, identically
    run to run."""
    _, _, _, ts = _fleet("jnp")
    fitted = ShardedGPBank.fit(tt(D["Xb"]), tt(D["yb"]), ts,
                               tmesh.make_bank_mesh(S, devices=CPU8))
    C_l = fitted.shard_capacity
    for i in range(B):
        assert fitted.shard_of(i) == i % S
        assert fitted.slot_of(i) == (i % S) * C_l + i // S
    st = fitted.state(0)
    b = fitted.evict(1).evict(5)
    b = b.insert("a", st)
    assert b.shard_of("a") == 1
    b = b.insert("b", st)
    assert b.shard_of("b") == 1

    def scenario():
        bb = fitted
        for t in [0, 4, 8, 12]:
            bb = bb.evict(t)
        bb, moves = bb.rebalance()
        return moves, {t: bb.shard_of(t) for t in bb.tenants}, bb

    m1, a1, bb = scenario()
    m2, a2, _ = scenario()
    assert m1 == m2 and a1 == a2 and m1 > 0
    occ = bb.shard_occupancy()
    assert occ.max() - occ.min() <= 1
    # a moved tenant serves exactly as before its move
    moved = [t for t in a1 if a1[t] != fitted.shard_of(t)]
    _close(_mv(bb, moved, D["Xq"][:len(moved)]), _mv(fitted, moved, D["Xq"][:len(moved)]),
           atol=0.0)
    assert bb.rebalance(max_moves=0)[1] == 0


def test_query_batch_packs_each_shard_on_its_own_rung():
    """A hot shard pads nobody: each shard's rows go to the next power of
    two of its own count, and every row's result comes back to its place."""
    gslots = np.array([0] * 5 + [9] + [5, 6], np.int64)
    groups, pos = sh_mod._group_rows(gslots, 4, 4)
    assert [(s, len(rows)) for s, rows, _ in groups] == [(0, 8), (1, 2), (2, 1)]
    assert pos.tolist() == [0, 1, 2, 3, 4, 10, 8, 9]
    scat = sh_mod._group_slots(np.array([1, 2, 3, 9], np.int64), 4)
    assert [(s, idx.tolist(), ls.tolist()) for s, idx, ls in scat] == \
        [(0, [0, 1, 2], [1, 2, 3, 0]), (2, [3], [1])]


# ---------------------------------------------------------------------------
# TestShardedIntegration (tests/test_shard_bank.py:251-314)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_router_engine_tiered(backend, tmp_path):
    """tests/test_shard_bank.py:252-314: engine drain parity (1e-5) and
    ingest parity (1e-4) against the resident bank, the per-shard gauges
    and trace events, the router's rebalance and a page-out / page-in that
    lands on the least-loaded shard."""
    jb, carried, _, _ = _fleet(backend)
    reg, tracer = MetricsRegistry(), Tracer()
    router = BankRouter(ShardedGPBank.from_bank(carried, tmesh.make_bank_mesh(S, devices=CPU8)),
                        microbatch=8, metrics=reg, tracer=tracer)
    eng = FleetEngine(router, metrics=reg, tracer=tracer)
    tickets = [eng.submit(t, D["Xq"][i]) for i, t in enumerate(TEN)]
    res = eng.drain()
    mu_r, _ = _mv(jb)
    np.testing.assert_allclose([res[t].mu for t in tickets], mu_r, atol=1e-5)
    rng = np.random.default_rng(4)
    obs_t = [2, 9]
    xr, yr = uniform(rng, (2, P)), rng.normal(size=2).astype(np.float32)
    for i, t in enumerate(obs_t):
        eng.observe(t, xr[i], yr[i])
    eng.ingest()
    res2 = jb.update(obs_t, jnp.asarray(xr[:, None, :]), jnp.asarray(yr[:, None]))
    np.testing.assert_allclose(_mv(router.bank)[0], _mv(res2)[0], atol=1e-4)
    snap = reg.snapshot()
    assert {"bank_shard_occupancy", "bank_shard_backlog"} <= {
        k.split("{")[0] for k in snap["gauges"]}
    names = {ev.get("name") for ev in tracer.events()}
    assert "shard_dispatch" in names and "shard_ingest" in names
    for t in [t for t in router.bank.tenants if router.bank.shard_of(t) == 0]:
        router.bank = router.bank.evict(t)
    assert router.rebalance(threshold=1) > 0
    occ = router.bank.shard_occupancy()
    assert occ.max() - occ.min() <= 1
    moves = [v for k, v in reg.snapshot()["counters"].items()
             if k.startswith("bank_rebalance_total")]
    assert sum(moves) > 0
    tb = TieredBank(router.bank, str(tmp_path))
    t0 = tb.hot_tenants[0]
    tb.evict_to_cold(t0)
    assert t0 not in tb.bank.tenants
    least = int(np.argmin(tb.bank.shard_occupancy()))
    tb.page_in(t0)
    assert tb.bank.shard_of(t0) == least
    _close(_mv(tb.bank, [t0] * 4, D["Xq"][:4]), _mv(jb, [t0] * 4, D["Xq"][:4]), atol=1e-4)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_downdate_and_refit_window_match_resident(backend):
    """Forgetting per shard: the sharded downdate and window refit of a
    mixed-tenant batch serve as the resident bank's (1e-5), ``ok`` in the
    caller's order; a tiered fleet ages through them."""
    _, carried, _, _ = _fleet(backend)
    sharded = ShardedGPBank.from_bank(carried, tmesh.make_bank_mesh(S, devices=CPU8))
    ids = [1, 6, 11, 14, 3]
    Xf = np.stack([D["Xb"][t, :3] for t in ids])
    yf = np.stack([D["yb"][t, :3] for t in ids])
    r2, ok_r = carried.downdate(ids, tt(Xf), tt(yf))
    s2, ok_s = sharded.downdate(ids, tt(Xf), tt(yf))
    assert ok_s.tolist() == ok_r.tolist()
    _close(_mv(s2), _mv(r2))
    Xw = np.stack([D["Xb"][t, 3:] for t in ids])
    yw = np.stack([D["yb"][t, 3:] for t in ids])
    _close(_mv(sharded.refit_window(ids, tt(Xw), tt(yw))),
           _mv(carried.refit_window(ids, tt(Xw), tt(yw))))


def test_serve_fleet_shards_on_the_cpu(tmp_path):
    """``serve_fleet(shards=4)`` on the CPU answers as the unsharded fleet
    (both engines, and over a cold tier), records ``shards`` and
    ``shard_occupancy``, and refuses ``reopt_every`` as the JAX package
    does."""
    kw = dict(device="cpu", tenants=10, n_train=16, p=2, n=4, rounds=2,
              queries_per_round=32, observations_per_round=24, microbatch=8)
    for extra in (dict(engine="sync"), dict(engine="pipelined"),
                  dict(engine="pipelined", cold_dir=str(tmp_path), capacity=8)):
        flat = serve_fleet(**kw, **extra)
        if "cold_dir" in extra:
            extra = dict(extra, cold_dir=str(tmp_path / "sharded"))
        out = serve_fleet(shards=4, **kw, **extra)
        assert out["shards"] == 4 and sum(out["shard_occupancy"]) == len(out["bank"])
        for h, g in zip(out["rounds"], flat["rounds"]):
            assert h["rows_absorbed"] == g["rows_absorbed"]
            assert abs(h["rmse"] - g["rmse"]) < 1e-5, (extra, h["rmse"], g["rmse"])
    with pytest.raises(ValueError, match="homogeneous"):
        serve_fleet(shards=2, reopt_every=1, **kw)


# ---------------------------------------------------------------------------
# the mesh (launch/mesh.py)
# ---------------------------------------------------------------------------


def test_mesh_takes_cards_or_the_devices_given():
    """A mesh asks the visible cards by default and raises, naming the
    count, with fewer; an explicit list may repeat a device and is reshaped
    to the grid; the production mesh (ROADMAP A8.7) wants its 256 cells."""
    m = tmesh.make_bank_mesh(4, 2, devices=CPU8)
    assert m.shape == {"bank": 4, "data": 2} and m.axis_names == ("bank", "data")
    assert m.devices.shape == (4, 2) and {str(d) for d in m.devices.flat} == {"cpu"}
    lm = tmesh.make_local_mesh(data=2, model=4, devices=CPU8)
    assert lm.shape == {"data": 2, "model": 4} and lm.size == 8
    with pytest.raises(ValueError, match="wants 16 devices; only 8 devices given"):
        tmesh.make_bank_mesh(8, 2, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="wants 2 devices; only 0 CUDA devices visible"):
            tmesh.make_bank_mesh(2)
    with pytest.raises(ValueError, match="wants 256 devices; only 8 devices given"):
        tmesh.make_production_mesh(devices=CPU8)
    assert tmesh.make_production_mesh(devices=CPU8 * 32).shape == {"data": 16, "model": 16}


# ---------------------------------------------------------------------------
# the fleet's width on the card (ROADMAP.md section C, C9)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_2d_fit_matches_resident_at_fleet_width():
    """8 tenants of the fleet (N = 10^4 rows, p = 4, n = 5: M = 625) fitted
    resident and over a (bank 4, data 2) mesh of one card: the data split
    sums each tenant's rows in two halves, the resident fit in one, both in
    the fused fit's 1,024-row strips; the means and variances on 1,024 mixed
    queries agree at tests/test_shard_bank.py:134-136's 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (repro_torch's CUDA kernels)")
    from repro_torch.core.gp import GPSpec
    from repro_torch.launch.serve_gp import fleet_dataset

    dev = torch.device("cuda")
    tenants, N, p, n = 8, 10_000, 4, 5
    _, Xb, yb, _ = fleet_dataset(np.random.default_rng(0), tenants=tenants, n_train=N, p=p,
                                 rounds=1, observations_per_round=8, noise=0.05, seed=0)
    spec = GPSpec.create(n, eps=np.full((p,), 0.8, np.float32), rho=2.0, noise=0.05,
                         backend="pallas", device=dev)
    Xc, yc = torch.from_numpy(Xb).to(dev), torch.from_numpy(yb).to(dev)
    rng = np.random.default_rng(1)
    Xq = torch.from_numpy(uniform(rng, (1024, p))).to(dev)
    ten = [int(t) for t in rng.integers(0, tenants, 1024)]
    resident = GPBank.fit(Xc, yc, spec).mean_var(ten, Xq)
    mesh = tmesh.make_bank_mesh(4, 2, devices=[dev] * 8)
    split = ShardedGPBank.fit(Xc, yc, spec, mesh).mean_var(ten, Xq)
    for got, want in zip(split, resident):
        assert float((got - want).abs().max()) <= 1e-4
