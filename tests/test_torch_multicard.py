"""The multi-device paths on cards (marked ``cuda``; the cases that need two
cards skip on fewer, naming how many are visible).

Each kernel launched with its inputs on ``cuda:1`` while ``cuda:0`` is the
current card gives, bit for bit, what the same launch gives on ``cuda:0``:
every launch and plan lookup runs on its tensor's card
(``kernels/_build.py::on_device``).  The sharded bank and the row-sharded
fit across two cards answer as they do with both shards on one card.  No
JAX here: each path is held against itself on one card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_common import gp_data, uniform  # noqa: E402

from repro_torch.bank import BankRouter, FleetEngine, ShardedGPBank  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core.expansions import get_expansion  # noqa: E402
from repro_torch.core.fagp import GPSpec, _idx_tensor  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.hermite_phi import TileArgs  # noqa: E402
from repro_torch.launch.mesh import make_bank_mesh, make_local_mesh  # noqa: E402


@pytest.fixture
def two_cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"needs two NVIDIA GPUs, {n} visible")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def _tile(expansion, dev, p=3):
    kw = dict(num_features=48) if expansion != "hermite" else {}
    spec = GPSpec.create(5, np.full(p, 0.8, np.float32), 2.0, 0.05, expansion=expansion,
                         device="cpu", **kw)
    tile = get_expansion(expansion).tile_args(spec, _idx_tensor(spec))
    return TileArgs(**{f: (v.to(dev) if isinstance(v, torch.Tensor) else v)
                       for f, v in vars(tile).items()})


def _calls(dev):
    """Every kernel's wrapper on inputs made on ``dev``: name -> thunk."""
    rng = np.random.default_rng(0)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    X, y = gp_data(300, 3, 1)
    X, y = on(X), on(y)
    th, tr = _tile("hermite", dev), _tile("rff_se", dev)
    d = on(rng.uniform(0.1, 1.0, th.M).astype(np.float32))
    Xb = on(uniform(rng, (4, 70, 3)))
    yb = on(uniform(rng, (4, 70)))
    A = on(uniform(rng, (130, th.M)))
    C = on(uniform(rng, (th.M, th.M)))
    M = 96
    L = torch.linalg.cholesky(torch.eye(M, device=dev) * M + on(uniform(rng, (M, M))) @
                              on(uniform(rng, (M, M))).T)
    W1, W3 = on(uniform(rng, (8, M)) * 0.1), on(uniform(rng, (3, 8, M)) * 0.1)
    L3 = torch.stack([L, L, L])
    return {
        "phi_features hermite": lambda: ops.expansion_phi(X, th),
        "phi_features rff": lambda: ops.expansion_phi(X, tr),
        "phi_gram scale": lambda: ops.fused_fit_moments(X, y, th, d, 0.0025),
        "phi_gram moments": lambda: ops.fused_fit_moments(X, y, tr, None, 1.0, scale=False),
        "phi_gram bank": lambda: ops.bank_fused_fit_moments(Xb, yb, th),
        "scaled_gram": lambda: ops.scaled_gram(ops.expansion_phi(X, th), d, 0.0025),
        "diag_quad": lambda: ops.diag_quad(A, C),
        "chol_update": lambda: ops.chol_update(L, W1),
        "chol_update batched": lambda: ops.chol_update(L3, W3),
        "chol_downdate": lambda: ops.chol_downdate(L3, W3),
    }


def _host(out):
    if isinstance(out, torch.Tensor):
        return [out.cpu()]
    return [t.cpu() for t in out]


@pytest.mark.cuda
def test_every_launch_runs_on_its_tensors_card(two_cards):
    """Inputs on cuda:1 while cuda:0 is current: each kernel's result is
    bitwise the same launch's on cuda:0, and the current card is left as
    it was."""
    c0, c1 = two_cards
    with torch.cuda.device(c0):
        want = {k: _host(f()) for k, f in _calls(c0).items()}
        ops.reset_launch_counts()
        got = {k: _host(f()) for k, f in _calls(c1).items()}
        counts = ops.launch_counts()
        assert torch.cuda.current_device() == 0
    for k in want:
        assert all(torch.equal(g, w) for g, w in zip(got[k], want[k])), k
    assert sum(sum(v.values()) for v in counts.values()) == 11, counts


@pytest.mark.cuda
def test_sharded_bank_across_two_cards_as_on_one(two_cards):
    """A 2-shard fleet on cuda:0 and cuda:1 fits, serves (directly and
    through the pipelined engine, one event per shard), ingests and
    rebalances as the same fleet with both shards on cuda:0 (1e-6)."""
    c0, c1 = two_cards
    B, N, p = 12, 40, 2
    rng = np.random.default_rng(2)
    Xb = np.stack([gp_data(N, p, s)[0] for s in range(B)])
    yb = np.stack([gp_data(N, p, s)[1] for s in range(B)])
    Xq, ten = uniform(rng, (50, p)), [int(t) for t in rng.integers(0, B, 50)]
    spec = GPSpec.create(6, [0.8] * p, 2.0, 0.05, backend="pallas", device=c0)
    out = []
    for mesh in (make_bank_mesh(2, devices=[c0, c1]), make_bank_mesh(2, devices=[c0, c0])):
        bank = ShardedGPBank.fit(Xb, yb, spec, mesh)
        assert [sh.spec.device for sh in bank.shards] == list(mesh.devices[:, 0])
        eng = FleetEngine(BankRouter(bank, microbatch=16, ingest_chunk=4), auto_pump=False)
        tickets = [eng.submit(t, Xq[i]) for i, t in enumerate(ten)]
        res = eng.drain()
        for t in range(B):
            eng.observe(t, Xq[t], 0.5)
        eng.ingest()
        moved, _ = eng.router.bank.evict(0).evict(2).evict(4).rebalance()
        live = [i for i, t in enumerate(ten) if t not in (0, 2, 4)]
        mu, var = moved.mean_var([ten[i] for i in live], torch.from_numpy(Xq[live]))
        out.append((torch.tensor([res[t].mu for t in tickets]), mu.cpu(), var.cpu()))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-6)


@pytest.mark.cuda
def test_fit_distributed_across_two_cards_as_on_one(two_cards):
    """The row-sharded fit and serving over cuda:0 and cuda:1 (partial
    moments summed on cuda:0 in shard order) equal the same schedule with
    both shards on cuda:0 (1e-6)."""
    c0, c1 = two_cards
    X, y = gp_data(2000, 2, 0)
    Xs = uniform(np.random.default_rng(1), (300, 2))
    spec = GPSpec.create(8, [0.8, 0.8], 2.0, 0.05, backend="pallas", device=c0)
    res = []
    for devices in ([c0, c1], [c0, c0]):
        mesh = make_local_mesh(data=2, devices=devices)
        st = tdist.fit_distributed(X, y, spec, mesh)
        assert st.u.device == c0
        res.append([st.u.cpu(), *(t.cpu() for t in tdist.predict_distributed(Xs, st, mesh))])
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-6)
