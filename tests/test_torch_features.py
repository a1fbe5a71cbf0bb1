"""The features kernel module (``kernels/hermite_phi.py``, CUDA kernel
``csrc/phi_features.cu``) at the edges of the kernel's launch: the plain
version (what a CPU tensor runs, launching nothing) against the JAX kernel
in interpret mode; the C signatures bound in Python against the source;
and, on the card (marked ``cuda``, skipped without one), the kernel against
its plain version at the same edges and at the paths' shapes, its launch
plan and its launch count.  Past the paths' inputs, near a zero of a
Hermite polynomial, the plain version, the JAX kernel and the CUDA kernel
agree at the gate too (ROADMAP.md §C, C3, closed)."""
import ctypes
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_common import nn, specs, tt, uniform  # noqa: E402

from repro.core import fagp as jfagp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import expansions as texp  # noqa: E402
from repro_torch.core.fagp import _idx_tensor  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import hermite_phi as thp  # noqa: E402



def _tiles(expansion, p, n, R, M=None):
    """The same feature map in both packages, cut to its first M columns:
    (JAX consts, table, tile_fn, n_max) and the port's TileArgs."""
    js, ts = specs(expansion, p, n=n, num_features=R or 32)
    jexp = jfagp.get_expansion(expansion)
    table = jexp.tile_table(jexp.pallas_prepare(js.indices(), js), js)
    tile = texp.get_expansion(expansion).tile_args(ts, _idx_tensor(ts))
    if M is not None:
        table = table[:, :M]
        cut = dict(idx=tile.idx[:M].contiguous()) if tile.kind == "hermite" \
            else dict(table=tile.table[:, :M].contiguous())
        tile = dataclasses.replace(tile, M=M, **cut)
    return (jexp.tile_consts(js), table, jexp.tile_fn(), js.n), tile


def _jax_phi(X, consts, table, n_max, fn):
    """The JAX kernel in interpret mode on the CPU (on a machine with a card
    JAX would otherwise run it there, at its default matmul precision)."""
    with jax.default_device(jax.devices("cpu")[0]):
        return np.asarray(jops.expansion_phi(jnp.asarray(X), consts, jnp.asarray(table),
                                             n_max=n_max, tile_fn=fn))


# (expansion, N, p, n or R, M cut): the kernel's edges -- one row; fewer
# columns than a block's 128 threads; M not a multiple of a block's
# columns (C x 128) or of the 128 threads; one column; p = 1 and p = 9 (past
# the instances unrolled for p <= 8); n = 1; RFF at odd M; rows past one
# 32-row tile and a ragged last tile
EDGES = [
    ("hermite", 1, 4, 5, None),
    ("hermite", 40, 2, 5, None),
    ("hermite", 70, 4, 5, 129),
    ("hermite", 33, 4, 6, 1031),
    ("hermite", 97, 3, 4, 1),
    ("hermite", 33, 1, 7, None),
    ("hermite", 33, 9, 2, None),
    ("hermite", 65, 3, 1, None),
    ("rff_se", 45, 3, 40, 77),
    ("rff_matern52", 37, 2, 64, 127),
    ("rff_se", 31, 9, 24, 47),
]


@pytest.mark.parametrize("expansion,N,p,nr,M", EDGES)
def test_features_match_jax_kernel_at_launch_edges(expansion, N, p, nr, M):
    n = nr if expansion == "hermite" else 1
    R = nr if expansion != "hermite" else None
    (c, table, fn, n_max), tile = _tiles(expansion, p, n, R, M)
    X = uniform(np.random.default_rng(N + p), (N, p), -1.5, 1.5)
    want = _jax_phi(X, c, table, n_max, fn)
    ops.reset_launch_counts()
    got = ops.expansion_phi(tt(X), tile)
    assert ops.launch_counts()["phi_features"] == {}  # a CPU tensor runs the plain version
    assert got.shape == (N, tile.M) == tuple(want.shape)
    # tests/test_kernels.py:48 gate: rtol 4e-5 * max(4, n_max)
    np.testing.assert_allclose(nn(got), nn(want), rtol=4e-5 * max(4, n_max), atol=1e-5)


def _c_params(source: str, name: str) -> list:
    text = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
    assert m, name
    return [" ".join(a.split()) for a in m.group(1).split(",")]


@pytest.mark.parametrize("name", sorted(thp.ARGTYPES))
def test_bound_c_signatures_match_the_source(name):
    """Each argument bound in Python is the source's: a pointer as a
    pointer (else ctypes would pass it as a 32-bit int), an int as an int."""
    params = _c_params("phi_features", name)
    bound = thp.ARGTYPES[name]
    assert len(params) == len(bound), (params, bound)
    for param, ct in zip(params, bound):
        if "*" in param:
            assert ct is ctypes.c_void_p or issubclass(ct, ctypes._Pointer), (param, ct)
        else:
            assert param.split()[0] == "int" and ct is ctypes.c_int, (param, ct)


# ROADMAP.md §C, C3: the fleet's ingest shape (8,192 x 625, p = 4, n = 5) on
# inputs in +-1.5, the JAX test's range; row 4954 has x_3 = 0.7294, where
# z = 1.6508 sits on a zero of H_4, so psi_5 there is a cancellation that
# lands inside the gate only when the recurrence rounds each step once, as
# the kernels' fused multiply-add does
C3 = ("hermite", 8192, 4, 5, None)


def _c3_inputs():
    return uniform(np.random.default_rng(C3[1] + C3[2]), C3[1:3], -1.5, 1.5)


def test_plain_features_match_jax_kernel_past_the_paths_inputs():
    (c, table, fn, n_max), tile = _tiles("hermite", 4, 5, None)
    X = _c3_inputs()
    want = _jax_phi(X, c, table, n_max, fn)
    got = ops.expansion_phi(tt(X), tile)
    np.testing.assert_allclose(nn(got), nn(want), rtol=4e-5 * max(4, n_max), atol=1e-5)


def test_launch_refuses_cpu_tensors_and_launches_nothing():
    """phi_features_launch checks what ops.expansion_phi checks: CPU tensors
    run the plain version, never the kernel, so it raises before the
    library is touched."""
    _, tile = _tiles("hermite", 2, 3, None)
    X = tt(uniform(np.random.default_rng(0), (5, 2)))
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="phi_features_launch"):
        thp.phi_features_launch(X, tile, torch.empty(5, tile.M))
    assert ops.launch_counts()["phi_features"] == {}


# ---------------------------------------------------------------------------
# On the card (skipped here)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _on(tile, device):
    return thp.TileArgs(**{f: (v.to(device) if isinstance(v, torch.Tensor) else v)
                           for f, v in vars(tile).items()})


# the paths' shapes (p = 4): a phase-3 microbatch and update, a fleet
# microbatch and ingest round, phase 6's stored Phi, the RFF path's microbatch
PATHS = [
    ("hermite", 128, 4, 11, None),
    ("hermite", 64, 4, 11, None),
    ("hermite", 256, 4, 5, None),
    ("hermite", 8192, 4, 5, None),
    ("hermite", 10_000, 4, 11, None),
    ("rff_se", 128, 4, 4096, None),
]
# shapes tall enough that the plan takes the 8-column instance for kinds and
# widths no path gives it: RFF, p = 2 unrolled, p = 9 (any p)
WIDE = [
    ("rff_se", 10_000, 4, 4096, None),
    ("hermite", 70_000, 2, 8, None),
    ("hermite", 70_000, 9, 2, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("expansion,N,p,nr,M", EDGES + PATHS + WIDE)
def test_cuda_features_match_plain(cuda_device, expansion, N, p, nr, M):
    n = nr if expansion == "hermite" else 1
    _, tile = _tiles(expansion, p, n, nr if expansion != "hermite" else None, M)
    tile = _on(tile, cuda_device)
    # the edges on the JAX test's inputs (+-1.5), the paths' and the wide
    # shapes on the paths' own (the data generator's +-1)
    lim = 1.0 if (expansion, N, p, nr, M) in PATHS + WIDE else 1.5
    X = tt(uniform(np.random.default_rng(N + p), (N, p), -lim, lim)).to(cuda_device)
    ops.reset_launch_counts()
    got = ops.expansion_phi(X, tile)
    assert ops.launch_counts()["phi_features"] == {"": 1}
    # chip_smoke.py's tol_phi: the tests/test_kernels.py:48 gate
    np.testing.assert_allclose(nn(got), nn(thp.phi_features_plain(X, tile)),
                               rtol=4e-5 * max(4, n), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("expansion,N,p,nr,M", EDGES + PATHS + WIDE)
def test_cuda_phi_features_plan(cuda_device, expansion, N, p, nr, M):
    n = nr if expansion == "hermite" else 1
    _, tile = _tiles(expansion, p, n, nr if expansion != "hermite" else None, M)
    plan = thp.phi_features_plan(N, tile.M, tile.kind, p, tile.n_max, cuda_device)
    width = plan["threads"] * plan["cols_per_thread"]
    strip = plan["rows_per_tile"] * plan["tiles_per_block"]
    # the grid covers every column and row, with no empty block
    assert plan["col_blocks"] * width >= tile.M > (plan["col_blocks"] - 1) * width
    assert plan["row_strips"] * strip >= N > (plan["row_strips"] - 1) * strip
    assert plan["cols_per_thread"] in (1, 8)
    if (expansion, N, p, nr, M) in WIDE or N == 10_000:
        assert plan["cols_per_thread"] == 8
    assert plan["blocks"] == plan["col_blocks"] * plan["row_strips"]
    props = torch.cuda.get_device_properties(cuda_device)
    limit = getattr(props, "shared_memory_per_block_optin", 232_448)
    assert 0 < plan["smem_bytes"] <= limit
    assert plan["resident_blocks_per_sm"] >= 1
    # at most one wave, unless one row of column blocks is wider than it
    wave = plan["resident_blocks_per_sm"] * props.multi_processor_count
    assert plan["blocks"] <= max(wave, plan["col_blocks"])
    with pytest.raises(RuntimeError, match="phi_features"):
        thp.phi_features_plan(N, 0, tile.kind, p, tile.n_max, cuda_device)


@pytest.mark.cuda
def test_cuda_features_match_jax_kernel_past_the_paths_inputs(cuda_device):
    """At C3's inputs the kernel agrees with the JAX kernel at its gate."""
    (c, table, fn, n_max), tile = _tiles("hermite", 4, 5, None)
    X = _c3_inputs()
    want = _jax_phi(X, c, table, n_max, fn)
    got = ops.expansion_phi(tt(X).to(cuda_device), _on(tile, cuda_device))
    np.testing.assert_allclose(nn(got), nn(want), rtol=4e-5 * max(4, n_max), atol=1e-5)


@pytest.mark.cuda
def test_cuda_features_match_plain_past_the_paths_inputs(cuda_device):
    _, tile = _tiles("hermite", 4, 5, None)
    tile = _on(tile, cuda_device)
    X = tt(_c3_inputs()).to(cuda_device)
    np.testing.assert_allclose(nn(ops.expansion_phi(X, tile)),
                               nn(thp.phi_features_plain(X, tile)), rtol=4e-5 * 5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["shape", "dtype", "strided", "cpu"])
def test_cuda_launch_checks_its_output(cuda_device, bad):
    _, tile = _tiles("hermite", 2, 3, None)
    tile = _on(tile, cuda_device)
    X = tt(uniform(np.random.default_rng(0), (5, 2))).to(cuda_device)
    out = {"shape": lambda: torch.empty(4, tile.M, device=cuda_device),
           "dtype": lambda: torch.empty(5, tile.M, device=cuda_device, dtype=torch.float64),
           "strided": lambda: torch.empty(tile.M, 5, device=cuda_device).T,
           "cpu": lambda: torch.empty(5, tile.M)}[bad]()
    ops.reset_launch_counts()
    with pytest.raises((ValueError, TypeError), match="phi_features_launch"):
        thp.phi_features_launch(X, tile, out)
    assert ops.launch_counts()["phi_features"] == {}
    good = torch.empty(5, tile.M, device=cuda_device)
    thp.phi_features_launch(X, tile, good)
    assert torch.equal(good, ops.expansion_phi(X, tile))
