"""Port parity for the slice as a whole: ``serve_gp`` end to end on the CPU
against the JAX package's ``serve_gp``, the CLI, and the data generator."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_common import nn  # noqa: E402

from repro.data import make_gp_dataset as j_make  # noqa: E402
from repro.launch.serve_gp import serve_gp as j_serve  # noqa: E402
from repro_torch.data import make_gp_dataset as t_make  # noqa: E402
from repro_torch.launch import serve_gp as t_serve_mod  # noqa: E402

# M = 25 (p = 2, n = 5); update_size 3 takes the rank-1 sweep (3 * 8 <= 25)
SMALL = dict(n_train=256, p=2, n=5, rounds=2, update_size=3, queries=70,
             microbatch=32, noise=0.05, seed=0)


def test_dataset_identical_to_jax():
    for a, b in zip(t_make(120, 3, seed=4, device="cpu"), j_make(120, 3, seed=4)):
        np.testing.assert_array_equal(nn(a), np.asarray(b))


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_serve_gp_matches_jax(backend):
    got = t_serve_mod.serve_gp(backend=backend, device="cpu", **SMALL)
    want = j_serve(backend=backend, **SMALL)
    assert got["M"] == want["M"] == 25 and got["device"] == "cpu"
    assert len(got["rounds"]) == SMALL["rounds"]
    for g, w in zip(got["rounds"], want["rounds"]):
        assert g["rows_absorbed"] == w["rows_absorbed"]
        assert g["var_finite"]
        assert g["rmse"] < 0.1
        # the same posterior mean to the 1e-3 serving gate moves the rmse by
        # far less than 1e-3
        assert abs(g["rmse"] - w["rmse"]) < 1e-3
    gp = got["gp"]
    X, y, Xs, _ = t_make(SMALL["n_train"] + SMALL["rounds"] * SMALL["update_size"],
                         2, seed=0, device="cpu")
    assert np.isfinite(float(gp.nlml(X, y)))


def test_microbatched_mean_var_pads_the_tail():
    out = t_serve_mod.serve_gp(backend="pallas", device="cpu", **{**SMALL, "rounds": 1})
    gp = out["gp"]
    Xq = torch.rand(45, 2) * 2 - 1
    mu, var, times = t_serve_mod.microbatched_mean_var(gp, Xq, microbatch=16)
    assert mu.shape == (45,) and var.shape == (45,) and len(times) == 3
    mu_all, var_all = gp.mean_var(Xq)
    np.testing.assert_allclose(mu, nn(mu_all), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var, nn(var_all), rtol=1e-5, atol=1e-7)


def test_cli_runs_on_cpu(capsys):
    t_serve_mod.main(["--backend", "pallas", "--device", "cpu", "--n-train", "128",
                      "--n", "4", "--rounds", "1", "--update-size", "2",
                      "--queries", "32", "--microbatch", "16"])
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["M"] == 16 and out["device"] == "cpu" and len(out["rounds"]) == 1
