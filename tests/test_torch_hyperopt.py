"""The differentiable NLML (``core/fagp.py::_MomentsDiff``, ``_nlml_core``),
AdamW (``optim/adamw.py``), the lane engine (``optim/gp_hyperopt.py``) and
``GP.optimize`` of the port against the JAX package, on the CPU.

The same numpy inputs go to both packages, the JAX side on its ``jnp``
backend and on ``pallas`` in interpret mode, the port on CPU tensors (the
kernels' plain versions).  Gates are the JAX package's own:

* gradients: tests/test_gp_hyperopt.py:100-128 (rtol 1e-3, atol 1e-2);
* the Hermite value between the port's two backends: the same test's
  rtol 1e-4, a gate between two lowerings of one float32 arithmetic (the
  two backends share the recurrence and give the same bits here);
* the RFF value between the port's backends, and every value across the
  two packages: tests/test_expansions.py:187 (1e-2 of max(1, |nlml|)),
  the JAX package's gate between float32 paths that round differently.
  The rtol 1e-4 gate does not hold there: on these inputs the JAX
  package's own two backends differ by up to 1.6 times it for RFF, and
  each package's float32 NLML sits 1e-4 to 5e-4 from a float64
  evaluation of the same NLML (ROADMAP.md §C, C5);
* multi-output y on the pallas backend is held against the JAX package's
  jnp backend: the JAX pallas hook passes (N, T) targets to a kernel that
  takes (N,) and returns a wrong value (ROADMAP.md §C, C6);
* optimize-then-fit: tests/test_gp_hyperopt.py:276-278 (final NLML per
  row, rtol 1e-3) and :313-316 (posterior, rtol 5e-3, atol 2e-4).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from test_torch_common import gp_data, nn, specs, tt  # noqa: E402

from repro.core import fagp as jfagp  # noqa: E402
from repro.core.gp import GP as JGP  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import gp_hyperopt as jgh  # noqa: E402
from repro_torch.core import fagp as tfagp  # noqa: E402
from repro_torch.core.gp import GP  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import gp_hyperopt as tgh  # noqa: E402

EXPANSIONS = ["hermite", "rff_se", "rff_matern52"]
BACKENDS = ["jnp", "pallas"]
GRAD = dict(rtol=1e-3, atol=1e-2)           # tests/test_gp_hyperopt.py:104, :126


def _nlml_tol(want):
    # tests/test_expansions.py:187
    return 1e-2 * max(1.0, abs(want))


def _problem(N=200, seed=3, tasks=None, ragged=False):
    """Eq. 21 data (X, y, mask) as numpy; ``tasks`` columns of y (each a
    shifted copy of the target, so the tasks differ), ``ragged`` drops
    every fourth row by the mask."""
    X, y = gp_data(N, 2, seed)
    if tasks is not None:
        y = np.stack([y + 0.3 * t for t in range(tasks)], axis=1).astype(np.float32)
    mask = np.ones(N, np.float32)
    if ragged:
        mask[1::4] = 0.0
    return X, y, mask


def _specs(expansion, backend, **kw):
    return specs(expansion, 2, n=kw.pop("n", 6), num_features=16, backend=backend, **kw)


def _jax_value_grad(js, X, y, mask, le):
    def loss(le):
        return jfagp.nlml(jnp.asarray(X), jnp.asarray(y),
                          dataclasses.replace(js, eps=jnp.exp(le)), mask=jnp.asarray(mask))

    v, g = jax.value_and_grad(loss)(jnp.asarray(le))
    return float(v), np.asarray(g)


def _port_value_grad(ts, X, y, mask, le):
    le = tt(le).requires_grad_()
    v = tfagp.nlml(tt(X), tt(y), ts.replace(eps=torch.exp(le)), mask=tt(mask))
    g, = torch.autograd.grad(v, le)
    return float(v.detach()), nn(g)


# ---------------------------------------------------------------------------
# The differentiable NLML
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("wrt", ["X", "y", "mask"])
def test_data_cotangents_match_jax(backend, wrt):
    """d nlml / dX, dy and dmask through the streamed backward pass, against
    jax.grad of the JAX package's nlml on the same backend (the data of
    tests/test_gp_hyperopt.py:72-106: N = 80, n = 5; a ragged mask)."""
    X, y, mask = _problem(N=80, seed=0, ragged=True)
    js, ts = _specs("hermite", backend, n=5)
    arg = {"X": 0, "y": 1, "mask": 2}[wrt]
    want = jax.grad(lambda *a: jfagp.nlml(a[0], a[1], js, mask=a[2]), argnums=arg)(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask))
    leaves = [tt(X), tt(y), tt(mask)]
    leaves[arg].requires_grad_()
    got, = torch.autograd.grad(tfagp.nlml(leaves[0], leaves[1], ts, mask=leaves[2]),
                               leaves[arg])
    np.testing.assert_allclose(nn(got), np.asarray(want), **GRAD)
    if wrt != "mask":
        # masked rows contribute nothing, so their cotangents are zero
        assert not nn(got)[mask == 0].any()


@pytest.mark.parametrize("expansion", EXPANSIONS)
@pytest.mark.parametrize("tasks", [None, 2])
@pytest.mark.parametrize("ragged", [False, True])
def test_port_backends_agree_value_and_grad(expansion, tasks, ragged):
    """tests/test_gp_hyperopt.py:108-128 on the port: the pallas backend
    takes its value from the fused fit, the jnp backend from the block
    scan; the gradient in log eps is the streamed backward pass on both."""
    X, y, mask = _problem(tasks=tasks, ragged=ragged)
    out = {}
    for backend in BACKENDS:
        _, ts = _specs(expansion, backend)
        out[backend] = _port_value_grad(ts, X, y, mask, np.zeros(2, np.float32))
    want = out["jnp"][0]
    if expansion == "hermite":
        np.testing.assert_allclose(out["pallas"][0], want, rtol=1e-4)
    else:
        # the JAX package's own two backends on these inputs, in units of
        # the rtol 1e-4 gate (C5; multi-output: C6)
        js = {be: _specs(expansion, be)[0] for be in BACKENDS}
        jv = [float(jfagp.nlml(jnp.asarray(X), jnp.asarray(y), js[be], mask=jnp.asarray(mask)))
              for be in BACKENDS]
        print(f"value / 1e-4, pallas from jnp: port "
              f"{abs(out['pallas'][0] - want) / (1e-4 * abs(want)):.2f}, JAX "
              f"{abs(jv[1] - jv[0]) / (1e-4 * abs(jv[0])):.2f}")
        assert abs(out["pallas"][0] - want) < _nlml_tol(want), (out["pallas"][0], want)
    np.testing.assert_allclose(out["pallas"][1], out["jnp"][1], **GRAD)


def _f64_spec_leaves(spec, asarray):
    """The spec's hyperparameter leaves (and omega) as float64 through
    ``asarray``, on the jnp backend: the fused-fit kernel of the pallas
    backend is float32 in both packages, so a float64 evaluation of either
    backend's NLML is the jnp backend's."""
    return dict(eps=asarray(spec.eps), rho=asarray(spec.rho), noise=asarray(spec.noise),
                omega=None if spec.omega is None else asarray(spec.omega), backend="jnp")


def _jax_value_grad64(js, X, y, mask, le):
    with jax.enable_x64(True):
        f64 = lambda a: jnp.asarray(np.asarray(a, np.float64))  # noqa: E731
        js64 = dataclasses.replace(js, **_f64_spec_leaves(js, f64))

        def loss(le):
            return jfagp._nlml_core(f64(X), f64(y), dataclasses.replace(js64, eps=jnp.exp(le)),
                                    f64(mask))

        v, g = jax.value_and_grad(loss)(f64(le))
        assert v.dtype == jnp.float64
        return float(v), np.asarray(g)


def _port_value_grad64(ts, X, y, mask, le):
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    le = f64(le).requires_grad_()
    sp = ts.replace(**_f64_spec_leaves(ts, lambda t: t.detach().double()))
    v = tfagp._nlml_core(f64(X), f64(y), sp.replace(eps=torch.exp(le)), f64(mask))
    assert v.dtype == torch.float64
    g, = torch.autograd.grad(v, le)
    return float(v.detach()), nn(g)


def _in_grad_gates(got, want):
    """Largest |got - want| in units of the GRAD gate (<= 1 passes)."""
    return float(np.max(np.abs(got - want) / (GRAD["atol"] + GRAD["rtol"] * np.abs(want))))


@pytest.mark.parametrize("expansion", EXPANSIONS)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("tasks", [None, 2])
@pytest.mark.parametrize("ragged", [False, True])
def test_value_and_grad_match_jax(expansion, backend, tasks, ragged):
    """Each backend's NLML and its gradient in log eps against the JAX
    package's on the same inputs (tests/test_gp_hyperopt.py:108-128's
    data: N = 200, seed 3, n = 6, at log eps = 0).

    Port against JAX in float64 on both sides (jnp backend: the pallas
    backend's kernel is float32 in both packages), at the NLML gate, the
    tighter rtol 1e-4 and the gradient gate: in float32 the two packages'
    gradients sit up to 2.4 gates apart on some CPUs, each package's own
    float32 rounding, not a difference of the arithmetic.  Then each
    package's float32 value and gradient, on the backend under test,
    against that float64 value: the value at the NLML gate (its distance
    in units of rtol 1e-4 is printed, C5), the gradient at the gradient
    gate wherever the JAX package's own float32 gradient meets it on these
    inputs, and printed where it does not."""
    X, y, mask = _problem(tasks=tasks, ragged=ragged)
    js, ts = _specs(expansion, backend)
    if tasks is not None:
        js = js.replace(backend="jnp")       # ROADMAP.md §C, C6
    le = np.zeros(2, np.float32)
    want64_v, want64_g = _jax_value_grad64(js, X, y, mask, le)
    got64_v, got64_g = _port_value_grad64(ts, X, y, mask, le)
    assert abs(got64_v - want64_v) < _nlml_tol(want64_v), (got64_v, want64_v)
    np.testing.assert_allclose(got64_v, want64_v, rtol=1e-4)
    np.testing.assert_allclose(got64_g, want64_g, **GRAD)

    want_v, want_g = _jax_value_grad(js, X, y, mask, le)
    got_v, got_g = _port_value_grad(ts, X, y, mask, le)
    gates = {"port": _in_grad_gates(got_g, want64_g), "JAX": _in_grad_gates(want_g, want64_g)}
    print(f"float32 from float64: value / 1e-4: port {abs(got_v - want64_v) / (1e-4 * abs(want64_v)):.2f}, "
          f"JAX {abs(want_v - want64_v) / (1e-4 * abs(want64_v)):.2f}; gradient / gate: port "
          f"{gates['port']:.3f}, JAX {gates['JAX']:.3f}; float64 port from JAX: value "
          f"{abs(got64_v - want64_v) / abs(want64_v):.1e} rel, gradient "
          f"{_in_grad_gates(got64_g, want64_g):.1e} gates")
    for v in (got_v, want_v):
        assert abs(v - want64_v) < _nlml_tol(want64_v), (v, want64_v)
    if gates["JAX"] <= 1.0:
        np.testing.assert_allclose(got_g, want64_g, **GRAD)


@pytest.mark.parametrize("expansion", EXPANSIONS)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("tasks", [None, 2])
def test_moments_vjp_matches_jax(expansion, backend, tasks):
    """The backward pass itself, into every input it serves: the VJP of the
    moments (G, b) for a cotangent (Gbar, bbar), Gbar not symmetric,
    against the JAX package's custom VJP (``fagp._moments_diff``) on the
    same backend: eps, rho and omega, and X, y and mask.  The contraction
    is linear in the features, so the gradient gate holds here for every
    leaf; through the NLML's Cholesky the natural-space noise and omega
    gradients of both packages sit outside it from a float64 evaluation
    (ROADMAP.md §C, C5)."""
    X, y, mask = _problem(N=120, tasks=tasks, ragged=True)
    js, ts = _specs(expansion, backend, block_rows=32)
    if tasks is not None:
        js = js.replace(backend="jnp")       # ROADMAP.md §C, C6
    M = ts.n_features()
    rng = np.random.default_rng(11)
    Gbar = rng.standard_normal((M, M)).astype(np.float32)
    bbar = rng.standard_normal((M,) if tasks is None else (M, tasks)).astype(np.float32)
    _, vjp = jax.vjp(jfagp._moments_diff, js, jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask))
    jspec, jX, jy, jm = vjp((jnp.asarray(Gbar), jnp.asarray(bbar)))
    names = ("eps", "rho") + (("omega",) if expansion != "hermite" else ())
    leaves = {f: getattr(ts, f).clone().requires_grad_() for f in names}
    data = [tt(a).requires_grad_() for a in (X, y, mask)]
    sp = ts.replace(**leaves)
    G, b = tfagp._MomentsDiff.apply(sp.eps, sp.rho, sp.noise, sp.omega, *data, sp)
    got = torch.autograd.grad((G, b), [leaves[f] for f in names] + data, (tt(Gbar), tt(bbar)))
    want = [getattr(jspec, f) for f in names] + [jX, jy, jm]
    for name, g, w in zip(names + ("X", "y", "mask"), got, want):
        np.testing.assert_allclose(nn(g), np.asarray(w), **GRAD, err_msg=name)


def _direct_nlml(X, y, mask, spec):
    """The same NLML with the whole masked feature matrix in memory and
    plain autograd through it: the oracle of the streamed backward pass."""
    from repro_torch.core.expansions import get_expansion

    exp = get_expansion(spec.expansion)
    idx = tfagp._idx_tensor(spec)
    Phi = exp.features(X, idx, spec) * mask[:, None]
    yw = mask[:, None] * y if y.ndim == 2 else mask * y
    d = torch.exp(0.5 * exp.log_eigenvalues(idx, spec))
    s2 = spec.noise**2
    B = torch.eye(d.shape[0], dtype=X.dtype) + d[:, None] * (Phi.T @ Phi) * d[None, :] / s2
    L = torch.linalg.cholesky(B)
    bs = (d[:, None] if y.ndim == 2 else d) * (Phi.T @ yw) / s2
    w = torch.cholesky_solve(bs[:, None] if bs.ndim == 1 else bs, L)
    T = 1 if y.ndim == 1 else y.shape[1]
    n = mask.sum()
    return 0.5 * (torch.sum(yw * y) / s2 - torch.sum(bs * w.reshape(bs.shape))
                  + T * (2.0 * torch.log(torch.diagonal(L)).sum() + n * torch.log(s2)
                         + n * np.log(2.0 * np.pi)))


@pytest.mark.parametrize("expansion", EXPANSIONS)
@pytest.mark.parametrize("tasks", [None, 2])
def test_float64_streamed_backward_equals_direct_autograd(expansion, tasks):
    """In float64, where rounding no longer hides it, the streamed backward
    pass (jnp backend, 32-row blocks, a ragged mask) equals plain autograd
    through the whole feature matrix, for every leaf: log eps, log rho,
    log noise, omega, X, y and mask (rtol 1e-9)."""
    X, y, mask = _problem(N=96, tasks=tasks, ragged=True)
    _, ts = _specs(expansion, "jnp", block_rows=32)
    names = ("eps", "rho", "noise") + (("omega",) if expansion != "hermite" else ())
    out = []
    for fn in (lambda *a: tfagp._nlml_core(*a[:3], a[3]), _direct_nlml):
        logs = {f: torch.log(getattr(ts, f).double()).requires_grad_()
                for f in ("eps", "rho", "noise")}
        leaves = dict(logs)
        if expansion != "hermite":
            leaves["omega"] = ts.omega.double().requires_grad_()
        sp = ts.replace(**{f: torch.exp(logs[f]) for f in logs}, omega=leaves.get("omega"))
        data = [torch.from_numpy(a).double().requires_grad_() for a in (X, y, mask)]
        if fn is _direct_nlml:
            v = fn(data[0], data[1], data[2], sp)
        else:
            v = fn(data[0], data[1], sp, data[2])
        inputs = [leaves[f] for f in names] + data
        grads = torch.autograd.grad(v, inputs, allow_unused=True)   # RFF: rho unused
        out.append([v] + [torch.zeros_like(t) if g is None else g for g, t in zip(grads, inputs)])
    for name, a, b in zip(("value",) + names + ("X", "y", "mask"), *out):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-9,
                                   atol=1e-9, err_msg=name)


class _Numels(TorchDispatchMode):
    """Records the element count (and the shape) of every operator's
    output."""

    def __init__(self):
        super().__init__()
        self.numels = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.numels.append((t.numel(), str(func), tuple(t.shape)))
        return out


N_SWEEP = 600


def _value_and_backward(ts, X, y):
    le = torch.zeros(2, requires_grad=True)
    mask = torch.ones(X.shape[0])
    v = tfagp._nlml_core(X, y, ts.replace(eps=torch.exp(le)), mask)
    v.backward()
    return le.grad


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("expansion", EXPANSIONS)
def test_value_and_backward_hold_no_nxm_buffer(expansion, backend):
    """The port's form of the jaxpr sweep (tests/test_gp_hyperopt.py:141-152):
    no operator of one value-and-backward pass outputs N * M elements or
    more (N = 600, block_rows = 64, n = 6, p = 2)."""
    X, y = gp_data(N_SWEEP, 2, 0)
    _, ts = specs(expansion, 2, n=6, num_features=16, backend=backend, block_rows=64)
    M = ts.n_features()
    with _Numels() as rec:
        g = _value_and_backward(ts, tt(X), tt(y))
    assert np.all(np.isfinite(nn(g)))
    biggest = max(rec.numels)
    assert biggest[0] < N_SWEEP * M, biggest


def test_sweep_catches_a_materialized_phi():
    """The recorder itself: the full feature map trips it."""
    X, _ = gp_data(N_SWEEP, 2, 0)
    _, ts = specs("hermite", 2, n=6)
    with _Numels() as rec:
        tfagp.build_features(tt(X), ts)
    assert max(rec.numels)[0] >= N_SWEEP * ts.n_features()


def test_pallas_value_runs_the_fused_fit(monkeypatch):
    """The pallas backend's value reaches the fused fit's wrapper with
    scale=False, once a call; the backward pass never does."""
    calls = []
    orig = tfagp.ops.fused_fit_moments

    def spy(*a, **kw):
        calls.append(kw.get("scale", True))
        return orig(*a, **kw)

    monkeypatch.setattr(tfagp.ops, "fused_fit_moments", spy)
    X, y = gp_data(N_SWEEP, 2, 0)
    _, ts = specs("hermite", 2, n=6, backend="pallas", block_rows=64)
    _value_and_backward(ts, tt(X), tt(y))
    assert calls == [False]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip_norm", [None, 0.5])
def test_adamw_matches_jax(clip_norm):
    rng = np.random.default_rng(0)
    shapes = {"w": (3, 4), "b": (5,), "s": ()}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jcfg = jadamw.AdamWConfig(lr=1e-2, clip_norm=clip_norm)
    tcfg = tadamw.AdamWConfig(lr=1e-2, clip_norm=clip_norm)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: tt(v) for k, v in params.items()}
    js, ts = jadamw.init(jp, jcfg), tadamw.init(tp, tcfg)
    for _ in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        jp, js, jm = jadamw.apply_updates(jp, {k: jnp.asarray(v) for k, v in grads.items()},
                                          js, jcfg)
        tp, ts, tm = tadamw.apply_updates(tp, {k: tt(v) for k, v in grads.items()}, ts, tcfg)
    for k in shapes:
        np.testing.assert_allclose(nn(tp[k]), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        for m in ("m", "v"):
            np.testing.assert_allclose(nn(ts["mu"][k][m]), np.asarray(js["mu"][k][m]),
                                       rtol=1e-6, atol=1e-7)
    assert int(ts["step"]) == int(js["step"]) == 3
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# The lane engine
# ---------------------------------------------------------------------------

B, N_LANE, R = 3, 16, 2


def _fleet(B=B, N=N_LANE, seed=0):
    Xb = np.stack([gp_data(N, 2, seed + s)[0] for s in range(B)])
    yb = np.stack([gp_data(N, 2, seed + s)[1] for s in range(B)])
    return Xb, yb


def _lane_setup(backend="jnp"):
    """tests/test_gp_hyperopt.py:168-177: JAX's lanes and their port copy."""
    Xb, yb = _fleet()
    js, ts = _specs("hermite", backend, n=5, block_rows=N_LANE)
    hp = jgh._init_lanes(js, B, R, 0, 0.3, None)
    return Xb, yb, js, ts, hp


def _port_data(Xb, yb, mask=None):
    mask = np.ones(Xb.shape[:2], np.float32) if mask is None else mask
    return [(tt(Xb[t]), tt(yb[t]), tt(mask[t])) for t in range(Xb.shape[0])]


def _port_step(hp, ts, data, frozen=None, ostate=None):
    cfg = tadamw.AdamWConfig(lr=5e-2, weight_decay=0.0, clip_norm=None)
    ostate = tadamw.init(hp, cfg) if ostate is None else ostate
    frozen = torch.zeros((B, R), dtype=torch.bool) if frozen is None else frozen
    prev = torch.full((B, R), float("inf"))
    return tgh._lane_step(hp, ostate, frozen, prev, data, ts, float("-inf"), cfg)


@pytest.mark.parametrize("backend", BACKENDS)
def test_one_lane_step_matches_jax(backend):
    """From the JAX package's own lanes: the losses at the input parameters,
    and the parameters after one AdamW step (atol 1e-5).  Adam's first step
    moves a log-space parameter by lr times the sign of its gradient, so a
    component whose JAX gradient lies within the gradient gate (atol 1e-2)
    of zero is exempt: its sign is not fixed by that gate."""
    Xb, yb, js, ts, hp = _lane_setup(backend)
    ocfg = jadamw.AdamWConfig(lr=5e-2, weight_decay=0.0, clip_norm=None)
    idx = jnp.asarray(js.indices(2))
    mask = jnp.ones((B, N_LANE), jnp.float32)
    jhp, _, _, _, jvals = jgh._lane_step(
        hp, jadamw.init(hp, ocfg), jnp.zeros((B, R), bool), jnp.full((B, R), jnp.inf),
        jnp.asarray(Xb), jnp.asarray(yb), mask, js, idx, jnp.float32(-jnp.inf), ocfg)
    grads = jax.vmap(jax.vmap(jax.grad(jgh._lane_loss), in_axes=(0, None, None, None, None, None)),
                     in_axes=(0, 0, 0, 0, None, None))(hp, jnp.asarray(Xb), jnp.asarray(yb),
                                                       mask, js, idx)
    thp, _, _, _, tvals = _port_step({f: tt(v) for f, v in hp.items()}, ts, _port_data(Xb, yb))
    # the lane loss is the NLML per row: its gate is on the NLML (x N rows)
    for got, want in zip(nn(tvals).ravel() * N_LANE, np.asarray(jvals).ravel() * N_LANE):
        assert abs(got - want) < _nlml_tol(want), (got, want)
    exempt = 0
    for f in tgh._FIELDS:
        near0 = np.abs(np.asarray(grads[f])) <= GRAD["atol"]
        exempt += int(near0.sum())
        diff = np.abs(nn(thp[f]) - np.asarray(jhp[f]))
        assert (diff[~near0] <= 1e-5).all(), (f, diff.max())
    total = sum(np.asarray(hp[f]).size for f in tgh._FIELDS)
    print(f"one lane step: {exempt} of {total} components exempt")
    assert exempt < total


def _jax_lanes64(hp, Xb, yb, js, steps):
    """JAX's lane engine (``_lane_step``, ``_lane_values``) from the lanes
    ``hp`` with the NLML and its gradient in float64 (AdamW keeps its
    float32 update in both packages).  Returns (hp, final NLML per row)."""
    with jax.enable_x64(True):
        f64 = lambda a: jnp.asarray(np.asarray(a, np.float64))  # noqa: E731
        js64 = dataclasses.replace(js, **_f64_spec_leaves(js, f64))
        idx = jnp.asarray(js64.indices(2))
        hp = {f: f64(v) for f, v in hp.items()}
        Xb, yb, mask = f64(Xb), f64(yb), jnp.ones(Xb.shape[:2], jnp.float64)
        ocfg = jadamw.AdamWConfig(lr=5e-2, weight_decay=0.0, clip_norm=None)
        ostate = jadamw.init(hp, ocfg)
        frozen = jnp.zeros((B, R), bool)
        prev = jnp.full((B, R), jnp.inf, jnp.float64)
        for _ in range(steps):
            hp, ostate, frozen, prev, _ = jgh._lane_step(
                hp, ostate, frozen, prev, Xb, yb, mask, js64, idx, jnp.float64(-jnp.inf), ocfg)
        final = jgh._lane_values(hp, Xb, yb, mask, js64, idx)
        assert final.dtype == jnp.float64
        return {f: np.asarray(v) for f, v in hp.items()}, np.asarray(final)


def _port_lanes64(hp, Xb, yb, ts, steps):
    """The port's ``_lane_step`` / ``_lane_values`` as ``_jax_lanes64``."""
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    sp = ts.replace(**_f64_spec_leaves(ts, lambda t: t.detach().double()))
    hp = {f: f64(v) for f, v in hp.items()}
    data = [(f64(Xb[t]), f64(yb[t]), torch.ones(Xb.shape[1], dtype=torch.float64))
            for t in range(Xb.shape[0])]
    ocfg = tadamw.AdamWConfig(lr=5e-2, weight_decay=0.0, clip_norm=None)
    ostate = tadamw.init(hp, ocfg)
    frozen = torch.zeros((B, R), dtype=torch.bool)
    prev = torch.full((B, R), float("inf"), dtype=torch.float64)
    for _ in range(steps):
        hp, ostate, frozen, prev, _ = tgh._lane_step(hp, ostate, frozen, prev, data, sp,
                                                     float("-inf"), ocfg)
    final = tgh._lane_values(hp, data, sp)
    assert final.dtype == torch.float64
    return {f: nn(v) for f, v in hp.items()}, nn(final)


def _best_hypers(hp, final, t):
    """Tenant t's hyperparameters at its best lane, as float32 numpy."""
    r = int(np.argmin(final[t]))
    return {f[4:]: np.exp(np.asarray(hp[f][t, r], np.float64)).astype(np.float32)
            for f in tgh._FIELDS}


@pytest.mark.parametrize("backend", BACKENDS)
def test_eight_steps_match_jax(backend):
    """8 steps from JAX's lanes.  Port against JAX with the NLML and its
    gradient in float64 on both sides (jnp backend, as
    ``test_value_and_grad_match_jax``): each lane's final NLML per row
    (rtol 1e-3, tests/test_gp_hyperopt.py:276-278), and the posterior of
    each tenant's GP fitted at the two packages' learned hyperparameters
    (rtol 5e-3, atol 2e-4, :313-316).  Then each package's float32 run on
    the backend under test against the float64 run, at the same gates
    wherever the JAX package's own float32 run meets them, printed where it
    does not.  The JAX package has no gate on the learned hyperparameters
    across implementations: their largest gap is printed."""
    Xb, yb, js, ts, hp = _lane_setup(backend)
    jhp64, jfinal64 = _jax_lanes64(hp, Xb, yb, js, 8)
    thp64, tfinal64 = _port_lanes64(hp, Xb, yb, ts, 8)
    np.testing.assert_allclose(tfinal64, jfinal64, rtol=1e-3)
    gap = max(float(np.abs(np.exp(thp64[f]) - np.exp(jhp64[f])).max()) for f in tgh._FIELDS)
    print(f"float64: largest gap in the learned hyperparameters {gap:.3e}, in the final "
          f"NLML per row {float(np.abs(tfinal64 / jfinal64 - 1).max()):.1e} rel")
    Xq = np.random.default_rng(1).uniform(-1, 1, (32, 2)).astype(np.float32)

    def posterior(t, jh, th):
        jm, jv = JGP.fit(jnp.asarray(Xb[t]), jnp.asarray(yb[t]),
                         js.replace(**{f: jnp.asarray(v) for f, v in jh.items()})
                         ).mean_var(jnp.asarray(Xq))
        tm, tv = GP.fit(tt(Xb[t]), tt(yb[t]), ts.replace(**{f: tt(v) for f, v in th.items()})
                        ).mean_var(tt(Xq))
        return (np.asarray(jm), np.asarray(jv)), (nn(tm), nn(tv))

    for t in range(B):
        (m1, v1), (m2, v2) = posterior(t, _best_hypers(jhp64, jfinal64, t),
                                       _best_hypers(thp64, tfinal64, t))
        np.testing.assert_allclose(m2, m1, rtol=5e-3, atol=2e-4)
        np.testing.assert_allclose(v2, v1, rtol=5e-3, atol=2e-4)

    want = jgh.optimize_fleet(jnp.asarray(Xb), jnp.asarray(yb), js, restarts=R, steps=8, seed=0)
    got = tgh._run_lanes({f: np.asarray(v) for f, v in hp.items()}, tt(Xb), tt(yb),
                         torch.ones(B, N_LANE), ts, steps=8, lr=5e-2, tol=None, callback=None)
    rel = {"port": np.abs(nn(got.lane_nlml) / jfinal64 - 1).max(),
           "JAX": np.abs(np.asarray(want.lane_nlml) / jfinal64 - 1).max()}
    print(f"float32 final NLML per row from float64: port {rel['port']:.1e}, "
          f"JAX {rel['JAX']:.1e} rel (gate 1e-3)")
    if rel["JAX"] <= 1e-3:
        np.testing.assert_allclose(nn(got.lane_nlml), jfinal64, rtol=1e-3)
    for t in range(B):
        h32 = {f: nn(getattr(got, f)[t]) for f in ("eps", "rho", "noise")}
        j32 = {f: np.asarray(getattr(want, f)[t]) for f in ("eps", "rho", "noise")}
        (jm64, jv64), (tm64, tv64) = posterior(t, _best_hypers(jhp64, jfinal64, t),
                                               _best_hypers(thp64, tfinal64, t))
        (jm, jv), (tm, tv) = posterior(t, j32, h32)
        jax_ok = (np.allclose(jm, jm64, rtol=5e-3, atol=2e-4)
                  and np.allclose(jv, jv64, rtol=5e-3, atol=2e-4))
        print(f"tenant {t}: float32 posterior from float64 max |mean| gap: port "
              f"{np.abs(tm - tm64).max():.1e}, JAX {np.abs(jm - jm64).max():.1e}")
        if jax_ok:
            np.testing.assert_allclose(tm, tm64, rtol=5e-3, atol=2e-4)
            np.testing.assert_allclose(tv, tv64, rtol=5e-3, atol=2e-4)


def test_frozen_lanes_stop_moving_bitwise():
    """tests/test_gp_hyperopt.py:179-207: a frozen lane's parameters AND
    optimizer moments are carried through unchanged; live lanes move."""
    Xb, yb, _, ts, hp = _lane_setup()
    data = _port_data(Xb, yb)
    hp = {f: tt(v) for f, v in hp.items()}
    hp, ostate, *_ = _port_step(hp, ts, data)
    pattern = torch.tensor([[True, False], [False, True], [True, True]])
    hp2, ostate2, *_ = _port_step(hp, ts, data, frozen=pattern, ostate=ostate)
    pat = pattern.numpy()
    for f in hp:
        moved = (nn(hp2[f]) != nn(hp[f])).reshape(pat.shape + (-1,)).any(axis=-1)
        assert not moved[pat].any()
        assert moved[~pat].all()
        for k in ("m", "v"):
            m_moved = (nn(ostate2["mu"][f][k]) != nn(ostate["mu"][f][k]))
            assert not m_moved.reshape(pat.shape + (-1,)).any(axis=-1)[pat].any()


def test_tol_freezes_and_exits_early():
    Xb, yb = _fleet(B=2)
    _, ts = _specs("hermite", "jnp", n=5)
    res = tgh.optimize_fleet(tt(Xb), tt(yb), ts, restarts=2, steps=50, tol=1e9, seed=0)
    assert res.steps_run < 50
    assert res.frozen.all()


def test_restart_selection_follows_final_nlml():
    Xb, yb = _fleet(B=2)
    _, ts = _specs("hermite", "jnp", n=5)
    res = tgh.optimize_fleet(tt(Xb), tt(yb), ts, restarts=3, steps=5, seed=1)
    lane = nn(res.lane_nlml)
    np.testing.assert_array_equal(nn(res.best_restart), lane.argmin(axis=1))
    np.testing.assert_array_equal(nn(res.nlml), lane.min(axis=1))
    assert res.eps.shape == (2, 2) and res.noise.shape == (2,)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fleet_equals_loop_of_singles_bitwise(backend):
    """tests/test_gp_hyperopt.py:247-265: every lane runs the same per-lane
    program, so a fleet of 4 equals 4 single-tenant runs bit for bit, with
    no padding."""
    Xb, yb = _fleet(B=4)
    _, ts = _specs("hermite", backend, n=5)
    res = tgh.optimize_fleet(tt(Xb), tt(yb), ts, restarts=2, steps=6, seed=2)
    for t in range(4):
        one = tgh.optimize_restarts(tt(Xb[t]), tt(yb[t]), ts, restarts=2, steps=6, seed=2)
        for f in ("eps", "rho", "noise", "nlml", "lane_nlml"):
            assert torch.equal(getattr(res, f)[t], getattr(one, f)[0]), f


def test_restart_jitter_keyed_by_seed_and_field():
    """Restart 0 is the spec; the others share one draw across tenants and
    differ between seeds."""
    _, ts = _specs("hermite", "jnp", n=5)
    a = tgh._init_lanes(ts, 3, 4, 7, 0.3, None)
    b = tgh._init_lanes(ts, 3, 4, 8, 0.3, None)
    for f in tgh._FIELDS:
        base = {"log_eps": torch.log(ts.eps), "log_rho": torch.log(ts.rho),
                "log_noise": torch.log(ts.noise)}[f]
        assert torch.equal(a[f][:, 0], base.expand_as(a[f][:, 0]))
        assert torch.equal(a[f][0], a[f][2])
        assert not torch.equal(a[f][:, 1:], b[f][:, 1:])


def test_gp_optimize_returns_the_best_lane_and_fits_it():
    """tests/test_gp_hyperopt.py:267-283: GP.optimize(restarts=3) returns
    the best lane's spec, and its state equals GP.fit at that spec."""
    X, y = gp_data(64, 2, 4)
    _, ts = _specs("hermite", "jnp", n=5)
    multi = tgh.optimize_restarts(tt(X), tt(y), ts, restarts=3, steps=8, seed=0)
    assert float(multi.nlml[0]) <= float(multi.lane_nlml[0, 0])
    seen = []
    gp = GP.optimize(tt(X), tt(y), ts, restarts=3, steps=8, seed=0,
                     callback=lambda step, v, sp: seen.append((step, v, sp)))
    best = multi.spec_for(ts, 0)
    for f in ("eps", "rho", "noise"):
        assert torch.equal(getattr(gp.spec, f), getattr(best, f)), f
    ref = GP.fit(tt(X), tt(y), best)
    for f in ("chol", "u", "b"):
        assert torch.equal(getattr(gp.state, f), getattr(ref.state, f)), f
    # the callback contract: (step, best lane's nlml per row, its spec)
    assert [s for s, _, _ in seen] == list(range(8))
    assert all(isinstance(v, float) and sp.p == 2 for _, v, sp in seen)


@pytest.mark.parametrize("backend", BACKENDS)
def test_gp_optimize_matches_jax(backend):
    """GP.optimize at restarts=1 (the lanes start at the spec in both
    packages), 8 steps, N = 64, p = 2: the final NLML per row and the
    posterior of the fitted GPs at 32 queries, at the JAX package's gates
    for the same run under another lowering."""
    X, y = gp_data(64, 2, 4)
    js, ts = _specs("hermite", backend, n=5)
    jr = jgh.optimize_restarts(jnp.asarray(X), jnp.asarray(y), js, restarts=1, steps=8)
    tr = tgh.optimize_restarts(tt(X), tt(y), ts, restarts=1, steps=8)
    np.testing.assert_allclose(nn(tr.nlml), np.asarray(jr.nlml), rtol=1e-3)
    jgp = JGP.optimize(jnp.asarray(X), jnp.asarray(y), js, steps=8)
    tgp = GP.optimize(tt(X), tt(y), ts, steps=8)
    Xq = np.random.default_rng(5).uniform(-1, 1, (32, 2)).astype(np.float32)
    m1, v1 = jgp.mean_var(jnp.asarray(Xq))
    m2, v2 = tgp.mean_var(tt(Xq))
    np.testing.assert_allclose(nn(m2), np.asarray(m1), rtol=5e-3, atol=2e-4)
    np.testing.assert_allclose(nn(v2), np.asarray(v1), rtol=5e-3, atol=2e-4)


def test_session_fit_optimize_serve_update_nlml_matches_jax():
    """The slice as a whole on the pallas backend: fit, GP.optimize,
    mean_var, update, nlml, against the same JAX session at the serving
    gates (tests/test_kernels.py:168: mean rtol 1e-3, atol 1e-4; variance
    rtol 2e-3, atol 1e-5) and the NLML gate."""
    X, y = gp_data(96, 2, 6)
    Xn, yn = gp_data(8, 2, 7)
    Xq = np.random.default_rng(8).uniform(-1, 1, (40, 2)).astype(np.float32)
    js, ts = _specs("hermite", "pallas", n=5)
    jgp = JGP.fit(jnp.asarray(X), jnp.asarray(y), js)
    tgp = GP.fit(tt(X), tt(y), ts)
    jgp = JGP.optimize(jnp.asarray(X), jnp.asarray(y), jgp.spec, steps=8)
    tgp = GP.optimize(tt(X), tt(y), tgp.spec, steps=8)
    for jg, tg in ((jgp, tgp),
                   (jgp.update(jnp.asarray(Xn), jnp.asarray(yn)), tgp.update(tt(Xn), tt(yn)))):
        m1, v1 = jg.mean_var(jnp.asarray(Xq))
        m2, v2 = tg.mean_var(tt(Xq))
        np.testing.assert_allclose(nn(m2), np.asarray(m1), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(nn(v2), np.asarray(v1), rtol=2e-3, atol=1e-5)
    want = float(jgp.nlml(jnp.asarray(X), jnp.asarray(y)))
    got = float(tgp.nlml(tt(X), tt(y)))
    assert abs(got - want) < _nlml_tol(want)
