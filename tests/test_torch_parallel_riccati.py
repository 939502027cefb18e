"""The port's associative-scan backward pass (``ops/parallel_riccati.py``)
against its serial pass and the JAX package's ``parallel_back_pass``, in
float64 on the CPU (``tests/test_parallel_riccati.py`` in the port).

Both packages see the same step-major bundle (JAX's ``calc_derivs``,
converted lane by lane), so the passes are compared alone:

* the random LQ problem of the JAX test, three lanes, at lambda 0 (equal
  to the serial pass, JAX's rtol 1e-9) and 0.3 (the regularization fold:
  close to the serial pass, both descent directions), and against JAX's
  parallel pass at both;
* the Brachistochrone at n=200 against the serial pass and JAX's parallel
  pass (JAX's rtol 1e-7);
* a lane whose ``cuu`` is singular fails alone: the others equal a batch
  without it;
* a full Brachistochrone solve (n=100) with ``backpass_method="parallel"``
  through ``StepwiseSolver``, ``make_batched_solver``, ``solve`` and
  ``make_solver`` against JAX's parallel solve per lane;
* the JAX package's guards: ``ValueError`` naming ``parallel`` for a
  problem with ``h`` and for ``full_ddp=True``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_generator_tpu as jd
from ddp_generator_tpu.derivs import calc_derivs as j_calc_derivs
from ddp_generator_tpu.models import brachistochrone as jbr
from ddp_generator_tpu.ops.forward import forward_pass as j_forward_pass
from ddp_generator_tpu.ops.parallel_riccati import (
    parallel_back_pass as j_parallel_back_pass,
)
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.derivs import DerivBundle, FinalDerivs, StepDerivs
from ddp_generator_tpu_torch.models import brachistochrone as tbr
from ddp_generator_tpu_torch.models import car_parking as tcar
from ddp_generator_tpu_torch.ops.parallel_riccati import parallel_back_pass


def _t(a):
    return torch.as_tensor(np.array(a))


def _lq_problem(n_x=3, n_u=2, seed=0):
    """tests/test_parallel_riccati.py's random time-invariant LQ problem."""
    rng = np.random.default_rng(seed)
    Ad = np.eye(n_x) + 0.05 * rng.standard_normal((n_x, n_x))
    Bd = 0.1 * rng.standard_normal((n_x, n_u))
    Q, R = np.eye(n_x) * 0.5, np.eye(n_u) * 0.2
    S = 0.05 * rng.standard_normal((n_x, n_u))
    return jd.make_problem(
        n_x=n_x, n_u=n_u,
        f=lambda x, u, p, k: jnp.asarray(Ad) @ x + jnp.asarray(Bd) @ u,
        L=lambda x, u, p, k: 0.5 * x @ jnp.asarray(Q) @ x
        + 0.5 * u @ jnp.asarray(R) @ u + x @ jnp.asarray(S) @ u
        + 0.01 * jnp.sum(x) + 0.02 * jnp.sum(u),
        F=lambda x, p, k: jnp.sum(x ** 2), name="lq")


def _bundles(prob, x0s, u0s, p, w_pen_f=1.0):
    """JAX's rollout and bundle of every lane (vmapped), and the port's
    DerivBundle of the same numbers."""
    N, n_u = u0s.shape[1], u0s.shape[2]
    n_x = x0s.shape[1]
    e = jnp.zeros((N, 0))
    mu_fe = jnp.zeros(prob.n_hfe)

    def one(x0, u0):
        r = j_forward_pass(prob, x0, jnp.zeros((N + 1, n_x)), u0,
                           jnp.zeros((N, n_u)), jnp.zeros((N, n_u, n_x)),
                           jnp.zeros(()), p, e, e, mu_fe, jnp.zeros(0),
                           jnp.ones(()), jnp.asarray(w_pen_f))
        d = j_calc_derivs(prob, r.xs, r.us, p, e, e, mu_fe, jnp.zeros(0),
                          jnp.ones(()), jnp.asarray(w_pen_f), False)
        return r.us, d

    us, d = jax.jit(jax.vmap(one))(jnp.asarray(x0s), jnp.asarray(u0s))
    tb = DerivBundle(step=StepDerivs(*map(_t, d.step)),
                     final=FinalDerivs(*map(_t, d.final)), ok=_t(d.ok))
    return us, d, _t(us), tb


_J_PARALLEL = jax.jit(jax.vmap(lambda d_, u_, l_: j_parallel_back_pass(
    d_, u_, l_, 1)))


def _jax_parallel(d, us, lam):
    return _J_PARALLEL(d, us, jnp.asarray(lam))


def _lq_lanes(B=3, N=40):
    rng = np.random.default_rng(0)
    return rng.standard_normal((B, 3)), 0.1 * rng.standard_normal((B, N, 2))


@pytest.fixture(scope="module")
def lq():
    x0s, u0s = _lq_lanes()
    return _bundles(_lq_problem(), x0s, u0s, {})


@pytest.mark.parametrize("lam", [0.0, 0.3])
def test_matches_serial_and_jax_lq(lq, lam):
    jus, jdv, us, tb = lq
    lam_t = torch.full((us.shape[0],), lam, dtype=torch.float64)
    ser = td.back_pass(tb, us, lam_t, 1, False)
    par = parallel_back_pass(tb, us, lam_t, 1)
    assert not ser.failed.any() and not par.failed.any()
    if lam == 0.0:
        # identical recursions at lambda=0
        for name in ("l", "L", "dV", "g_norm"):
            np.testing.assert_allclose(getattr(par, name),
                                       getattr(ser, name), rtol=1e-9,
                                       atol=1e-10, err_msg=name)
    else:
        # lambda>0: regularization folded into the stage cost; directions
        # agree to regularization level, both descend
        np.testing.assert_allclose(par.l, ser.l, rtol=0.5, atol=0.05)
        assert (par.dV[:, 0] < 0).all() and (ser.dV[:, 0] < 0).all()
    ref = _jax_parallel(jdv, jus, np.full(us.shape[0], lam))
    np.testing.assert_array_equal(par.failed.numpy(), np.asarray(ref.failed))
    for name in ("l", "L", "dV", "g_norm"):
        np.testing.assert_allclose(getattr(par, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-10, err_msg=name)


def test_matches_serial_and_jax_brachistochrone():
    N = 200
    p, x0, u0 = jbr.default_setup(N)
    x0s = np.tile(x0, (2, 1))
    u0s = np.stack([u0, u0 * 1.1])
    jus, jdv, us, tb = _bundles(jbr.brachistochrone(), x0s, u0s, p, 40.0)
    lam = torch.zeros(2, dtype=torch.float64)
    ser = td.back_pass(tb, us, lam, 1, False)
    par = parallel_back_pass(tb, us, lam, 1)
    ref = _jax_parallel(jdv, jus, np.zeros(2))
    for other in (ser, ref):
        for name in ("l", "L"):
            np.testing.assert_allclose(
                getattr(par, name).numpy(), np.asarray(getattr(other, name)),
                rtol=1e-7, atol=1e-9, err_msg=name)
        np.testing.assert_allclose(par.g_norm.numpy(),
                                   np.asarray(other.g_norm), rtol=1e-8)


def test_singular_lane_fails_alone(lq):
    """One lane's ``cuu`` made singular at one step: that lane's scan is
    non-finite and it fails; the other lanes equal the pass without it."""
    _, _, us, tb = lq
    lam = torch.zeros(us.shape[0], dtype=torch.float64)
    cuu = tb.step.cuu.clone()
    cuu[1, 17] = torch.tensor([[1.0, 1.0], [1.0, 1.0]], dtype=torch.float64)
    bad = tb._replace(step=tb.step._replace(cuu=cuu))
    out = parallel_back_pass(bad, us, lam, 1)
    assert out.failed.tolist() == [False, True, False]
    keep = [0, 2]
    ref = parallel_back_pass(DerivBundle(
        step=StepDerivs(*(f[keep] for f in tb.step)),
        final=FinalDerivs(*(f[keep] for f in tb.final)), ok=tb.ok[keep]),
        us[keep], lam[keep], 1)
    for name in ("l", "L", "dV", "g_norm"):
        torch.testing.assert_close(getattr(out, name)[keep],
                                   getattr(ref, name), rtol=1e-12,
                                   atol=1e-14)


def _brachi_solve_inputs(B=3, n=100):
    p, x0, u0 = jbr.default_setup(n)
    x0s = np.tile(x0, (B, 1))
    u0s = u0[None] * np.linspace(0.9, 1.1, B)[:, None, None]
    return p, x0s, u0s


def _brachi_opts(pkg, **kw):
    return pkg.SolverOptions(max_iter=50, w_pen_init_f=40.0, w_pen_fact2=2.0,
                             full_ddp=False, backpass_method="parallel",
                             debug_level=0, **kw)


@pytest.fixture(scope="module")
def jax_parallel_solve():
    p, x0s, u0s = _brachi_solve_inputs()
    sol = jd.make_batched_solver(jbr.brachistochrone(), _brachi_opts(jd))(
        x0s, u0s, p)
    return jax.tree_util.tree_map(np.asarray, sol)


def _same(out, ref, lanes):
    for f in ("status", "iterations", "body_calls", "stale_calls",
              "success"):
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f)[lanes],
                                      err_msg=f)
    np.testing.assert_allclose(out.cost, ref.cost[lanes], rtol=1e-8)
    np.testing.assert_allclose(out.xs, ref.xs[lanes], rtol=0, atol=1e-7)


def test_full_solve_matches_jax_per_lane(jax_parallel_solve):
    ref = jax_parallel_solve
    p, x0s, u0s = _brachi_solve_inputs()
    assert ref.success.all()
    np.testing.assert_allclose(ref.xs[:, -1, 0], -4.0, atol=1e-5)
    step = td.to_numpy(td.StepwiseSolver(
        tbr.brachistochrone(), _brachi_opts(td, linesearch_method="kernel"),
        chunk=4, min_compact_batch=1, device="cpu")(x0s, u0s, p))
    _same(step, ref, slice(None))
    batched = td.to_numpy(td.make_batched_solver(
        tbr.brachistochrone(), _brachi_opts(td), device="cpu")(
            x0s[:2], u0s[:2], p))
    _same(batched, ref, slice(0, 2))
    one = td.to_numpy(td.solve(tbr.brachistochrone(), x0s[2], u0s[2], p,
                               _brachi_opts(td), device="cpu"))
    _same(one, ref, 2)
    again = td.to_numpy(td.make_solver(tbr.brachistochrone(),
                                       _brachi_opts(td), device="cpu")(
        x0s[2], u0s[2], p))
    for f in one._fields:
        np.testing.assert_array_equal(getattr(again, f), getattr(one, f))


@pytest.mark.parametrize("case", ["constrained", "full_ddp"])
def test_parallel_guards_raise(case):
    if case == "constrained":
        prob, opts = tcar.car_parking(), td.SolverOptions(
            backpass_method="parallel", full_ddp=False)
    else:
        prob, opts = tbr.brachistochrone(), td.SolverOptions(
            backpass_method="parallel", full_ddp=True)
    for make in (lambda: td.make_solver(prob, opts, device="cpu"),
                 lambda: td.StepwiseSolver(prob, opts, device="cpu")):
        with pytest.raises(ValueError, match="parallel"):
            make()
