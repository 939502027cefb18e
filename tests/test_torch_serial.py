"""The port's serial path against the JAX package's, float64 on the CPU.

* ``back_pass`` (``ops/backpass.py``) on the same step-major bundle as
  JAX's ``back_pass`` (the bundle JAX's ``calc_derivs`` emits at a
  CarParking trajectory, T=30, 6 lanes): regType 1 and 2, FULL_DDP on and
  off, lambdas from 1e-6 to 10, and one lane whose boxQP fails at step 15
  of 30 (its outputs zero from there back, its carry frozen);
* ``line_search`` (``ops/linesearch.py``) against JAX's on the same gains;
* ``batched_calc_derivs`` against JAX's ``calc_derivs`` (and
  ``calc_derivs`` against its lane);
* a default-options ``StepwiseSolver`` (serial backward pass and line
  search) against JAX's ``make_batched_solver`` per lane, with
  ``tests/test_torch_solver.py``'s checks;
* an ``n_u = 4`` toy problem, whose boxQP is the projected-Newton
  iteration, and MOD_CHOL on a retry-heavy CarParking solve, each against
  JAX per lane: status, iterations, body and stale calls equal, cost to
  rtol 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_generator_tpu as jd
from ddp_generator_tpu.derivs import calc_derivs as j_calc_derivs
from ddp_generator_tpu.models import car_parking as jcar
from ddp_generator_tpu.ops.backpass import back_pass as j_back_pass
from ddp_generator_tpu.ops.linesearch import line_search as j_line_search
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.derivs import DerivBundle, FinalDerivs, StepDerivs
from ddp_generator_tpu_torch.models import car_parking as tcar
from ddp_generator_tpu_torch.ops.forward import forward_pass
from test_torch_solver import _assert_matches_jax, _inputs

T, B = 30, 6
FAIL_LANE, FAIL_STEP = 1, 15
LAM = np.array([1e-6, 1e-3, 1e-2, 0.1, 1.0, 10.0])
COUNTS = ("status", "iterations", "body_calls", "stale_calls",
          "bp_retry_calls")


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def nominal():
    """A CarParking rollout of 6 lanes (the port's forward pass), float64."""
    p, x0, _ = tcar.default_setup(T=T)
    rng = np.random.default_rng(0)
    x0s = np.tile(x0, (B, 1)) + 0.05 * rng.standard_normal((B, 4))
    u0s = 0.4 * rng.standard_normal((B, T, 2))
    prob = tcar.car_parking()
    P = td.params_from_jax(p, torch.float64, "cpu")
    m = td.init_multipliers(prob, B, T, torch.float64, "cpu")
    w = torch.ones(B, dtype=torch.float64)
    r = forward_pass(prob, _t(x0s), None, _t(u0s), None, None, 0.0, P,
                     m.mu_le, m.mu_li, m.mu_fe, m.mu_fi, w, w)
    return dict(p=p, P=P, m=m, w=w, r=r)


def _jax_bundle(nom, full_ddp):
    r = nom["r"]
    e = jnp.zeros((T, 0))
    d = jax.jit(jax.vmap(lambda xs, us: j_calc_derivs(
        jcar.car_parking(), xs, us, nom["p"], e, e, jnp.zeros(0),
        jnp.zeros(0), 1.0, 1.0, full_ddp)))(jnp.asarray(r.xs.numpy()),
                                            jnp.asarray(r.us.numpy()))
    # FAIL_LANE: an indefinite cuu at FAIL_STEP fails its boxQP there
    cuu = d.step.cuu.at[FAIL_LANE, FAIL_STEP].add(-1e4 * jnp.eye(2))
    return d._replace(step=d.step._replace(cuu=cuu))


def _torch_bundle(d):
    return DerivBundle(step=StepDerivs(*map(_t, d.step)),
                       final=FinalDerivs(*map(_t, d.final)), ok=_t(d.ok))


@pytest.mark.parametrize("full_ddp", [True, False], ids=["full", "gn"])
def test_calc_derivs_matches_jax(nominal, full_ddp):
    r = nominal["r"]
    d = _jax_bundle(nominal, full_ddp)
    m, w = nominal["m"], nominal["w"]
    out = td.batched_calc_derivs(tcar.car_parking(), r.xs, r.us,
                                 nominal["P"], m.mu_le, m.mu_li, m.mu_fe,
                                 m.mu_fi, w, w, full_ddp)
    for name, a, b in zip(StepDerivs._fields, out.step, d.step):
        if name == "cuu":
            b = b.at[FAIL_LANE, FAIL_STEP].add(1e4 * jnp.eye(2))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    for a, b in zip(out.final, d.final):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)
    assert out.ok.all()
    # calc_derivs is the one-lane case
    one = td.calc_derivs(tcar.car_parking(), r.xs[2], r.us[2], nominal["P"],
                         m.mu_le[2], m.mu_li[2], m.mu_fe[2], m.mu_fi[2], 1.0,
                         1.0, full_ddp)
    for a, b in zip(one.step + one.final, out.step + out.final):
        np.testing.assert_array_equal(a.numpy(), b[2].numpy())


def _close(out, ref, name):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-11 * scale,
                               err_msg=name)


@pytest.mark.parametrize("full_ddp", [True, False], ids=["full", "gn"])
@pytest.mark.parametrize("reg_type", [1, 2])
def test_back_pass_matches_jax(nominal, reg_type, full_ddp):
    d = _jax_bundle(nominal, full_ddp)
    us = jnp.asarray(nominal["r"].us.numpy())
    ref = jax.jit(jax.vmap(lambda d_, u_, l_: j_back_pass(
        d_, u_, l_, reg_type, full_ddp)))(d, us, jnp.asarray(LAM))
    out = td.back_pass(_torch_bundle(d), nominal["r"].us, _t(LAM), reg_type,
                       full_ddp)
    np.testing.assert_array_equal(out.failed.numpy(), np.asarray(ref.failed))
    for name in ("l", "L", "dV", "g_norm"):
        _close(getattr(out, name), getattr(ref, name), name)
    assert out.failed[FAIL_LANE] and int(out.failed.sum()) < B
    # the failed lane: outputs from step 15 back are zero, later ones not
    l_fail = out.l[FAIL_LANE].abs().sum(-1)
    assert (l_fail[:FAIL_STEP + 1] == 0).all() and (l_fail[FAIL_STEP + 1:]
                                                     > 0).any()


def test_line_search_matches_jax(nominal):
    d = _jax_bundle(nominal, True)
    r, m, w = nominal["r"], nominal["m"], nominal["w"]
    lam = LAM.copy()
    lam[FAIL_LANE] = 1.0
    bp = td.back_pass(_torch_bundle(d), r.us, _t(lam), 1, True)
    # lane 0's feedforward blown up: every alpha but the smallest fails
    l = bp.l.clone()
    l[0] *= 50.0
    alphas = td.SolverOptions().alpha
    out = td.line_search(tcar.car_parking(), alphas, r.xs[:, 0], r.xs, r.us,
                         l, bp.L, bp.dV, r.cost, 0.0, nominal["P"], m.mu_le,
                         m.mu_li, m.mu_fe, m.mu_fi, w, w)
    e = jnp.zeros((T, 0))

    def one(x0, xs, us, l_, L_, dV, cost):
        return j_line_search(jcar.car_parking(), jnp.asarray(alphas), x0, xs,
                             us, l_, L_, dV, cost, 0.0, nominal["p"], e, e,
                             jnp.zeros(0), jnp.zeros(0), 1.0, 1.0)

    j = lambda a: jnp.asarray(a.numpy())
    ref = jax.jit(jax.vmap(one))(j(r.xs[:, 0]), j(r.xs), j(r.us), j(l),
                                 j(bp.L), j(bp.dV), j(r.cost))
    for name in ("success", "alpha_index"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    for name in ("xs", "us", "new_cost", "dcost", "expected", "z"):
        _close(getattr(out, name), getattr(ref, name), name)
    assert out.alpha_index[0] > 0 and (out.alpha_index[1:] == 0).any()


def test_default_options_stepwise_matches_jax():
    """``SolverOptions()``'s own methods: serial backward pass, serial line
    search, float64, max_iter 20."""
    p, x0s, u0s = _inputs()
    ref = jax.tree_util.tree_map(np.asarray, jd.make_batched_solver(
        jcar.car_parking(), jd.SolverOptions(debug_level=0))(x0s, u0s, p))
    opts = td.SolverOptions(debug_level=0)
    assert (opts.backpass_method, opts.linesearch_method) == ("serial",
                                                              "serial")
    out = td.to_numpy(td.StepwiseSolver(tcar.car_parking(), opts, chunk=3,
                                        min_compact_batch=2,
                                        device="cpu")(x0s, u0s, p))
    _assert_matches_jax(out, ref)


def _toy(pkg):
    """n_x = 2, n_u = 4: boxQP on 4 inputs is the projected-Newton
    iteration; u[0], u[1] in [-1, 1], u[2] in [-0.5, 0.5], u[3] free."""
    np_ = jnp if pkg is jd else torch

    def stack(v):
        return jnp.stack(v) if pkg is jd else torch.stack(v)

    def f(x, u, p, k):
        dt = p["dt"]
        return stack([x[0] + dt * (u[0] - u[1] + 0.3 * np_.sin(x[1])),
                      x[1] + dt * (u[2] + 0.5 * u[3] - 0.2 * x[0] * x[0])])

    def L(x, u, p, k):
        return (0.1 * (u[0] * u[0] + u[1] * u[1] + u[2] * u[2])
                + 0.01 * u[3] * u[3] + 0.01 * x[0] * x[0])

    def F(x, p, k):
        # x[0] = 5 is out of reach within the bounds on u[0], u[1]
        return 10.0 * (x[0] - 5.0) * (x[0] - 5.0) + 10.0 * (x[1] + 1.0) * (
            x[1] + 1.0)

    h = [lambda x, u, p, k: -u[0] - 1.0, lambda x, u, p, k: u[0] - 1.0,
         lambda x, u, p, k: -u[1] - 1.0, lambda x, u, p, k: u[1] - 1.0,
         lambda x, u, p, k: -u[2] - 0.5, lambda x, u, p, k: u[2] - 0.5]
    return pkg.make_problem(
        n_x=2, n_u=4, f=f, L=L, F=F, h=h, name="Toy4",
        example_params={"dt": 0.1},
        box_meta=[(0, -1.0), (0, 1.0), (1, -1.0), (1, 1.0), (2, -1.0),
                  (2, 1.0)])


def _solve_both(jprob, tprob, x0s, u0s, p, us_atol=1e-7, **kw):
    ref = jax.tree_util.tree_map(np.asarray, jd.make_batched_solver(
        jprob, jd.SolverOptions(debug_level=0, **kw))(x0s, u0s, p))
    out = td.to_numpy(td.StepwiseSolver(
        tprob, td.SolverOptions(debug_level=0, **kw), min_compact_batch=2,
        device="cpu")(x0s, u0s, p))
    for f in COUNTS:
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f),
                                      err_msg=f)
    np.testing.assert_allclose(out.cost, ref.cost, rtol=1e-8)
    np.testing.assert_allclose(out.us, ref.us, rtol=0, atol=us_atol)
    return out


def test_n_u_4_newton_boxqp_matches_jax():
    rng = np.random.default_rng(4)
    x0s = 0.3 * rng.standard_normal((3, 2))
    u0s = 0.5 * rng.standard_normal((3, 20, 4))
    # The Newton QP stops at its tolerances (min_grad, min_rel_improve
    # 1e-8), so u[3], weighted 0.01, settles only to ~1e-6 between the two
    # packages' roundings; the counts and the cost agree as everywhere.
    out = _solve_both(_toy(jd), _toy(td), x0s, u0s, {"dt": 0.1},
                      us_atol=1e-5, max_iter=15)
    assert np.isin(out.status, (1, 2)).all()
    assert (np.abs(out.us[..., 0]) > 1.0 - 1e-9).any()  # a bound binds


def test_mod_chol_matches_jax():
    """MOD_CHOL on the retry-heavy workload of tests/test_batched.py:72-87,
    where the FULL_DDP Quu turns indefinite."""
    p, x0, _ = jcar.default_setup(T=T)
    x0s = np.tile(x0, (4, 1))
    u0s = 4.0 * np.random.default_rng(11).standard_normal((4, T, 2))
    out = _solve_both(jcar.car_parking(), tcar.car_parking(), x0s, u0s, p,
                      max_iter=12, use_mod_chol=True)
    assert np.isfinite(out.cost).all()
