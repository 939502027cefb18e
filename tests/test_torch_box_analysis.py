"""The numeric box analysis (``problem.analyze_box_constraints``) against
the JAX package's, and a solve of a user problem whose input boxes are
found by it.

* CarParking's ``h1..h4``, a state-dependent limit, the point mass's six
  input bounds and every malformed constraint of ``tests/test_problem.py``
  (two inputs, a coefficient of 2, a nonlinear input, no input at all):
  the same ``(u_index, sign)`` as the JAX package, or the same
  ``ProblemValidationError`` and message;
* the 3-input point mass of ``chip_smoke.user_problems`` (no
  ``box_meta``), ``backpass_method="kernel"``, B=8, T=20, float64, per lane
  against the JAX package's serial solve of the same problem written in
  JAX: status, iterations, body and stale calls equal, cost to 1e-8,
  trajectories to 1e-7.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ddp_generator_tpu as jd
import ddp_generator_tpu_torch as td
from ddp_generator_tpu.models import car_parking as jcar
from ddp_generator_tpu.problem import analyze_box_constraints as jax_analyze
from ddp_generator_tpu_torch.models import car_parking as tcar
from ddp_generator_tpu_torch.problem import analyze_box_constraints

ROOT = Path(__file__).resolve().parent.parent


def _user_problems():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.user_problems()


def _pm_box(i, sign):
    if sign > 0:
        return lambda x, u, p, k: u[i] - p["umax"][i]
    return lambda x, u, p, k: -u[i] - p["umax"][i]


PM_PARAMS = dict(dt=0.05, cd=1.0, r=0.01, q=0.1, qf=10.0,
                 target=np.array([1.0, -1.0, 0.5]),
                 umax=np.array([1.0, 1.5, 2.0]))

# name: (n_x, n_u, JAX h, port h, params); the malformed ones are
# tests/test_problem.py:46-81 and a constraint with no input
CASES = {
    "car_parking": (4, 2, list(jcar.car_parking().h),
                    list(tcar.car_parking().h), tcar.default_params()),
    "state_dependent": (2, 1, [lambda x, u, p, k: u[0] - x[0] * x[1]],
                        [lambda x, u, p, k: u[0] - x[0] * x[1]], {}),
    "point_mass3": (6, 3, [_pm_box(i, s) for i in range(3) for s in (-1, 1)],
                    [_pm_box(i, s) for i in range(3) for s in (-1, 1)],
                    PM_PARAMS),
    "two_inputs": (1, 2, [lambda x, u, p, k: u[0] + u[1] - 1.0],
                   [lambda x, u, p, k: u[0] + u[1] - 1.0], {}),
    "coefficient_2": (1, 1, [lambda x, u, p, k: 2.0 * u[0] - 1.0],
                      [lambda x, u, p, k: 2.0 * u[0] - 1.0], {}),
    "nonlinear": (1, 1, [lambda x, u, p, k: u[0] ** 2 - 1.0],
                  [lambda x, u, p, k: u[0] ** 2 - 1.0], {}),
    "no_input": (2, 1, [lambda x, u, p, k: x[0] - 1.0],
                 [lambda x, u, p, k: x[0] - 1.0], {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_box_analysis_matches_jax(case):
    n_x, n_u, jh, th, params = CASES[case]
    try:
        ref = [(bc.u_index, bc.sign)
               for bc in jax_analyze(n_x, n_u, jh, params)]
    except jd.ProblemValidationError as err:
        with pytest.raises(td.ProblemValidationError) as got:
            analyze_box_constraints(n_x, n_u, th, params)
        assert str(got.value) == str(err)
        return
    out = [(bc.u_index, bc.sign)
           for bc in analyze_box_constraints(n_x, n_u, th, params)]
    assert out == ref
    if case == "car_parking":
        assert out == [(0, -1.0), (0, 1.0), (1, -1.0), (1, 1.0)]


def test_make_problem_analyzes_h_without_box_meta():
    """make_problem probes h unless box_meta is given (then the declared
    metadata is trusted, as in the JAX package)."""
    prob = td.make_problem(4, 2, tcar.f, tcar.L, tcar.F,
                           h=[tcar.h1, tcar.h2, tcar.h3, tcar.h4],
                           example_params=tcar.default_params())
    assert [(bc.u_index, bc.sign) for bc in prob.box_constraints] == [
        (0, -1.0), (0, 1.0), (1, -1.0), (1, 1.0)]
    with pytest.raises(td.ProblemValidationError, match="coefficient"):
        td.make_problem(1, 1, lambda x, u, p, k: x + u,
                        lambda x, u, p, k: u[0] * u[0],
                        lambda x, p, k: x[0] * x[0],
                        h=[lambda x, u, p, k: 2.0 * u[0] - 1.0],
                        example_params={})
    declared = td.make_problem(1, 1, lambda x, u, p, k: x + u,
                               lambda x, u, p, k: u[0] * u[0],
                               lambda x, p, k: x[0] * x[0],
                               h=[lambda x, u, p, k: 2.0 * u[0] - 1.0],
                               box_meta=[(0, 1.0)])
    assert declared.box_constraints[0].sign == 1.0


def _jax_point_mass():
    def f(x, u, p, k):
        dt, cd = p["dt"], p["cd"]
        vel = [x[3 + i] + dt * (u[i] - cd * x[3 + i] * jnp.abs(x[3 + i]))
               for i in range(3)]
        return jnp.stack([x[i] + dt * vel[i] for i in range(3)] + vel)

    def miss(x, p):
        return sum((x[i] - p["target"][i]) ** 2 for i in range(3))

    def L(x, u, p, k):
        return p["r"] * jnp.sum(u * u) + p["q"] * miss(x, p)

    def F(x, p, k):
        return p["qf"] * (miss(x, p) + sum(x[3 + i] ** 2 for i in range(3)))

    return jd.make_problem(
        n_x=6, n_u=3, f=f, L=L, F=F,
        h=[_pm_box(i, s) for i in range(3) for s in (-1, 1)],
        name="point_mass3", example_params=PM_PARAMS)


def test_point_mass_without_box_meta_matches_jax_per_lane():
    problem, params, _, inputs = _user_problems()["point_mass3"]
    assert [(bc.u_index, bc.sign) for bc in problem.box_constraints] == [
        (i, s) for i in range(3) for s in (-1.0, 1.0)]
    x0s, u0s = inputs(8, 3)
    u0s = 1.5 * u0s[:, :20] / 0.1  # some initial inputs beyond their box
    kw = dict(max_iter=50, debug_level=0)
    ref = jax.tree_util.tree_map(np.asarray, jd.make_batched_solver(
        _jax_point_mass(), jd.SolverOptions(**kw))(x0s, u0s, params))
    out = td.to_numpy(td.StepwiseSolver(
        problem, td.SolverOptions(backpass_method="kernel",
                                  linesearch_method="kernel", **kw),
        min_compact_batch=2, device="cpu")(x0s, u0s, params))
    for f in ("status", "iterations", "body_calls", "stale_calls"):
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f),
                                      err_msg=f)
    assert np.isin(out.status, (1, 2)).all()
    np.testing.assert_allclose(out.cost, ref.cost, rtol=1e-8)
    np.testing.assert_allclose(out.xs, ref.xs, rtol=0, atol=1e-7)
    np.testing.assert_allclose(out.us, ref.us, rtol=0, atol=1e-7)
    umax = PM_PARAMS["umax"]
    assert (np.abs(out.us) <= umax * (1 + 1e-12)).all()
    assert (np.abs(out.us).max(axis=(0, 1)) > 0.99 * umax).any()
