"""Cartpole on the port (``models/cartpole.py``), float64 on the CPU.

The three tests of ``tests/test_solver_cartpole.py`` on the port's
``solve`` with the default options (serial path), max_iter=150: the
swing-up ends upright near the origin, respects the force limits, and
under a tight +-4 N limit rides the bound.  The swing-up equals JAX's per
status, iterations and body calls, cost to rtol 1e-8.  The small solve of
``test_cartpole_pallas_backpass_matches_serial`` (T=40, two lanes,
max_iter=8) runs on every backward-pass and line-search method of the port
(the kernels' plain versions on the CPU) and against JAX's serial solve:
status, iterations, body, stale and retry calls equal, cost to rtol
1e-10.
"""

import jax
import numpy as np
import pytest

import ddp_generator_tpu as jd
from ddp_generator_tpu.models import cartpole as jcp
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.models import cartpole as tcp

COUNTS = ("status", "iterations", "body_calls", "stale_calls",
          "bp_retry_calls")


@pytest.fixture(scope="module")
def pole_solution():
    prob = tcp.cartpole()
    p, x0, u0 = tcp.default_setup(T=150, seed=0)
    sol = td.solve(prob, x0, u0, p, td.SolverOptions(max_iter=150),
                   device="cpu")
    return prob, p, td.to_numpy(sol)


def test_cartpole_swings_up(pole_solution):
    prob, p, sol = pole_solution
    assert bool(sol.success)
    final = sol.xs[-1]
    # upright: cos(th) ~ 1; near the origin with small rates
    assert np.cos(final[1]) > 0.98, final
    assert abs(final[0]) < 0.5, final
    assert abs(final[3]) < 1.0, final


def test_cartpole_respects_force_limits(pole_solution):
    prob, p, sol = pole_solution
    assert np.max(np.abs(sol.us)) <= 15.0 + 1e-12


def test_cartpole_saturates_tight_force_limit(pole_solution):
    # At +-4 N the swing-up of the +-15 N limit (peak ~6 N) is infeasible,
    # so the optimum must ride the bound: the clamp machinery is engaged.
    prob, _, _ = pole_solution
    p, x0, u0 = tcp.default_setup(T=150, seed=0)
    p["limF"] = np.array([-4.0, 4.0])
    sol = td.to_numpy(td.solve(prob, x0, u0, p,
                               td.SolverOptions(max_iter=150), device="cpu"))
    assert bool(sol.success)
    assert np.max(np.abs(sol.us)) <= 4.0 + 1e-12
    assert np.any(np.abs(sol.us) > 4.0 - 1e-9)
    assert np.cos(sol.xs[-1][1]) > 0.98


def test_cartpole_swing_up_matches_jax(pole_solution):
    _, _, sol = pole_solution
    p, x0, u0 = jcp.default_setup(T=150, seed=0)
    ref = jax.tree_util.tree_map(np.asarray, jd.solve(
        jcp.cartpole(), x0, u0, p, jd.SolverOptions(max_iter=150)))
    for f in COUNTS:
        assert getattr(sol, f) == getattr(ref, f), f
    np.testing.assert_allclose(sol.cost, ref.cost, rtol=1e-8)
    np.testing.assert_allclose(sol.us, ref.us, rtol=0, atol=1e-7)


@pytest.fixture(scope="module")
def small_case():
    """tests/test_solver_cartpole.py:56-72: T=40, seed 1, lanes u0, u0/2."""
    p, x0, u0 = tcp.default_setup(T=40, seed=1)
    x0s, u0s = np.tile(x0, (2, 1)), np.stack([u0, u0 * 0.5])
    ref = jax.tree_util.tree_map(np.asarray, jd.make_batched_solver(
        jcp.cartpole(), jd.SolverOptions(max_iter=8,
                                         backpass_method="serial"))(
        x0s, u0s, p))
    return p, x0s, u0s, ref


@pytest.mark.parametrize("backpass,linesearch", [
    ("serial", "serial"), ("serial", "kernel"), ("kernel", "serial"),
    ("kernel", "kernel"), ("fused", "serial"), ("fused", "kernel"),
])
def test_every_method_matches_serial_and_jax(small_case, backpass,
                                             linesearch):
    p, x0s, u0s, ref = small_case
    out = td.to_numpy(td.StepwiseSolver(
        tcp.cartpole(), td.SolverOptions(max_iter=8, debug_level=0,
                                         backpass_method=backpass,
                                         linesearch_method=linesearch),
        min_compact_batch=2, device="cpu")(x0s, u0s, p))
    for f in COUNTS:
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f),
                                      err_msg=f)
    np.testing.assert_allclose(out.cost, ref.cost, rtol=1e-10)
