"""Parity gaps of the serial path against the JAX package, on the CPU.

* The ``hle`` and ``hfi`` AL families: the three cases of
  ``tests/test_solver_al_families.py:41-110`` (a double integrator with no
  ``h``) through the port's default options, float64, against the JAX
  package's solve: equal status, iterations and body calls, cost, ``xs``
  and ``us`` to 1e-10, plus that file's own checks on the port's solution.
* float32: a small CarParking batch on the serial path against the JAX
  package's serial float32 solve per lane.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_generator_tpu as jd
from ddp_generator_tpu.models import car_parking as jcar
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.models import car_parking as tcar

COUNTS = ("status", "iterations", "body_calls", "stale_calls",
          "bp_retry_calls")


def _double_integrator(pkg, hle=(), hfi=()):
    """x = [pos, vel], u = [acc], dt=0.1, quadratic effort cost."""
    stack = jnp.stack if pkg is jd else torch.stack

    def f(x, u, p, k):
        dt = p["dt"]
        return stack([x[0] + dt * x[1], x[1] + dt * u[0]])

    def L(x, u, p, k):
        return p["r"] * u[0] ** 2

    def F(x, p, k):
        return 0.0 * x[0]

    return pkg.make_problem(n_x=2, n_u=1, f=f, L=L, F=F, hle=hle, hfi=hfi,
                            name="double_integrator",
                            example_params=dict(dt=0.1, r=0.1, vref=0.5))


def _hle(x, u, p, k):
    return x[1] - p["vref"]


def _hfi_reach(x, p, k):
    return 1.0 - x[0]


def _hfi_slack(x, p, k):
    return -5.0 - x[0]


# name: (constraints, params, x0, u0, options), as in the JAX file
CASES = {
    "hle": (dict(hle=(_hle,)), dict(dt=0.1, r=0.1, vref=0.5), [0.0, 0.0],
            np.zeros((40, 1)),
            dict(max_iter=60, w_pen_init_l=10.0, w_pen_fact2=2.0,
                 full_ddp=False, tolFun=1e-9)),
    "hfi_active": (dict(hfi=(_hfi_reach,)), dict(dt=0.1, r=0.1, vref=0.0),
                   [0.0, 0.0], 0.01 * np.ones((30, 1)),
                   dict(max_iter=80, w_pen_init_f=10.0, w_pen_fact2=2.0,
                        full_ddp=False, tolFun=1e-9)),
    "hfi_inactive": (dict(hfi=(_hfi_slack,)), dict(dt=0.1, r=0.1, vref=0.0),
                     [0.3, -0.1], np.zeros((20, 1)),
                     dict(max_iter=40, full_ddp=False)),
}


def _both(case):
    cons, p, x0, u0, kw = CASES[case]
    x0 = np.asarray(x0)
    ref = jax.tree_util.tree_map(np.asarray, jd.solve(
        _double_integrator(jd, **cons), x0, u0, p,
        jd.SolverOptions(debug_level=0, **kw)))
    out = td.to_numpy(td.solve(_double_integrator(td, **cons), x0, u0, p,
                               td.SolverOptions(debug_level=0, **kw),
                               device="cpu"))
    return out, ref


@pytest.mark.parametrize("case", list(CASES))
def test_al_family_matches_jax(case):
    out, ref = _both(case)
    for f in COUNTS:
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f),
                                      err_msg=f)
    np.testing.assert_allclose(out.cost, ref.cost, rtol=1e-10)
    for f in ("xs", "us"):
        np.testing.assert_allclose(getattr(out, f), getattr(ref, f), rtol=0,
                                   atol=1e-10, err_msg=f)
    # the JAX file's own checks, on the port's solution
    if case == "hle":
        assert np.max(np.abs(out.xs[2:-1, 1] - 0.5)) < 1e-3
        assert bool(out.success)
    elif case == "hfi_active":
        assert 1.0 - 1e-5 < out.xs[-1, 0] < 1.0 + 1e-4
        assert out.cost > 0.0
    else:
        cons, p, x0, u0, kw = CASES[case]
        unc = td.to_numpy(td.solve(_double_integrator(td), np.asarray(x0),
                                   u0, p, td.SolverOptions(debug_level=0,
                                                           **kw),
                                   device="cpu"))
        np.testing.assert_allclose(out.us, unc.us, atol=1e-6)


def test_float32_serial_matches_jax_per_lane():
    """CarParking, 4 lanes, T=30, float32 (tolFun 1e-5, as bench.py takes
    it), the serial path of both packages, per lane: equal status, the cost
    of every iteration both ran and the final cost to 1e-6 (a few float32
    roundings of a cost ~4.86).

    The iteration counts may differ at float32's floor: tolFun is ~20 ulps
    of the cost, so near the optimum the last decrease sits on the rounding
    of the cost sums.  A lane that reaches the optimum a step early finds no
    alpha with z > zMin and escalates lambda until one is taken (here lane
    2: 14 iterations against JAX's 8; in float64 both take 8).  Every such
    extra iteration must then sit at the final cost: no progress, only the
    floor's retries."""
    T, nb = 30, 4
    p, x0, _ = jcar.default_setup(T=T)
    rng = np.random.default_rng(0)
    x0s = np.tile(x0, (nb, 1)).astype(np.float32)
    u0s = (0.1 * rng.standard_normal((nb, T, 2))).astype(np.float32)
    p32 = {k: np.asarray(v, np.float32) for k, v in p.items()}
    kw = dict(max_iter=40, dtype="float32", tolFun=1e-5, debug_level=0)
    ref = jax.tree_util.tree_map(np.asarray, jd.make_batched_solver(
        jcar.car_parking(), jd.SolverOptions(**kw))(x0s, u0s, p32))
    out = td.to_numpy(td.make_batched_solver(
        tcar.car_parking(), td.SolverOptions(**kw), device="cpu")(
            x0s, u0s, p32))
    assert out.cost.dtype == np.float32 == ref.cost.dtype
    np.testing.assert_array_equal(out.status, ref.status)
    assert np.isin(out.status, (1, 2)).all()
    np.testing.assert_allclose(out.cost, ref.cost, rtol=1e-6)
    for b in range(nb):
        n = min(out.iterations[b], ref.iterations[b])
        np.testing.assert_allclose(out.log_cost[b, :n], ref.log_cost[b, :n],
                                   rtol=1e-6, err_msg=f"lane {b}")
        for s in (out, ref):
            np.testing.assert_allclose(s.log_cost[b, n - 1:s.iterations[b]],
                                       ref.cost[b], rtol=1e-6,
                                       err_msg=f"lane {b}")
