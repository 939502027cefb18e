"""The routes of ``StepwiseSolver`` that run on static carries -- and on a
CUDA device as CUDA graph replays -- beside the kernel and fused paths:
the serial and parallel backward passes, the serial line search and
per-lane params (``batch_params=True``).  On the CPU each equals the eager
reference ``make_batched_solver`` in every Solution field, bit for bit,
through a compaction that halves the working width twice (so a wrong
gather into a width's static params would show); ``debug_level=3``, whose
body call prints from the host, stays eager, while boxQP's Newton
iteration and the inline lambda retries run on the static carries: their
loops are device loops (``ops/device_loop.py``), which read their
condition on the host only in the CPU's plain loop.  Float64, B=16,
T <= 40."""

import numpy as np
import pytest
import torch

import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch import solver as slv
from test_torch_graphs import ROUTES, _workload, host_reads, route_case

B, T = 16, 30
# lanes whose initial rollout is NaN (status 6 at init): retired lanes the
# compactions move behind the working set
RETIRED = [1, 6, 11]


def _compacting_case(route):
    """``route_case`` with lanes that converge at different iterations:
    CarParking from perturbed starts with random controls of per-lane
    scale, and three lanes retired at init."""
    problem, o, x0s, u0s, p, lanes = route_case(ROUTES[route], B, T)
    if ROUTES[route][0] != "parallel":
        rng = np.random.default_rng(5)
        x0s = x0s + 0.3 * rng.standard_normal(x0s.shape)
        u0s = ((0.05 + 0.5 * rng.random((B, 1, 1)))
               * rng.standard_normal(u0s.shape))
        o = o.replace(max_iter=40)
    x0s[RETIRED, 0] = np.nan
    return problem, o, x0s, u0s, p, lanes


@pytest.mark.parametrize("route", [r for r in ROUTES
                                   if r not in ("kernel", "fused")])
def test_static_route_equals_batched_solver(route):
    """Every Solution field bit for bit (NaN where NaN) against
    ``make_batched_solver``, through the static route from width 16 down to
    4 (one body call a chunk, so every count is read at once)."""
    problem, o, x0s, u0s, p, lanes = _compacting_case(route)
    s = td.StepwiseSolver(problem, o, chunk=1, batch_params=lanes,
                          compact_levels=2, min_compact_batch=4,
                          device="cpu")
    sol = s(x0s, u0s, p)
    ref = td.make_batched_solver(problem, o, batch_params=lanes,
                                 device="cpu")(x0s, u0s, p)
    assert s._static_ok
    # the working width halved twice (at one count or at two), on the
    # static carries of each width
    assert s.last_stats.eager[0] == 16 and s.last_stats.eager[-1] == 4
    assert set(s.last_stats.eager) == {w for w, _ in s._widths}
    assert (sol.status[RETIRED] == 6).all()
    assert (sol.iterations[sol.status != 6] > 0).all()
    assert len(set(sol.iterations.tolist())) > 2  # lanes retire apart
    for name, a, b in zip(sol._fields, sol, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                   msg=name)


def _four_input_problem():
    """A linear problem with n_u = 4, so that ``boxqp_method="auto"``
    resolves to the Newton iteration; one box ``u_0 < 0.5``."""
    def f(x, u, p, k):
        return torch.stack([x[0] + 0.1 * (u[0] + u[1]),
                            x[1] + 0.1 * (u[2] - u[3])])

    def L(x, u, p, k):
        return 0.01 * (u * u).sum(0) + 0.1 * (x * x).sum(0)

    def F(x, p, k):
        return (x * x).sum(0)

    return td.make_problem(n_x=2, n_u=4, f=f, L=L, F=F,
                           h=[lambda x, u, p, k: u[0] - 0.5],
                           box_meta=[(0, 1.0)], name="four_inputs")


EAGER = {
    "newton_auto_n_u_4": dict(),
    "newton_explicit": dict(boxqp_method="newton"),
    "newton_per_lane": dict(boxqp_method="newton", batch_params=True),
    "lam_retry_inline": dict(lam_retry="inline"),
    "debug_level_3": dict(debug_level=3),
}


@pytest.mark.parametrize("case", list(EAGER))
def test_routes_that_read_the_host_stay_eager(case, capsys):
    """``debug_level=3`` keeps the solver off the static carries:
    ``_on_static`` is false at every width, and its body call reads the
    host (the per-iteration print).  The Newton and inline-retry routes
    read the host only through ``device_loop.while_loop``: on the CPU its
    plain loop reads each condition, so their body call reads the host
    here too, yet every width runs on a static carry, which a CUDA device
    replays as a graph with WHILE nodes."""
    kw = dict(EAGER[case])
    lanes = kw.pop("batch_params", False)
    if case == "newton_auto_n_u_4":
        problem = _four_input_problem()
        p, x0s = {}, np.tile([1.0, -1.0], (4, 1))
        u0s = 0.1 * np.random.default_rng(0).standard_normal((4, 10, 4))
    else:
        problem, p, x0s, u0s = _workload(B=4, T=10)
    if lanes:
        p = {k: np.tile(np.asarray(v), (4,) + (1,) * np.ndim(v))
             for k, v in p.items()}
    o = td.SolverOptions(max_iter=5, dtype="float64",
                         debug_level=kw.pop("debug_level", 0),
                         **kw)
    s = td.StepwiseSolver(problem, o, batch_params=lanes,
                          min_compact_batch=1, device="cpu")
    eager = case == "debug_level_3"
    assert s._static_ok is not eager
    assert all(s._on_static(w) is not eager for w in s._compact_sizes(4))
    init, body, _, cast = slv._make_parts(problem, o, "cpu", lanes)
    params = cast(p, 4)
    c = init(x0s, u0s, params)
    with pytest.raises(AssertionError, match="host read"):
        with host_reads():
            slv._masked(body, o.max_iter)(c, params)
    s(x0s, u0s, p)
    assert s.last_stats.graphed == ()
    assert bool(s._widths) is not eager
