"""Inline lambda retries (``lam_retry="inline"``, ``inline_below``) on the
port, float64 on the CPU.

``tests/test_batched.py:66-127`` for each backward pass of the port
(serial, kernel and fused, whose kernels run their plain versions here):
on a workload that makes the FULL_DDP ``Quu`` indefinite (u0 = 4 normal),
``lam_retry="inline"`` and ``"deferred"`` give equal status and
iterations, cost and lambda to rtol 1e-12 and us to atol 1e-12, and the
deferred run retries.  ``StepwiseSolver(inline_below=W)`` equals the
all-deferred solve the same way, and with every width inline it needs
fewer body calls.  The port's inline solve equals JAX's inline solve per
lane (counts equal, cost to rtol 1e-8).
"""

import jax
import numpy as np
import pytest

import ddp_generator_tpu as jd
from ddp_generator_tpu.models import car_parking as jcar
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.models import car_parking as tcar

T = 60
# lanes of tests/test_batched.py's workload (8 lanes, seed 11) with
# lambda retries (4, 6) and without
LANES = [0, 4, 6, 7]
COUNTS = ("status", "iterations", "body_calls", "stale_calls",
          "bp_retry_calls")


def _workload():
    p, x0, _ = tcar.default_setup(T=T)
    u0s = 4.0 * np.random.default_rng(11).standard_normal((8, T, 2))
    return p, np.tile(x0, (len(LANES), 1)), u0s[LANES]


def _opts(backpass, **kw):
    return td.SolverOptions(max_iter=30, full_ddp=True, debug_level=0,
                            backpass_method=backpass,
                            linesearch_method="kernel" if backpass != "serial"
                            else "serial", **kw)


def _assert_same_lanes(a, b):
    np.testing.assert_array_equal(a.status, b.status)
    np.testing.assert_array_equal(a.iterations, b.iterations)
    np.testing.assert_allclose(a.cost, b.cost, rtol=1e-12)
    np.testing.assert_allclose(a.lam, b.lam, rtol=1e-12)
    np.testing.assert_allclose(a.us, b.us, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def deferred():
    """The deferred batched solve of each backward pass."""
    p, x0s, u0s = _workload()
    return {bp: td.to_numpy(td.make_batched_solver(
        tcar.car_parking(), _opts(bp), device="cpu")(x0s, u0s, p))
        for bp in ("serial", "kernel", "fused")}


@pytest.mark.parametrize("backpass", ["serial", "kernel", "fused"])
def test_lam_retry_inline_matches_deferred(deferred, backpass):
    p, x0s, u0s = _workload()
    sol_d = deferred[backpass]
    sol_i = td.to_numpy(td.make_batched_solver(
        tcar.car_parking(), _opts(backpass, lam_retry="inline"),
        device="cpu")(x0s, u0s, p))
    assert int(sol_d.bp_retry_calls.sum()) > 0
    _assert_same_lanes(sol_d, sol_i)
    # inline: no body call is a retry; the attempts are counted instead
    assert sol_i.body_calls.sum() < sol_d.body_calls.sum()


@pytest.mark.parametrize("backpass", ["serial", "kernel", "fused"])
def test_stepwise_inline_below_matches_plain(deferred, backpass):
    p, x0s, u0s = _workload()
    kw = dict(chunk=4, compact_levels=2, min_compact_batch=2)
    plain = td.to_numpy(td.StepwiseSolver(
        tcar.car_parking(), _opts(backpass), device="cpu", **kw)(
            x0s, u0s, p))
    for f in COUNTS:  # StepwiseSolver == make_batched_solver per lane
        np.testing.assert_array_equal(getattr(plain, f),
                                      getattr(deferred[backpass], f))
    for below in (2, 4):
        mixed = td.to_numpy(td.StepwiseSolver(
            tcar.car_parking(), _opts(backpass), inline_below=below,
            device="cpu", **kw)(x0s, u0s, p))
        _assert_same_lanes(plain, mixed)
    assert mixed.body_calls.sum() < plain.body_calls.sum()


def test_port_inline_matches_jax_inline():
    p, x0s, u0s = _workload()
    ref = jax.tree_util.tree_map(np.asarray, jd.make_batched_solver(
        jcar.car_parking(), jd.SolverOptions(
            max_iter=30, full_ddp=True, debug_level=0,
            lam_retry="inline"))(x0s, u0s, p))
    out = td.to_numpy(td.make_batched_solver(
        tcar.car_parking(), _opts("serial", lam_retry="inline"),
        device="cpu")(x0s, u0s, p))
    for f in COUNTS:
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f),
                                      err_msg=f)
    np.testing.assert_allclose(out.cost, ref.cost, rtol=1e-8)
    np.testing.assert_allclose(out.lam, ref.lam, rtol=1e-8)
    assert int(out.bp_retry_calls.sum()) > 0
