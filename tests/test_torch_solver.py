"""The ported slice end to end: the batched CarParking solve.

The port's ``StepwiseSolver`` (kernel methods, which run their plain
PyTorch versions on the CPU) against JAX's ``make_batched_solver`` with the
serial methods, float64, T=50, B=8, max_iter=50: per lane the same status,
iterations, body calls and stale calls, cost to rtol 1e-8 and trajectories
to atol 1e-7, with ``backpass_method="kernel"`` (emission + B1) and
``"fused"`` (B3).  Lane 7 starts so fast that its initial rollout is NaN
(STATUS_INIT_FAILED).  Compaction on and off must be bit-identical.  The
fused path's AL families: ``brachistochrone_hli`` against JAX's own fused
solve, cost to rtol 1e-6 as ``tests/test_pallas_fused.py:85-103`` holds it.
"""

import jax
import numpy as np
import pytest
import torch

import ddp_generator_tpu as jd
from ddp_generator_tpu.models import brachistochrone as jbr
from ddp_generator_tpu.models import car_parking as jcar
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.models import brachistochrone as tbr
from ddp_generator_tpu_torch.models import car_parking as tcar

T, B, MAX_ITER = 50, 8, 50
COUNTS = ("status", "iterations", "body_calls", "stale_calls",
          "bp_retry_calls")


def _inputs():
    p, x0, _ = jcar.default_setup(T=T, seed=0)
    rng = np.random.default_rng(0)
    x0s = np.tile(x0, (B, 1)) + 0.05 * rng.standard_normal((B, 4))
    u0s = 0.1 * rng.standard_normal((B, T, 2))
    x0s[7, 3] = 1e4  # |h*v*sin(w)| > d at once: NaN initial rollout
    u0s[7, :, 0] = 0.3
    return p, x0s, u0s


def _port_opts(**kw):
    kw = {"backpass_method": "kernel", **kw}
    return td.SolverOptions(max_iter=MAX_ITER, debug_level=0,
                            linesearch_method="kernel", **kw)


@pytest.fixture(scope="module")
def reference():
    p, x0s, u0s = _inputs()
    sol = jd.make_batched_solver(
        jcar.car_parking(), jd.SolverOptions(max_iter=MAX_ITER,
                                             debug_level=0))(x0s, u0s, p)
    return jax.tree_util.tree_map(np.asarray, sol)


@pytest.fixture(scope="module")
def compacted():
    p, x0s, u0s = _inputs()
    solver = td.StepwiseSolver(tcar.car_parking(), _port_opts(), chunk=3,
                               compact_levels=4, min_compact_batch=2,
                               device="cpu")
    return td.to_numpy(solver(x0s, u0s, p))


def test_stepwise_matches_jax_per_lane(reference, compacted):
    _assert_matches_jax(compacted, reference)


def test_fused_stepwise_matches_jax_per_lane(reference):
    p, x0s, u0s = _inputs()
    solver = td.StepwiseSolver(tcar.car_parking(),
                               _port_opts(backpass_method="fused"), chunk=3,
                               compact_levels=4, min_compact_batch=2,
                               device="cpu")
    _assert_matches_jax(td.to_numpy(solver(x0s, u0s, p)), reference)


def test_fused_brachistochrone_hli_matches_jax_fused():
    B, n = 4, 30
    p, x0, _ = jbr.default_setup_hli(n)
    rng = np.random.default_rng(2)
    x0s = np.tile(x0, (B, 1))
    u0s = -np.abs(rng.uniform(0.5, 1.5, (B, n, 1)))
    opts = dict(max_iter=25, w_pen_init_l=40.0, w_pen_init_f=1e-5,
                w_pen_max_f=1.0, full_ddp=False, debug_level=0,
                backpass_method="fused")
    ref = jd.make_batched_solver(jbr.brachistochrone_hli(),
                                 jd.SolverOptions(**opts))(x0s, u0s, p)
    out = td.to_numpy(td.StepwiseSolver(
        tbr.brachistochrone_hli(),
        td.SolverOptions(linesearch_method="kernel", **opts),
        min_compact_batch=2, device="cpu")(x0s, u0s, p))
    assert np.isfinite(out.cost).all()
    np.testing.assert_allclose(out.cost, np.asarray(ref.cost), rtol=1e-6)


def _assert_matches_jax(out, ref):
    for f in COUNTS:
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f),
                                      err_msg=f)
    assert out.status[7] == td.STATUS_INIT_FAILED
    assert np.isin(out.status[:7], (1, 2)).all()
    np.testing.assert_array_equal(out.success, ref.success)
    ok = np.isfinite(ref.cost)
    assert ok[:7].all()
    np.testing.assert_allclose(out.cost[ok], ref.cost[ok], rtol=1e-8)
    np.testing.assert_allclose(out.xs[ok], ref.xs[ok], rtol=0, atol=1e-7)
    np.testing.assert_allclose(out.us[ok], ref.us[ok], rtol=0, atol=1e-7)
    for f in ("lam", "dlam", "g_norm", "log_cost", "log_z"):
        np.testing.assert_allclose(getattr(out, f)[ok], getattr(ref, f)[ok],
                                   rtol=1e-6, atol=1e-9, err_msg=f)
    np.testing.assert_array_equal(out.log_linesearch, ref.log_linesearch)


def test_compaction_on_off_bit_identical(compacted):
    p, x0s, u0s = _inputs()
    plain = td.to_numpy(td.StepwiseSolver(
        tcar.car_parking(), _port_opts(), chunk=3, compact_levels=0,
        device="cpu")(
            x0s, u0s, p))
    for f in plain._fields:
        np.testing.assert_array_equal(getattr(compacted, f),
                                      getattr(plain, f), err_msg=f)


def test_batched_and_single_solve_match_stepwise(compacted):
    p, x0s, u0s = _inputs()
    lanes = [0, 2, 7]
    out = td.to_numpy(td.make_batched_solver(tcar.car_parking(),
                                             _port_opts(), device="cpu")(
        x0s[lanes], u0s[lanes], p))
    for f in out._fields:
        np.testing.assert_array_equal(getattr(out, f),
                                      getattr(compacted, f)[lanes],
                                      err_msg=f)
    one = td.to_numpy(td.solve(tcar.car_parking(), x0s[2], u0s[2], p,
                               _port_opts(), device="cpu"))
    for f in one._fields:
        np.testing.assert_array_equal(getattr(one, f),
                                      getattr(compacted, f)[2], err_msg=f)


def test_float32_solve_runs():
    p, x0s, u0s = _inputs()
    sol = td.to_numpy(td.StepwiseSolver(
        tcar.car_parking(), _port_opts(dtype="float32", tolFun=1e-5),
        min_compact_batch=2, device="cpu")(x0s[:4], u0s[:4], p))
    assert sol.xs.dtype == np.float32 and sol.cost.dtype == np.float32
    assert np.isin(sol.status, (1, 2)).all()
    assert np.isfinite(sol.cost).all()


def _entry_points():
    prob = tcar.car_parking()
    return {
        "stepwise": lambda x0s, u0s, p, **kw: td.StepwiseSolver(
            prob, _port_opts(), **kw)(x0s, u0s, p),
        "make_stepwise": lambda x0s, u0s, p, **kw: td.make_stepwise_solver(
            prob, _port_opts(), **kw)(x0s, u0s, p),
        "batched": lambda x0s, u0s, p, **kw: td.make_batched_solver(
            prob, _port_opts(), **kw)(x0s, u0s, p),
        "solve": lambda x0s, u0s, p, **kw: td.solve(
            prob, x0s[0], u0s[0], p, _port_opts(), **kw),
    }


@pytest.mark.parametrize("entry", ["stepwise", "make_stepwise", "batched",
                                   "solve"])
def test_entry_points_need_device_and_refuse_foreign_tensors(entry):
    """No entry point falls back to a default device, and none copies a
    tensor from another device onto its own."""
    run = _entry_points()[entry]
    p, x0s, u0s = _inputs()
    with pytest.raises(TypeError, match="device"):
        run(x0s[:2], u0s[:2], p)
    on_meta = torch.as_tensor(u0s[:2], device="meta")
    with pytest.raises(ValueError, match="meta"):
        run(x0s[:2], on_meta, p, device="cpu")
    p_meta = dict(p, h=torch.as_tensor(p["h"], device="meta"))
    with pytest.raises(ValueError, match="meta"):
        run(x0s[:2], u0s[:2], p_meta, device="cpu")
