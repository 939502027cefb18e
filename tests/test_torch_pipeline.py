"""``StepwiseSolver(pipeline_depth > 1)``: the active count read late
(``tests/test_batched.py:265-285`` in the port).

The late read only changes when the host learns that lanes are done,
never the lane math: every Solution field must equal the synchronous
``pipeline_depth=1`` solve bit for bit, on the static route (the kernel
path, whose CPU run is the graphed route's loop with eager body calls, and
the serial path with boxQP's Newton iteration, whose loops are device
loops) and on the eager route (``debug_level=3``, whose body call prints
from the host and whose counts are read at once), with compaction under
way: every third lane fails its initial rollout and the others finish at
different iterations.
"""

import numpy as np
import pytest

import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.models import car_parking as tcar

B, T = 12, 30


def _inputs():
    p, x0, _ = tcar.default_setup(T=T, seed=0)
    rng = np.random.default_rng(7)
    x0s = np.tile(x0, (B, 1)) + 0.3 * rng.standard_normal((B, 4))
    x0s[::3, 0] = np.nan  # status 6 at init: retired from the start
    u0s = 0.1 * rng.standard_normal((B, T, 2))
    return p, x0s, u0s


ROUTE_OPTIONS = {
    "static": dict(backpass_method="kernel", linesearch_method="kernel",
                   debug_level=0),
    "eager": dict(debug_level=3),
    "newton": dict(boxqp_method="newton", debug_level=0),
}


@pytest.mark.parametrize("route", list(ROUTE_OPTIONS))
def test_pipeline_depth_bit_identical(route):
    p, x0s, u0s = _inputs()
    opts = td.SolverOptions(max_iter=40, **ROUTE_OPTIONS[route])
    out, stats = {}, {}
    for depth in (1, 4):
        s = td.StepwiseSolver(tcar.car_parking(), opts, chunk=2,
                              compact_levels=2, min_compact_batch=2,
                              pipeline_depth=depth, device="cpu")
        out[depth] = td.to_numpy(s(x0s, u0s, p))
        stats[depth] = s.last_stats
    ref, got = out[1], out[4]
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    assert (ref.status[::3] == td.STATUS_INIT_FAILED).all()
    assert len(set(ref.iterations[1::3].tolist())) > 1
    for st in stats.values():  # both solves compacted
        assert st.eager[0] == B and len(st.eager) > 1, st
    if route != "eager":
        # masked calls after the last lane retired: more body calls, no
        # field moved
        assert stats[4].body_calls > stats[1].body_calls
    else:
        assert stats[4] == stats[1]


def test_pipeline_depth_4_matches_jax():
    """The JAX package's ``pipeline_depth=d`` reads each count ``d`` chunks
    late and the port's ``d - 1`` (its depth 1 is the synchronous read), so
    the same argument queues one chunk fewer here; the lanes' results do
    not depend on it.  The port's depth-4 solve against JAX's
    ``StepwiseSolver(pipeline_depth=4)`` on the same lanes (serial path,
    float64, compaction under way), at the tolerances of
    ``test_torch_solver._assert_matches_jax``."""
    import ddp_generator_tpu as jd
    from ddp_generator_tpu.models import car_parking as jcar

    p, x0s, u0s = _inputs()
    kw = dict(max_iter=40, debug_level=0)
    lag = dict(chunk=2, compact_levels=2, min_compact_batch=2,
               pipeline_depth=4)
    got = td.to_numpy(td.StepwiseSolver(
        tcar.car_parking(), td.SolverOptions(**kw), device="cpu", **lag)(
            x0s, u0s, p))
    ref = jd.StepwiseSolver(jcar.car_parking(), jd.SolverOptions(**kw),
                            **lag)(x0s, u0s, p)
    ref = type(got)(*(np.asarray(getattr(ref, f)) for f in got._fields))
    for f in ("status", "iterations", "body_calls", "stale_calls",
              "bp_retry_calls", "success", "log_linesearch"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    ok = np.isfinite(ref.cost)
    assert ok.sum() == 2 * B // 3
    np.testing.assert_allclose(got.cost[ok], ref.cost[ok], rtol=1e-8)
    np.testing.assert_allclose(got.xs[ok], ref.xs[ok], rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.us[ok], ref.us[ok], rtol=0, atol=1e-7)
    for f in ("lam", "dlam", "g_norm", "log_cost", "log_z"):
        np.testing.assert_allclose(getattr(got, f)[ok], getattr(ref, f)[ok],
                                   rtol=1e-6, atol=1e-9, err_msg=f)
