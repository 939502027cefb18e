"""The port's ``StepwiseSolver`` surface against the JAX package's.

* Positional parameters: a call that binds every parameter by position
  stores the same values in both packages (``jax:solver.py:911-924``
  ``StepwiseSolver``, ``:1338-1350`` ``make_stepwise_solver``); in the port
  ``donate`` does nothing and ``device`` stays keyword-only.
* ``debug_level >= 3``: one line per running lane per body call with the
  fields of the JAX body's print (``jax:solver.py:755-763``), nothing at
  ``debug_level=0``.
"""

import re

import numpy as np
import pytest

import ddp_generator_tpu as jd
from ddp_generator_tpu.models import car_parking as jcar
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.models import car_parking as tcar

ATTRS = ("options", "chunk", "batch_params", "compact_levels",
         "min_compact_batch", "mesh", "pipeline_depth", "inline_below")


@pytest.mark.parametrize("args", [
    (7, True, False, 3, 2, None, "batch", 1, 5),
    (10, False, True, 4, 128, None, "lanes", 0, 0),
])
def test_positional_parameters_bind_as_in_jax(args):
    j = jd.StepwiseSolver(jcar.car_parking(), jd.SolverOptions(max_iter=9),
                          *args)
    t = td.StepwiseSolver(tcar.car_parking(), td.SolverOptions(max_iter=9),
                          *args, device="cpu")
    for a in ATTRS:
        want = getattr(j, a)
        got = getattr(t, a)
        if a == "options":
            want, got = want.max_iter, got.max_iter
        assert got == want, a
    with pytest.raises(TypeError):
        td.StepwiseSolver(tcar.car_parking(), td.SolverOptions(), *args,
                          "cpu")


def test_jax_style_call_binds_compact_levels():
    """``(p, o, 10, False, True, 4)``: donate=True, compact_levels=4."""
    s = td.StepwiseSolver(tcar.car_parking(), td.SolverOptions(), 10, False,
                          True, 4, device="cpu")
    assert (s.chunk, s.batch_params, s.compact_levels) == (10, False, 4)


def test_make_stepwise_solver_positional_as_in_jax():
    args = (6, True, None, 1, 3)
    j = jd.make_stepwise_solver(jcar.car_parking(), jd.SolverOptions(),
                                *args)
    t = td.make_stepwise_solver(tcar.car_parking(), td.SolverOptions(),
                                *args, device="cpu")
    for a in ATTRS[1:]:
        assert getattr(t, a) == getattr(j, a), a


LINE = re.compile(
    r"^lane: (\d+)  iter: (\d+)  accepted: (True|False)  cost: \S+"
    r"  reduction: \S+  gradient: \S+  z: \S+  log10\(lam\): \S+"
    r"  w_pen_l: \S+ w_pen_f: \S+$")


@pytest.mark.parametrize("level", [0, 3])
def test_debug_level_3_prints_each_lane_each_iteration(capsys, level):
    T, nb = 20, 2
    p, x0, _ = tcar.default_setup(T=T)
    u0s = 0.1 * np.random.default_rng(0).standard_normal((nb, T, 2))
    opts = td.SolverOptions(max_iter=30, debug_level=level,
                            backpass_method="kernel",
                            linesearch_method="kernel")
    sol = td.to_numpy(td.StepwiseSolver(
        tcar.car_parking(), opts, min_compact_batch=1, device="cpu")(
            np.tile(x0, (nb, 1)), u0s, p))
    out = capsys.readouterr().out
    if level == 0:
        assert out == ""
        return
    rows = [LINE.match(ln) for ln in out.splitlines()]
    assert rows and all(rows), out[:500]
    for b in range(nb):
        mine = [r for r in rows if int(r.group(1)) == b]
        # one line per body call of the lane, iterations counted from 1
        assert len(mine) == sol.body_calls[b]
        assert int(mine[0].group(2)) == 1
        # the accept that meets tolFun ends the loop without counting an
        # iteration, and prints c.it + 1, as the JAX body does
        assert sol.status[b] == td.STATUS_SUCCESS_TOLFUN
        assert int(mine[-1].group(2)) == sol.iterations[b] + 1
        assert mine[-1].group(3) == "True"
