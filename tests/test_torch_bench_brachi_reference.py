"""The plain reference of the benchmark's ``brachistochrone_hli`` cell
(``port_bench/reference/brachistochrone_hli.py``, loaded by path) against
the port on the CPU, float64: its model (dynamics, travel time, floor,
terminal gap) against the port's ``forward_pass`` and ``cost_only``; a small
solve of the configuration through the benchmark's own harness judged
correct by the reference's numbers; and the float32 control and each
planted fault judged not correct.  Small shapes (T=50) stand in for the
cell's T=500; the limits are the cell's own."""

import importlib
import importlib.util
import math
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.models import brachistochrone as tbr
from ddp_generator_tpu_torch.ops.forward import cost_only, forward_pass

BENCH = Path(__file__).resolve().parent.parent / "port_bench"
CELL = "brachistochrone_hli_f64_fused.single"
T, B = 50, 8


def _reference():
    """``port_bench/reference`` as the package ``port_bench_reference``,
    and its ``brachistochrone_hli`` module."""
    name = "port_bench_reference"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, BENCH / "reference" / "__init__.py",
            submodule_search_locations=[str(BENCH / "reference")])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module(f"{name}.brachistochrone_hli")


def _case(seed=5):
    p_np, x0, _ = tbr.default_setup_hli(T)
    g = torch.Generator().manual_seed(seed)
    us = -(0.5 + torch.rand((B, T, 1), generator=g, dtype=torch.float64))
    p = td.params_from_jax(p_np, torch.float64, "cpu")
    x0s = torch.as_tensor(np.tile(x0, (B, 1)))
    return p, x0s, us


def test_reference_model_matches_the_port():
    ref = _reference()
    problem = tbr.brachistochrone_hli()
    p, x0s, us = _case()
    m = td.init_multipliers(problem, B, T, torch.float64, "cpu")
    zero = torch.zeros(B, dtype=torch.float64)
    r = forward_pass(problem, x0s, None, us, None, None, 0.0, p,
                     m.mu_le, m.mu_li * 0.0, m.mu_fe, m.mu_fi, zero, zero)
    xs = ref.common.rollout(ref.f, x0s, us, p)
    tol = dict(rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(r.xs, xs, **tol)
    # with no multiplier and no weight the port's cost is the travel time
    travel = ref.common.total_cost(ref.L, ref.F, xs, us, p)
    torch.testing.assert_close(r.cost, travel, **tol)
    # the floor and the terminal gap against the port's hli and hfe
    k = torch.arange(T)[:, None]
    x_cm = xs[:, :T].permute(2, 1, 0)
    hli = problem.hli[0](x_cm, us.permute(2, 1, 0), p, k)  # (T, B)
    torch.testing.assert_close(ref.floor(xs, p),
                               hli.clamp(min=0.0).amax(0), **tol)
    hfe = problem.hfe[0](xs[:, T].T, p, T)
    torch.testing.assert_close(ref.terminal(xs, p), hfe.abs(), **tol)
    assert (ref.floor(xs, p) > 0).any() and (ref.terminal(xs, p) > 0).all()
    # under live multipliers and weights, cost_only is the travel time plus
    # the AL penalties of the reference's constraint values
    g = torch.Generator().manual_seed(6)
    mu_li = torch.rand((B, T, 1), generator=g, dtype=torch.float64)
    mu_fe = torch.randn((B, 1), generator=g, dtype=torch.float64)
    wl = 1.0 + 40.0 * torch.rand(B, generator=g, dtype=torch.float64)
    wf = 1.0 + 40.0 * torch.rand(B, generator=g, dtype=torch.float64)
    h = p["ymin"][:T] - xs[:, :T, 0]
    mu, w = mu_li[..., 0], wl[:, None]
    pen_l = torch.where(h >= 0, mu * h * (1 + w * h), mu * h / (1 - w * h))
    hf = xs[:, T, 0] - p["ymin"][T]
    want = (travel + pen_l.sum(1) + mu_fe[:, 0] * hf + 0.5 * wf * hf * hf)
    got = cost_only(problem, xs, us, p, m.mu_le, mu_li, mu_fe, m.mu_fi, wl,
                    wf)
    torch.testing.assert_close(got, want, **tol)


# The cell at T=50 on the CPU: the harness's own set-up, window and check
# (plain versions of the kernels), a window of one or two solves.
SMALL = {"config": {"T": T, "params": {
    "dx": 2.0 * math.pi / T,
    "ymin": {"linspace": [-1.0, -5.0, T], "append": [-4.0]}}},
    "traffic": {"pool": 2}}
# 'half' leaves out half of a batch's lanes: a batch of 8 through
# StepwiseSolver (at the cell's one lane it leaves out none)
BATCH = {"config": dict(SMALL["config"], stepwise={"min_compact_batch": 2}),
         "traffic": {"entry": "stepwise", "batch": B, "pool": 1}}
SEED = 2 ** 31 + 7


@pytest.fixture(scope="module")
def harness():
    for p in (str(BENCH), str(BENCH.parent)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness.cell import run_cell
    from harness.spec import Spec

    return Spec(), run_cell


def _check(harness, mode, over=SMALL):
    spec, run_cell = harness
    return run_cell(spec, CELL, SEED, 0.1, False, "cpu", time.time(), over,
                    mode=mode)


def test_small_solve_is_correct(harness):
    res = _check(harness, "sound")
    assert res["correct"], res["checks"]
    assert res["checks"]["unsolved"]["value"] == 0.0


@pytest.mark.parametrize("mode,over", [
    ("control", SMALL), ("unchanged", SMALL), ("stalled", SMALL),
    ("altered", SMALL), ("half", BATCH)])
def test_control_and_faults_are_not_correct(harness, mode, over):
    res = _check(harness, mode, over)
    assert not res["correct"], (mode, res["checks"])
    failed = [k for k, c in res["checks"].items()
              if not c["value"] <= c["limit"]]
    assert failed, (mode, res["checks"])
