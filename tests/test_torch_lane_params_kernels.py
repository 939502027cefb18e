"""Per-lane params on the kernel path: the emission kernel and kernel B2
read each lane's own params (their plain versions here: ``cm_emit`` and
``rollout_plain`` with :class:`~ddp_generator_tpu_torch.problem.LaneParams`),
float64 on the CPU, B=8, T=40.

* CarParking with ``d``, ``limW`` and ``limA`` per lane (a small mixed
  fleet): each lane equals its own shared-params solve on the same path,
  status, iterations, body, stale and retry calls exactly, ``xs``, ``us``
  and ``cost`` bit for bit; the same lanes equal the JAX package's
  ``batch_params=True`` solve (its serial line search) to 1e-10; the
  benchmark's fleet reference (``port_bench/reference/car_parking_fleet.py``)
  judges them correct within the fleet cell's limits, and the same lanes
  solved with lane 0's row for every lane come out not correct;
* ``brachistochrone_hli`` with its floor ``ymin`` per lane (a
  ``[k]``-indexed per-lane leaf), held the same way against each lane's
  own solve and the JAX package.
"""

import functools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.models import brachistochrone as tbr
from ddp_generator_tpu_torch.models import car_parking as tcar
from ddp_generator_tpu_torch.ops import cuda_rollout as cr
from ddp_generator_tpu_torch.problem import lanes_last
from test_torch_batch_params import (
    COUNTS,
    _assert_lanes_match,
    _jax_solve,
    _per_lane,
)
from ddp_generator_tpu.models import brachistochrone as jbr
from ddp_generator_tpu.models import car_parking as jcar

ROOT = Path(__file__).resolve().parent.parent
T, B, MAX_ITER = 40, 8, 30
FLEET_CELL = "car_parking_fleet_f32_kernel.batch2048"
OPTS = dict(max_iter=MAX_ITER, debug_level=0, backpass_method="kernel",
            linesearch_method="kernel")
BRACHI = dict(max_iter=25, w_pen_init_l=40.0, w_pen_init_f=1e-5,
              w_pen_max_f=1.0, full_ddp=False)


def _fleet():
    """Eight vehicles: wheelbase 1.5-3.0, steering limit +-0.6-0.3 and
    acceleration limit +-3-1, each on its own lattice line."""
    p, x0, _ = jcar.default_setup(T=T)
    pb = _per_lane(p, B)
    pb["d"] = np.linspace(1.5, 3.0, B)
    w = np.linspace(0.6, 0.3, B)
    a = np.roll(np.linspace(3.0, 1.0, B), 3)
    pb["limW"] = np.stack([-w, w], axis=1)
    pb["limA"] = np.stack([-a, a], axis=1)
    x0s = np.tile(x0, (B, 1))
    u0s = 0.1 * np.random.default_rng(0).standard_normal((B, T, 2))
    return pb, x0s, u0s


def _brachi():
    n, nb = 20, 3
    p, x0, _ = jbr.default_setup_hli(n)
    pb = _per_lane(p, nb)
    pb["ymin"] = pb["ymin"] + np.array([0.0, -0.3, 0.5])[:, None]
    u0s = -np.abs(np.random.default_rng(2).uniform(0.5, 1.5, (nb, n, 1)))
    return pb, np.tile(x0, (nb, 1)), u0s


def _stepwise(problem, x0s, u0s, p, batch_params, **kw):
    return td.to_numpy(td.StepwiseSolver(
        problem, td.SolverOptions(**dict(OPTS, **kw)), chunk=3,
        batch_params=batch_params, compact_levels=2, min_compact_batch=2,
        device="cpu")(x0s, u0s, p))


CASES = {
    "car_parking": (tcar.car_parking, jcar.car_parking, _fleet, {}),
    "brachistochrone_hli": (tbr.brachistochrone_hli,
                            jbr.brachistochrone_hli, _brachi, BRACHI),
}


@functools.lru_cache(maxsize=None)
def _solved(name):
    make, make_jax, inputs, kw = CASES[name]
    pb, x0s, u0s = inputs()
    out = _stepwise(make(), x0s, u0s, pb, True, **kw)
    return name, make, make_jax, (pb, x0s, u0s), kw, out


@pytest.fixture(params=list(CASES))
def case(request):
    return _solved(request.param)


def test_runs_the_kernels_plain_versions(monkeypatch):
    """The per-lane kernel path's line search is B2's (``rollout_plain``
    on LaneParams), not the serial one."""
    from ddp_generator_tpu_torch import solver as slv

    calls = []
    plain = cr.rollout_plain
    monkeypatch.setattr(cr, "rollout_plain", lambda *a, **kw: (
        calls.append(type(a[14]).__name__), plain(*a, **kw))[1])
    monkeypatch.setattr(slv, "line_search", lambda *a, **kw: (
        _ for _ in ()).throw(AssertionError("the serial line search ran")))
    pb, x0s, u0s = _fleet()
    o = td.SolverOptions(**OPTS).replace(max_iter=2)
    td.StepwiseSolver(tcar.car_parking(), o, chunk=3, batch_params=True,
                      device="cpu")(x0s, u0s, pb)
    assert calls and set(calls) == {"LaneParams"}


def test_each_lane_equals_its_shared_solve(case):
    name, make, _, (pb, x0s, u0s), kw, out = case
    for b in range(x0s.shape[0]):
        one = _stepwise(make(), x0s[b:b + 1], u0s[b:b + 1],
                        {k: v[b] for k, v in pb.items()}, False, **kw)
        for f in COUNTS + ("xs", "us", "cost"):
            np.testing.assert_array_equal(getattr(out, f)[b],
                                          getattr(one, f)[0],
                                          err_msg=f"{name} {f} lane {b}")


def test_lanes_match_jax(case):
    """Against the JAX package's per-lane solve, whose ``"pallas"`` path
    falls back to its serial line search (``jax:solver.py:458-462``)."""
    name, _, make_jax, (pb, x0s, u0s), kw, out = case
    ref = _jax_solve(make_jax(), x0s, u0s, pb, "kernel",
                     **dict({"max_iter": MAX_ITER}, **kw))
    _assert_lanes_match(out, ref)
    assert np.isin(out.status, (1, 2)).all()


def _fleet_numbers(pb, x0s, out):
    sys.path.insert(0, str(ROOT / "port_bench"))
    try:
        from reference import car_parking_fleet as ref
    finally:
        sys.path.remove(str(ROOT / "port_bench"))
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    case = {"p": {k: t(v) for k, v in pb.items()}, "x0": t(x0s)}
    res = {k: t(getattr(out, k)) for k in ("xs", "us", "cost")}
    res["status"] = torch.as_tensor(out.status)
    return ref.numbers(case, res)


def _limits():
    path = ROOT / "port_bench" / "limits" / f"{FLEET_CELL}.json"
    return json.loads(path.read_text())["limits"]


def test_fleet_reference_judges_the_lanes_correct():
    _, _, _, (pb, x0s, _), _, out = _solved("car_parking")
    nums, lim = _fleet_numbers(pb, x0s, out), _limits()
    assert all(v <= lim[k] for k, v in nums.items()), nums


def test_lane_zero_row_for_every_lane_fails_the_fleet_reference():
    _, make, _, (pb, x0s, u0s), kw, _ = _solved("car_parking")
    wrong = _stepwise(make(), x0s, u0s, {k: v[0] for k, v in pb.items()},
                      False, **kw)
    nums, lim = _fleet_numbers(pb, x0s, wrong), _limits()
    assert nums["box"] > lim["box"] or nums["dyn"] > lim["dyn"], nums


def test_per_lane_rows_are_each_lanes_flat_params():
    """``flat_params`` of LaneParams: row ``b`` is the flat array of lane
    ``b``'s params (the hand-written model's order; the ``[k]``-indexed
    tail of brachistochrone_hli per lane), and ``take`` carries rows."""
    for make, (pb, _, u0s) in ((tcar.car_parking, _fleet()),
                               (tbr.brachistochrone_hli, _brachi())):
        model = make().cuda_model
        nb, N = u0s.shape[0], u0s.shape[1]
        lanes = lanes_last(td.to_torch(pb, torch.float64, "cpu"), nb)
        rows = model.flat_params(lanes, torch.float64, "cpu", N)
        assert rows.shape[0] == nb and rows.is_contiguous()
        for b in range(nb):
            one = td.to_torch({k: v[b] for k, v in pb.items()},
                              torch.float64, "cpu")
            assert torch.equal(rows[b], model.flat_params(
                one, torch.float64, "cpu", N))
        lanes.rows = rows
        idx = torch.tensor([nb - 1, 0])
        assert torch.equal(lanes.take(idx).rows, rows[idx])


@pytest.mark.parametrize("backpass, device, refused", [
    ("fused", "cuda", True),  # B3 reads one shared param vector
    ("fused", "cpu", False),  # the plain versions stand in on the CPU
    ("kernel", "cuda", False),  # emission kernel, B1, B2 read the rows
])
def test_require_kernels_refuses_a_torch_route(backpass, device, refused):
    """``StepwiseSolver(..., require_kernels=True)`` refuses per-lane params
    where a torch route would run in place of a named kernel, before it
    touches the device."""
    from ddp_generator_tpu_torch import solver as slv

    o = td.SolverOptions(**OPTS).replace(backpass_method=backpass)
    if refused:
        with pytest.raises(NotImplementedError, match="require_kernels"):
            td.StepwiseSolver(tcar.car_parking(), o, batch_params=True,
                              device=device, require_kernels=True)
    elif device == "cpu":
        td.StepwiseSolver(tcar.car_parking(), o, batch_params=True,
                          device=device, require_kernels=True)
    else:
        slv._check_kernels(device, o, True)
    slv._check_kernels(device, o, False)  # shared params: every kernel
