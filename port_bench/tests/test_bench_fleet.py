"""The mixed fleet (``car_parking_fleet_f32_kernel``) on the CPU: its
configuration is what ``scripts/make_fleet_params.py`` writes, a tiny
solve of sixteen of its vehicles through the kernels' plain versions is
correct under the cell's limits, each lane judged under its own row, and
the same lanes come out not correct when every lane ran with lane 0's
row, under the lower-precision control, or with a planted fault."""

import importlib.util
import time

import numpy as np
import pytest
import torch

from conftest import ROOT
from harness.cell import merge, run_cell

SEED = 2 ** 31 + 123
FLEET = "car_parking_fleet_f32_kernel.batch2048"
# sixteen vehicles from across the lattice (each step moves the
# wheelbase, steering and acceleration limits), the last vehicle last
ROWS = tuple(137 * k for k in range(15)) + (2047,)


def _params(spec, rows):
    cfg = spec.config(spec.workload(FLEET)["config"])
    return {k: [v[r] for r in rows] for k, v in cfg["params"].items()}


def _tiny(spec, rows=ROWS):
    return {"config": {"T": 30, "options": {"max_iter": 25},
                       "stepwise": {"min_compact_batch": 2},
                       "params": _params(spec, rows)},
            "traffic": {"batch": len(rows), "pool": 2}}


def _run(spec, mode, over=None):
    return run_cell(spec, FLEET, SEED, 0.1, False, "cpu", time.time(),
                    over or _tiny(spec), mode=mode)


@pytest.fixture(scope="module")
def sound(spec):
    return _run(spec, "sound")


def _numbers(spec, out):
    """The reference's numbers of outputs ``out`` against the vehicles' own
    rows."""
    ref = spec.reference("car_parking_fleet")
    p = {k: torch.as_tensor(np.asarray(v), dtype=torch.float64)
         for k, v in _params(spec, ROWS).items()}
    x0 = torch.as_tensor(spec.config(spec.workload(FLEET)["config"])["x0"],
                         dtype=torch.float64)
    case = {"p": p, "x0": x0.expand(out["us"].shape[0], -1)}
    return ref.numbers(case, out)


def test_config_is_the_scripts(spec):
    path = ROOT / "scripts" / "make_fleet_params.py"
    mod_spec = importlib.util.spec_from_file_location("make_fleet", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    entry = spec.configs["car_parking_fleet_f32_kernel"]
    assert (ROOT / entry["file"]).read_text() == mod.dumps(mod.config())
    cfg = spec.config("car_parking_fleet_f32_kernel")
    d = np.asarray(cfg["params"]["d"])
    w = np.asarray(cfg["params"]["limW"])
    a = np.asarray(cfg["params"]["limA"])
    assert d.shape == (2048,) and w.shape == a.shape == (2048, 2)
    assert (d.min(), d.max()) == (1.5, 3.0) and len(set(d)) == 16
    np.testing.assert_allclose((w[:, 1].min(), w[:, 1].max()), (0.3, 0.6))
    np.testing.assert_allclose((a[:, 1].min(), a[:, 1].max()), (1.0, 3.0))
    assert len(set(map(tuple, w))) == 8 and len(set(map(tuple, a))) == 16
    assert cfg["stepwise"]["batch_params"] is True


def test_sound_tiny_fleet_is_correct(sound):
    assert sound["correct"], sound["checks"]
    assert sound["failed"] == 0


def test_lane_zero_row_for_every_lane_is_not_correct(spec, sound):
    """The lanes solved with lane 0's params (wheelbase 1.5, the tightest
    limits) and judged under their own rows: the box or the dynamics
    fails."""
    wrong = _run(spec, "sound", _tiny(spec, rows=(0,) * len(ROWS)))
    run = wrong["run"]
    out = {k: torch.cat([r.out[k] for r in run.solves])
           for k in ("xs", "us", "cost", "status")}
    nums = _numbers(spec, out)
    limits = spec.limits(FLEET)["limits"]
    assert (nums["dyn"] > limits["dyn"]) or (nums["box"] > limits["box"])
    assert nums["dyn"] > limits["dyn"]  # every wheelbase but lane 0's
    # the sound outputs under the same judge pass
    good = {k: torch.cat([r.out[k] for r in sound["run"].solves])
            for k in ("xs", "us", "cost", "status")}
    assert all(v <= limits[k] for k, v in _numbers(spec, good).items())


def test_one_row_equals_the_car_parking_reference(spec, sound):
    """On params whose rows are all equal, the fleet's reference gives
    ``reference.car_parking``'s numbers."""
    out = {k: torch.cat([r.out[k] for r in sound["run"].solves]).double()
           for k in ("xs", "us", "cost", "status")}
    out["status"] = out["status"].long()
    one = {k: torch.as_tensor(np.asarray(v[0]), dtype=torch.float64)
           for k, v in _params(spec, ROWS).items()}
    x0 = torch.as_tensor(spec.config(spec.workload(FLEET)["config"])["x0"],
                         dtype=torch.float64).expand(out["us"].shape[0], -1)
    fleet = spec.reference("car_parking_fleet").numbers(
        {"p": {k: v[None].expand((4,) + v.shape) for k, v in one.items()},
         "x0": x0}, out)
    car = spec.reference("car_parking").numbers({"p": one, "x0": x0}, out)
    assert fleet.keys() == car.keys()
    for k in car:
        assert fleet[k] == pytest.approx(car[k], rel=1e-12, abs=1e-300), k


@pytest.mark.parametrize("mode", ["control", "unchanged", "half",
                                  "altered"])
def test_control_and_faults_are_not_correct(spec, mode):
    over = _tiny(spec)
    if mode == "unchanged":
        # as tests/test_bench_check.py: a lane that keeps its initial
        # inputs reads as it does at T=500 only over a horizon long enough
        # to move the car; the fault ends every lane at its first body call
        over = merge(over, {"config": {"T": 300}})
    res = _run(spec, mode, over)
    assert not res["correct"], res["checks"]
