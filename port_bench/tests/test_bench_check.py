"""The check that decides ``correct``: the reference passes the port's own
toy solves on the CPU (the kernels' plain versions) and fails the same
outputs perturbed; the lower-precision control and each planted fault
that a cell can have come out as not correct."""

import time

import pytest
import torch

from conftest import TINY
from harness.cell import merge, run_cell

SEED = 2 ** 31 + 99
CAR = "car_parking_f32_kernel.batch2048"
SINGLE = "car_parking_f32_kernel.single"


def _check(spec, workload, mode):
    return run_cell(spec, workload, SEED, 0.1, False, "cpu", time.time(),
                    TINY[workload], mode=mode)


@pytest.fixture(scope="module")
def sound(spec):
    return {w: _check(spec, w, "sound") for w in (CAR, SINGLE)}


def _numbers(spec, workload, run, change):
    """The reference's numbers of the sound run's outputs, changed."""
    out = {k: torch.cat([r.out[k] for r in run.solves])
           for k in ("xs", "us", "cost", "status")}
    change(out)
    from harness import inputs

    cfg = run.cfg
    p = {k: torch.as_tensor(v, dtype=torch.float64)
         for k, v in inputs.params(cfg).items()}
    x0 = torch.as_tensor(cfg["x0"], dtype=getattr(torch, cfg["dtype"]))
    case = {"p": p, "x0": x0.double().expand(out["us"].shape[0], -1)}
    nums = spec.reference(cfg["reference"]).numbers(case, out)
    limits = spec.limits(workload)["limits"]
    return {k: v for k, v in nums.items() if not v <= limits[k]}


@pytest.mark.parametrize("workload", [CAR, SINGLE])
def test_sound_toy_solve_is_correct(sound, workload):
    res = sound[workload]
    assert res["correct"], res["checks"]


PERTURB = {
    "xs": lambda o: o["xs"].__setitem__((0, 5, 0), o["xs"][0, 5, 0] + 1e-3),
    "us": lambda o: o["us"].__setitem__((1, 3, -1), o["us"][1, 3, -1] + 1e-2),
    "cost": lambda o: o["cost"].__setitem__(0, o["cost"][0] * 1.001),
    "status": lambda o: o["status"].fill_(7),
    "box": lambda o: o["us"].__setitem__((2, 0, 1), 2.5),
}


@pytest.mark.parametrize("what", sorted(PERTURB))
def test_car_reference_fails_perturbed_outputs(spec, sound, what):
    failed = _numbers(spec, CAR, sound[CAR]["run"], PERTURB[what])
    assert failed, what


@pytest.mark.parametrize("workload", [CAR, SINGLE])
def test_control_is_not_correct(spec, workload):
    res = _check(spec, workload, "control")
    assert not res["correct"]
    assert res["checks"]["dyn"]["value"] > res["checks"]["dyn"]["limit"]


@pytest.mark.parametrize("workload,fault", [
    (CAR, "unchanged"), (CAR, "stalled"), (CAR, "half"), (CAR, "altered"),
    (SINGLE, "unchanged"), (SINGLE, "stalled"), (SINGLE, "altered")])
def test_planted_fault_is_not_correct(spec, workload, fault):
    over = TINY[workload]
    if fault == "unchanged":
        # a lane that keeps its initial inputs reads as it does at T=500
        # only over a horizon long enough to move the car; the fault ends
        # every lane at its first body call, so a long one costs little
        over = merge(over, {"config": {"T": 300}})
    res = run_cell(spec, workload, SEED, 0.1, False, "cpu", time.time(),
                   over, mode=fault)
    assert not res["correct"], (fault, res["checks"])
