"""The window's arithmetic: whole solves, all lanes over all the time."""

import statistics

import pytest
import torch

from harness.cell import Run, SolveRecord
from harness.roofline import Shape


def _run(spec, walls, solved, window_s, traced=(), trips=None):
    cfg = spec.config("car_parking_f32_kernel")
    solves = [SolveRecord(wall_s=w, lanes=2048, traced=i in traced,
                          loop_body_calls=100, replays=90, host_reads=12)
              for i, w in enumerate(walls)]
    return Run(cfg=cfg, counts={}, shape=Shape(cfg, 11), batch=2048,
               setup_total=3.0, solves=solves, window_s=window_s,
               solved=solved, trips=trips or [150] * len(walls))


def test_solved_per_s_is_all_solved_lanes_over_the_whole_window(spec):
    run = _run(spec, [6.0, 6.5, 6.2], solved=3 * 2030, window_s=18.9)
    rate = spec.metric_reader("solved_per_s")(run)
    assert rate == pytest.approx(6090 / 18.9)


def test_solve_ms_p50_counts_every_solve(spec):
    walls = [0.8, 0.9, 0.7, 1.9]
    run = _run(spec, walls, solved=4, window_s=sum(walls))
    assert spec.metric_reader("solve_ms_p50")(run) == pytest.approx(
        1e3 * statistics.median(walls))


def test_loop_counts_are_means_per_solve(spec):
    run = _run(spec, [1.0, 1.0], solved=2, window_s=2.0)
    assert spec.metric_reader("loop.host_reads_per_solve")(run) == 12
    assert spec.metric_reader("loop.replays_per_solve")(run) == 90


def test_trip_ms_leaves_out_traced_solves(spec):
    run = _run(spec, [2.0, 0.8, 0.9], solved=3, window_s=3.7, traced=(0,),
               trips=[100, 160, 180])
    assert spec.metric_reader("device_loop.trip_ms")(run) == pytest.approx(
        1e3 * 1.7 / 340)
    assert spec.metric_reader("device_loop.trips_per_solve")(
        run) == pytest.approx(440 / 3)


def test_no_solve_no_value(spec):
    run = _run(spec, [], solved=0, window_s=0.0)
    for name in ("solved_per_s", "solve_ms_p50", "device_idle_pct.batch",
                 "b1_roofline_pct", "torch_ops_ms_per_call"):
        assert spec.metric_reader(name)(run) is None


@pytest.mark.parametrize("traffic", ["batch2048", "single"])
def test_inputs_repeat_by_seed_and_differ_across_seeds(spec, traffic):
    from harness import inputs

    cfg = spec.config("car_parking_f32_kernel")
    t = dict(spec.traffic(traffic), pool=2)
    batch = int(t["batch"])
    a = inputs.pool(cfg, t, 2 ** 33 + 5, "cpu", 30, batch)
    b = inputs.pool(cfg, t, 2 ** 33 + 5, "cpu", 30, batch)
    c = inputs.pool(cfg, t, 2 ** 33 + 6, "cpu", 30, batch)
    assert torch.equal(a[1], b[1]) and not torch.equal(a[1], c[1])
    assert a[1].dtype == torch.float32 and a[1].shape == (2, batch, 30, 2)
    assert not torch.equal(a[1][0], a[1][1])


def test_generator_formats_a_configuration_may_use():
    from harness import inputs

    ymin = inputs.param_value({"linspace": [-1.0, -5.0, 5], "append": [-4.0]})
    assert ymin.tolist() == [-1.0, -2.0, -3.0, -4.0, -5.0, -4.0]
    u = inputs.draw_u0(inputs.generator(2 ** 32 + 1, "cpu"),
                       {"dist": "neg_uniform", "low": 0.5, "high": 1.5},
                       (3, 40, 1), torch.float64, "cpu")
    assert u.shape == (3, 40, 1) and bool(((u <= -0.5) & (u >= -1.5)).all())
