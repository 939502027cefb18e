"""The readers of the layers the ``brachistochrone_hli`` cell adds: a trip's
B3 and AL phases from device stamps, the AL multiplier updates a solve and
B3's roofline share at one lane, on synthetic stamps and counts; nothing,
without raising, where the program or its path records none of it.  And
the program's side, on the CPU: the ``al`` stamp and the update count
exist only where the problem has AL families, so a problem without them
(CarParking) gets no new graph node."""

import numpy as np
import pytest

from harness import roofline
from harness.cell import Run, SolveRecord
from harness.roofline import Shape

CONFIG = "brachistochrone_hli_f64_fused"
MS = 1_000_000  # ns


def _trip(t0, b3, b2, al):
    """A fused-path trip (no ``derivs`` stamp): B3, B2, then the AL work."""
    return [("body", t0), ("backpass", t0 + b3),
            ("linesearch", t0 + b3 + b2), ("al", t0 + b3 + b2 + al),
            ("body_end", t0 + b3 + b2 + al + 50)]


def _solve(t0):
    """A whole-solve graph: init 5 ms, two trips of 10 ms (B3 6, B2 2, AL
    1.5, the rest 0.5), the last ending at loop_end."""
    return ([("solve", t0), ("loop", t0 + 5 * MS)]
            + _trip(t0 + 5 * MS, 6 * MS, 2 * MS, 3 * MS // 2)
            + _trip(t0 + 15 * MS, 6 * MS, 2 * MS, 3 * MS // 2)
            + [("loop_end", t0 + 25 * MS), ("solve_end", t0 + 26 * MS)])


def _run(spec, stamps, launches=None, n=3):
    cfg = spec.config(CONFIG)
    recs = [SolveRecord(wall_s=0.03, lanes=1, traced=i == 0)
            for i in range(n)]
    run = Run(cfg=cfg, counts=spec.counts(CONFIG), shape=Shape(cfg, 11),
              batch=1, setup_total=1.0, solves=recs, window_s=1.0,
              launches=launches, trips=[2] * n)
    run.stamps = stamps
    return run


def _stamps():
    traced = [(t, 2 * ns) for t, ns in _solve(0)]  # slowed by the profiler
    return traced + _solve(70 * MS) + _solve(110 * MS)


@pytest.mark.parametrize("name,value", [
    ("device_loop.b3_ms_per_trip", 6.0),
    ("device_loop.b2_ms_per_trip", 2.0),
    ("device_loop.al_ms_per_trip", 1.5),
    ("device_loop.glue_ms_per_trip", 2.0),
    ("solve_graph.init_ms", 5.0)])
def test_fused_trip_phases(spec, name, value):
    run = _run(spec, _stamps())
    assert spec.metric_reader(name)(run) == pytest.approx(value)


def test_b3_roofline_at_one_lane(spec):
    """Two launches over the traced solve's two trips, against 6 ms of B3
    a trip: the bound of one launch at width 1 over 6 ms."""
    run = _run(spec, _stamps(), launches={"fused": 2})
    bound = roofline.launch_bound_s(roofline.B3, 1, run.shape, run.counts)
    got = spec.metric_reader("b3_roofline_pct")(run)
    assert got == pytest.approx(100.0 * bound / 6e-3)
    assert 0.0 < got <= 100.0
    # four launches a trip (lambda retries): four bounds in the same time
    run = _run(spec, _stamps(), launches={"fused": 8})
    assert spec.metric_reader("b3_roofline_pct")(run) == \
        pytest.approx(4 * got)


def test_b3_readers_read_nothing_where_trips_stamp_derivs(spec):
    """The kernel path's trips (emission, then B1): ``body`` to
    ``backpass`` is not B3."""
    stamps = []
    for t0 in (0, 70 * MS):
        stamps += [("solve", t0), ("loop", t0 + MS), ("body", t0 + 2 * MS),
                   ("derivs", t0 + 3 * MS), ("backpass", t0 + 4 * MS),
                   ("linesearch", t0 + 5 * MS), ("body_end", t0 + 6 * MS),
                   ("loop_end", t0 + 7 * MS), ("solve_end", t0 + 8 * MS)]
    run = _run(spec, stamps, launches={"fused": 0, "backpass": 1}, n=2)
    for name in ("device_loop.b3_ms_per_trip", "b3_roofline_pct",
                 "device_loop.al_ms_per_trip"):
        assert spec.metric_reader(name)(run) is None, name


def test_al_updates_per_solve(spec, monkeypatch):
    from ddp_generator_tpu_torch import launches

    monkeypatch.setattr(launches, "read_al_updates", lambda: 45)
    run = _run(spec, _stamps())
    assert spec.metric_reader("al.updates_per_solve")(run) == \
        pytest.approx(15.0)


def test_a_program_without_the_al_records_gives_nothing(spec, monkeypatch):
    """An older program: no ``al`` stamp, no update count."""
    from ddp_generator_tpu_torch import launches

    monkeypatch.delattr(launches, "read_al_updates")
    stamps = [(t, ns) for t, ns in _stamps() if t != "al"]
    run = _run(spec, stamps)
    assert spec.metric_reader("al.updates_per_solve")(run) is None
    assert spec.metric_reader("device_loop.al_ms_per_trip")(run) is None
    assert spec.metric_reader("device_loop.b3_ms_per_trip")(run) == \
        pytest.approx(6.0)


@pytest.mark.parametrize("model", ["car_parking", "brachistochrone_hli"])
def test_al_stamp_and_count_only_with_al_families(monkeypatch, model):
    """Every body call of a problem with AL families stamps ``al`` once and
    counts its multiplier updates once; CarParking's body calls do
    neither."""
    import ddp_generator_tpu_torch as td
    from ddp_generator_tpu_torch import launches
    from ddp_generator_tpu_torch.models import brachistochrone, car_parking

    tags, counted = [], []
    count = launches.count_al_updates
    monkeypatch.setattr(launches, "stamp",
                        lambda tag, device: tags.append(tag))
    monkeypatch.setattr(launches, "count_al_updates",
                        lambda upd: (counted.append(int(upd.sum())),
                                     count(upd)))
    rng = np.random.default_rng(4)
    if model == "car_parking":
        problem = car_parking.car_parking()
        p, x0, _ = car_parking.default_setup(T=10, seed=0)
        u0s = 0.1 * rng.standard_normal((4, 10, 2))
        opts = td.SolverOptions(max_iter=6, backpass_method="kernel",
                                linesearch_method="kernel")
    else:
        problem = brachistochrone.brachistochrone_hli()
        p, x0, _ = brachistochrone.default_setup_hli(10)
        u0s = -(0.5 + rng.random((4, 10, 1)))
        opts = td.SolverOptions(max_iter=20, w_pen_init_l=40.0,
                                w_pen_init_f=1e-5, w_pen_max_f=1.0,
                                w_pen_fact2=1.0, full_ddp=False,
                                backpass_method="fused",
                                linesearch_method="kernel")
    launches.reset_launches()
    solver = td.StepwiseSolver(problem, opts, min_compact_batch=2,
                               device="cpu")
    sol = solver(np.tile(x0, (4, 1)), u0s, p)
    calls = solver.last_stats.body_calls
    if model == "car_parking":
        assert "al" not in tags and not counted
        assert launches.read_al_updates() == 0
    else:
        body = ["body", "backpass", "linesearch", "al", "body_end"]
        assert tags == body * calls and len(counted) == calls
        updates = launches.read_al_updates()
        assert updates == sum(counted)
        assert 0 < updates <= int(sol.body_calls.sum())


def test_tiny_run_of_the_cell_is_correct(spec):
    """The cell's whole run on the CPU at T=50 (the kernels' plain
    versions): a correct line with its end-to-end metrics."""
    import math
    import time

    from harness.cell import run_cell

    T = 50
    over = {"config": {"T": T, "params": {
        "dx": 2.0 * math.pi / T,
        "ymin": {"linspace": [-1.0, -5.0, T], "append": [-4.0]}}},
        "traffic": {"pool": 2}}
    cell = CONFIG + ".single"
    line = run_cell(spec, cell, 2 ** 31 + 12345, 0.5, False, "cpu",
                    time.time(), over)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {
        m["name"] for m in spec.metrics_for(cell, trace=False)} == {
        "solve_ms_p50", "setup_s"}
    assert set(line["checks"]) == {"dyn", "floor", "terminal", "cost_p50",
                                   "descent_p90", "unsolved"}
