"""The readers of what the program records of itself: idle time by host
span, a trip's phases from device stamps, lane-steps; and nothing, without
raising, where the program records none of it."""

import pytest
import torch

from harness import spans
from harness.cell import Run, SolveRecord
from harness.roofline import Shape
from harness.trace import DeviceOp, Trace


def _trace(host):
    """Device busy 0-10, 30-40, 70-75 and 95-100 of a window 0-100."""
    ops = [DeviceOp("k", a, d, True) for a, d in
           ((0, 10), (30, 10), (70, 5), (95, 5))]
    return Trace(window_s=100e-6, ops=ops, host=host, t0_us=0.0,
                 t1_us=100.0)


HOST = [(0.0, 100.0, "port_bench.solve"),
        (2.0, 99.0, "ddp.stepwise.call"),
        (12.0, 35.0, "ddp.stepwise.compact"),
        (45.0, 90.0, "ddp.stepwise.enqueue"),
        (60.0, 80.0, "ddp.stepwise.read_wait"),  # inside enqueue
        (61.0, 62.0, "cudaStreamSynchronize")]


def _run(spec, solves=(), trace=None, stamps=None):
    cfg = spec.config("car_parking_f32_kernel")
    run = Run(cfg=cfg, counts={}, shape=Shape(cfg, 11), batch=4,
              setup_total=1.0, solves=list(solves), window_s=1.0,
              trace=trace)
    if stamps is not None:
        run.stamps = stamps
    return run


def test_idle_goes_to_the_innermost_program_span():
    by = spans.idle_by_span(_trace(HOST))
    # gaps 10-30, 40-70, 75-95
    assert by["ddp.stepwise.compact"] == pytest.approx(18.0)  # 12-30
    assert by["ddp.stepwise.read_wait"] == pytest.approx(15.0)  # 60-70, 75-80
    assert by["ddp.stepwise.enqueue"] == pytest.approx(25.0)  # 45-60, 80-90
    assert by["ddp.stepwise.call"] == pytest.approx(2 + 5 + 5)
    assert by[None] == 0.0
    assert sum(by.values()) == pytest.approx(20 + 30 + 20)
    assert spans.idle_in(_trace(HOST), ("ddp.stepwise.enqueue",
                                        "ddp.stepwise.read_wait")) == \
        pytest.approx(40e-6)


def test_idle_readers(spec):
    run = _run(spec, trace=_trace(HOST))
    assert spec.metric_reader("loop.compact_idle_ms_per_solve")(run) == \
        pytest.approx(18e-3)
    assert spec.metric_reader("loop.chunk_edge_idle_ms_per_solve")(run) == \
        pytest.approx(40e-3)


def test_idle_outside_every_span():
    by = spans.idle_by_span(_trace([(20.0, 50.0, "ddp.solve_graph.call")]))
    assert by["ddp.solve_graph.call"] == pytest.approx(10 + 10)
    assert by[None] == pytest.approx(10 + 20 + 20)


def _trip(t0, emission, b1, b2):
    return [("body", t0), ("derivs", t0 + emission),
            ("backpass", t0 + emission + b1),
            ("linesearch", t0 + emission + b1 + b2),
            ("body_end", t0 + emission + b1 + b2 + 50)]


MS = 1_000_000  # ns


def _solve(t0):
    """A whole-solve graph of two trips: init 7 ms, trips of 10 ms
    (emission 4, B1 2, B2 3, glue 1) from body to body, the last ending
    at loop_end 1 ms after its line search."""
    return ([("solve", t0), ("loop", t0 + 7 * MS)]
            + _trip(t0 + 8 * MS, 4 * MS, 2 * MS, 3 * MS)
            + _trip(t0 + 18 * MS, 4 * MS, 2 * MS, 3 * MS)
            + [("loop_end", t0 + 28 * MS), ("solve_end", t0 + 30 * MS)])


@pytest.mark.parametrize("name,value", [
    ("device_loop.emission_ms_per_trip", 4.0),
    ("device_loop.b1_ms_per_trip", 2.0),
    ("device_loop.b2_ms_per_trip", 3.0),
    ("device_loop.glue_ms_per_trip", 1.0),
    ("solve_graph.init_ms", 7.0)])
def test_phases_of_the_untraced_solves_trips(spec, name, value):
    rec = SolveRecord(wall_s=0.03, lanes=1, traced=False)
    traced = [(t, 2 * ns) for t, ns in _solve(0)]  # slowed by the profiler
    stamps = traced + _solve(70 * MS) + _solve(110 * MS)
    run = _run(spec, [rec] * 3, stamps=stamps)
    assert spec.metric_reader(name)(run) == pytest.approx(value)


def test_a_lone_traced_solve_is_read(spec):
    rec = SolveRecord(wall_s=0.03, lanes=1, traced=True)
    run = _run(spec, [rec], stamps=_solve(0))
    assert spec.metric_reader("device_loop.b2_ms_per_trip")(run) == \
        pytest.approx(3.0)


def test_phases_sum_to_the_trip(spec):
    rec = SolveRecord(wall_s=0.03, lanes=1, traced=True)
    run = _run(spec, [rec], stamps=_solve(0))
    trip = [c["next"] - c["body"] for _, cs in spans.untraced(run)
            for c in cs]
    parts = sum(spans.phase_ms(run, a, b) for a, b in (
        ("body", "derivs"), ("derivs", "backpass"),
        ("backpass", "linesearch"), ("linesearch", "next")))
    assert parts == pytest.approx(1e-6 * sum(trip) / len(trip))


def test_emission_of_host_loop_solves(spec):
    recs = [SolveRecord(wall_s=1.0, lanes=4, traced=i == 0,
                        loop_body_calls=n) for i, n in enumerate((2, 2))]
    stamps = (_trip(0, 9 * MS, MS, MS) + _trip(20 * MS, 9 * MS, MS, MS)
              + _trip(40 * MS, 5 * MS, MS, MS)
              + _trip(60 * MS, 3 * MS, MS, MS))
    run = _run(spec, recs, stamps=stamps)
    assert spec.metric_reader("emission.device_ms_per_call")(run) == \
        pytest.approx(4.0)


def test_host_ms_per_solve(spec):
    """Walls 45 and 36 ms against device solves of 30 ms: the traced
    first solve is left out."""
    recs = [SolveRecord(wall_s=w, lanes=1, traced=i == 0)
            for i, w in enumerate((0.045, 0.036, 0.034))]
    stamps = _solve(0) + _solve(50 * MS) + _solve(100 * MS)
    run = _run(spec, recs, stamps=stamps)
    assert spec.metric_reader("solve_graph.host_ms_per_solve")(run) == \
        pytest.approx(5.0)


def test_useful_lane_steps(spec):
    recs = []
    for calls, steps in (([3, 5, 0, 5], 20), ([2, 2, 2, 2], 8)):
        r = SolveRecord(wall_s=1.0, lanes=4, traced=False,
                        out={"body_calls": torch.tensor(calls)})
        r.lane_steps = steps
        recs.append(r)
    run = _run(spec, recs)
    assert spec.metric_reader("loop.useful_lane_step_pct")(run) == \
        pytest.approx(100.0 * 21 / 28)


NEW = ["loop.useful_lane_step_pct", "loop.compact_idle_ms_per_solve",
       "loop.chunk_edge_idle_ms_per_solve", "emission.device_ms_per_call",
       "device_loop.emission_ms_per_trip", "device_loop.b1_ms_per_trip",
       "device_loop.b2_ms_per_trip", "device_loop.glue_ms_per_trip",
       "solve_graph.init_ms", "solve_graph.host_ms_per_solve"]


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_tracing_gives_nothing(spec, monkeypatch, name):
    """An older program: no ``ddp.*`` span in the trace, no stamps, no
    lane-steps counter."""
    monkeypatch.setattr(spans, "_program", lambda: None)
    rec = SolveRecord(wall_s=1.0, lanes=4, traced=True, loop_body_calls=3,
                      out={"body_calls": torch.tensor([1, 2, 3, 3])})
    host = [(0.0, 100.0, "port_bench.solve"), (1.0, 2.0, "cudaMalloc")]
    run = _run(spec, [rec], trace=_trace(host))
    assert spec.metric_reader(name)(run) is None
