"""The readers of a solve's initial rollout (``harness/initial.py``): the
launch count ``init_rollout`` over the traced solve and the stamps
``init`` to ``init_end`` over the untraced ones, on synthetic launches and
stamps of both entries; nothing, without raising, on a program without
them.  And every reader of the stamps before them gives the same numbers
with ``init``/``init_end`` stamps interleaved."""

import pytest

from harness import spans
from harness.cell import Run, SolveRecord
from harness.roofline import Shape

MS = 1_000_000  # ns
SINGLE = ("init.kernel_rollout_pct.single", "init.device_ms_per_solve.single")
BATCH = ("init.kernel_rollout_pct.batch", "init.device_ms_per_solve.batch")


def _trip(t0, fused=False):
    """A trip of 10 ms: emission 4 (none on the fused path, whose B3 takes
    the 4 and B1's 2), B1 2, B2 3, AL 0.5 on the fused path, glue."""
    if fused:
        return [("body", t0), ("backpass", t0 + 6 * MS),
                ("linesearch", t0 + 9 * MS), ("al", t0 + 9 * MS + MS // 2),
                ("body_end", t0 + 9 * MS + MS // 2 + 50)]
    return [("body", t0), ("derivs", t0 + 4 * MS), ("backpass", t0 + 6 * MS),
            ("linesearch", t0 + 9 * MS), ("body_end", t0 + 9 * MS + 50)]


def _graph_solve(t0, init_ms, fused=False, init=True):
    """A whole-solve graph: ``init_fn`` of ``init_ms`` (stamped where
    ``init``) 1 ms after ``solve``, ``loop`` 1 ms later, two trips,
    ``loop_end``, ``solve_end``."""
    loop = t0 + (2 + init_ms) * MS
    own = ([("init", t0 + MS), ("init_end", t0 + (1 + init_ms) * MS)]
           if init else [])
    return ([("solve", t0)] + own + [("loop", loop)]
            + _trip(loop + MS, fused) + _trip(loop + 11 * MS, fused)
            + [("loop_end", loop + 21 * MS), ("solve_end", loop + 22 * MS)])


def _graph_stamps(inits, fused=False, init=True):
    """One whole-solve graph per entry of ``inits`` (its init ms), 100 ms
    apart; the first, traced, slowed twofold by the profiler."""
    out = []
    for i, ms in enumerate(inits):
        s = _graph_solve(100 * MS * i, ms, fused, init)
        out += [(t, 2 * ns) for t, ns in s] if i == 0 else s
    return out


def _host_stamps(inits, calls=2, init=True):
    """A host loop's solves: ``init`` to ``init_end`` of each entry of
    ``inits`` ms (where ``init``), then ``calls`` body calls."""
    out, t = [], 0
    for ms in inits:
        if init:
            out += [("init", t), ("init_end", t + ms * MS)]
        t += (ms + 1) * MS
        for _ in range(calls):
            out += _trip(t)
            t += 10 * MS
    return out


def _run(spec, config, n, stamps=None, launches=None, traced=True, batch=1,
         calls=0):
    cfg = spec.config(config)
    recs = [SolveRecord(wall_s=0.05, lanes=batch, traced=traced and i == 0,
                        loop_body_calls=calls) for i in range(n)]
    run = Run(cfg=cfg, counts=spec.counts(config), shape=Shape(cfg, 11),
              batch=batch, setup_total=1.0, solves=recs, window_s=1.0,
              trace=object() if traced else None, launches=launches,
              trips=[2] * n)
    if stamps is not None:
        run.stamps = stamps
    return run


COUNTS = {"backpass": 40, "fused": 0, "rollout_multi": 30,
          "rollout_selected": 41, "emit": 40}


@pytest.mark.parametrize("init_rollout,value", [(1, 100.0), (0, 0.0)])
@pytest.mark.parametrize("name", [SINGLE[0], BATCH[0]])
def test_kernel_rollout_pct(spec, name, init_rollout, value):
    run = _run(spec, "car_parking_f32_kernel", 3,
               launches=dict(COUNTS, init_rollout=init_rollout))
    assert spec.metric_reader(name)(run) == pytest.approx(value)


@pytest.mark.parametrize("name", [SINGLE[0], BATCH[0]])
def test_kernel_rollout_pct_needs_the_traced_solve(spec, name):
    """No trace, or no traced solve among the records: nothing."""
    launches = dict(COUNTS, init_rollout=1)
    assert spec.metric_reader(name)(_run(
        spec, "car_parking_f32_kernel", 3, launches=launches,
        traced=False)) is None
    run = _run(spec, "car_parking_f32_kernel", 3, launches=launches)
    run.solves[0].traced = False
    assert spec.metric_reader(name)(run) is None


@pytest.mark.parametrize("config,fused", [
    ("car_parking_f32_kernel", False),
    ("brachistochrone_hli_f64_fused", True)])
def test_device_ms_of_whole_solve_graphs(spec, config, fused):
    """The untraced solves' init of 5 and 3 ms: 4; the traced first one,
    slowed by the profiler, is left out."""
    run = _run(spec, config, 3, stamps=_graph_stamps((9, 5, 3), fused))
    assert spec.metric_reader(SINGLE[1])(run) == pytest.approx(4.0)


def test_device_ms_of_host_loop_solves(spec):
    run = _run(spec, "car_parking_f32_kernel", 3,
               stamps=_host_stamps((300, 7, 9)), batch=4, calls=2)
    assert spec.metric_reader(BATCH[1])(run) == pytest.approx(8.0)


def test_a_lone_traced_solve_is_read(spec):
    run = _run(spec, "car_parking_f32_kernel", 1,
               stamps=_graph_stamps((6,)))
    assert spec.metric_reader(SINGLE[1])(run) == pytest.approx(12.0)


@pytest.mark.parametrize("name", SINGLE + BATCH)
def test_a_program_without_them_gives_nothing(spec, monkeypatch, name):
    """An older program: no ``init_rollout`` count, no ``init`` stamp (its
    body calls and whole-solve stamps are there), or no stamps at all."""
    monkeypatch.setattr(spans, "_program", lambda: None)
    old = [_run(spec, "car_parking_f32_kernel", 3, launches=dict(COUNTS),
                stamps=_graph_stamps((9, 5, 3), init=False)),
           _run(spec, "car_parking_f32_kernel", 3, launches=dict(COUNTS),
                stamps=_host_stamps((300, 7, 9), init=False), batch=4,
                calls=2),
           _run(spec, "car_parking_f32_kernel", 3)]
    for run in old:
        assert spec.metric_reader(name)(run) is None


GRAPH_READERS = ("solve_graph.init_ms", "solve_graph.host_ms_per_solve",
                 "device_loop.emission_ms_per_trip",
                 "device_loop.b1_ms_per_trip", "device_loop.b2_ms_per_trip",
                 "device_loop.glue_ms_per_trip")
FUSED_READERS = ("solve_graph.init_ms", "device_loop.b3_ms_per_trip",
                 "device_loop.b2_ms_per_trip", "device_loop.al_ms_per_trip",
                 "device_loop.glue_ms_per_trip", "b3_roofline_pct")


@pytest.mark.parametrize("config,fused,name", [
    *(("car_parking_f32_kernel", False, n) for n in GRAPH_READERS),
    *(("brachistochrone_hli_f64_fused", True, n) for n in FUSED_READERS)])
def test_stamp_readers_unmoved_by_init_stamps(spec, config, fused, name):
    """Each reader of the whole-solve graph's stamps gives the same number
    with and without ``init``/``init_end`` between ``solve`` and
    ``loop``."""
    launches = dict(COUNTS, fused=2 if fused else 0)
    got = [spec.metric_reader(name)(_run(
        spec, config, 3, launches=launches,
        stamps=_graph_stamps((9, 5, 3), fused, init)))
        for init in (False, True)]
    assert got[0] is not None
    assert got[1] == pytest.approx(got[0], rel=0, abs=0)


def test_host_loop_reader_unmoved_by_init_stamps(spec):
    """``emission.device_ms_per_call`` on a host loop's solves, whose
    ``init`` stamps fall between one solve's last body call and the next
    solve's first."""
    read = spec.metric_reader("emission.device_ms_per_call")
    got = [read(_run(spec, "car_parking_f32_kernel", 3, batch=4, calls=2,
                     stamps=_host_stamps((300, 7, 9), init=init)))
           for init in (False, True)]
    assert got[0] == pytest.approx(4.0)
    assert got[1] == got[0]
