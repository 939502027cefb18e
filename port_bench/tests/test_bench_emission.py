"""The reader of ``emission.kernel_call_pct``: the traced solve's emission
launches over its body calls, and nothing, without raising, without a
trace, without body calls or from a program that counts no emission."""

import pytest

from harness.cell import Run, SolveRecord
from harness.roofline import Shape
from harness.trace import Trace

NAME = "emission.kernel_call_pct"
LAUNCHES = {"backpass": 330, "fused": 0, "rollout_multi": 12,
            "rollout_selected": 660, "emit": 330}


def _run(spec, calls, trace=True, launches=LAUNCHES):
    cfg = spec.config("car_parking_f32_kernel")
    recs = [SolveRecord(wall_s=6.5, lanes=2048, traced=i == 0,
                        loop_body_calls=n) for i, n in enumerate(calls)]
    tr = (Trace(window_s=1e-3, ops=[], host=[], t0_us=0.0, t1_us=1e3)
          if trace else None)
    return Run(cfg=cfg, counts={}, shape=Shape(cfg, 11), batch=2048,
               setup_total=1.0, solves=recs, window_s=13.0, trace=tr,
               launches=launches)


def test_emission_launches_over_the_traced_body_calls(spec):
    read = spec.metric_reader(NAME)
    assert read(_run(spec, (330, 400))) == pytest.approx(100.0)
    assert read(_run(spec, (440, 330))) == pytest.approx(75.0)


@pytest.mark.parametrize("case", ["no_trace", "no_body_calls", "no_solves",
                                  "no_count", "no_launches"])
def test_nothing_to_read(spec, case):
    older = {k: v for k, v in LAUNCHES.items() if k != "emit"}
    run = {"no_trace": lambda: _run(spec, (330,), trace=False),
           "no_body_calls": lambda: _run(spec, (0, 330)),
           "no_solves": lambda: _run(spec, ()),
           "no_count": lambda: _run(spec, (330,), launches=older),
           "no_launches": lambda: _run(spec, (330,), launches=None)}[case]()
    assert spec.metric_reader(NAME)(run) is None
