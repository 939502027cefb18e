"""b3_roofline_pct: kernel B3's (ops/cuda_fused.py) bound at one lane
(``harness/roofline.py`` on the frozen counts) times its launches a trip
(the traced solve's launch count ``fused`` over its trips), over a trip's
B3 time from the stamps (``device_loop.b3_ms_per_trip``), in percent.  The
profiler records no kernel inside a WHILE body, so the stamps give the
time; it holds B3's launches and the glue of their lambda retries, so the
share is a lower bound."""

from harness import roofline, spans


def read(run):
    if run.batch != 1 or not run.launches or not run.trips:
        return None
    if any("derivs" in c for _, calls in spans.untraced(run) or ()
           for c in calls):
        return None
    ms = spans.phase_ms(run, "body", "backpass")
    launches = run.launches.get("fused", 0)
    if not ms or not launches or run.trips[0] <= 0:
        return None
    bound_s = roofline.launch_bound_s(roofline.B3, 1, run.shape, run.counts)
    return 100.0 * bound_s * launches / run.trips[0] / (ms * 1e-3)
