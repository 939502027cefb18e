"""device_loop.al_ms_per_trip: a trip's device time from the end of its
line search to the end of the AL outer loop's work (the stamps
``linesearch`` to ``al``: the accept/reject selections, the multiplier
and penalty-weight update and the re-cost of the accepted trajectory),
mean over the trips of the window's untraced solves, in ms; nothing where
the problem has no AL family (no ``al`` stamp)."""

from harness import spans


def read(run):
    return spans.phase_ms(run, "linesearch", "al")
