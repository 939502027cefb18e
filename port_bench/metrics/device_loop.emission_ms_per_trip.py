"""device_loop.emission_ms_per_trip: a trip's device time from its entry
to the end of derivative emission (the stamps ``body`` to ``derivs``),
mean over the trips of the window's untraced solves, in ms."""

from harness import spans


def read(run):
    return spans.phase_ms(run, "body", "derivs")
