"""device_loop.b1_ms_per_trip: a trip's device time in the backward pass
(the stamps ``derivs`` to ``backpass``: kernel B1 and its retries' glue),
mean over the trips of the window's untraced solves, in ms."""

from harness import spans


def read(run):
    return spans.phase_ms(run, "derivs", "backpass")
