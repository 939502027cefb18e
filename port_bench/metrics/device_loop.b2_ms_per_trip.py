"""device_loop.b2_ms_per_trip: a trip's device time in the line search
(the stamps ``backpass`` to ``linesearch``: kernel B2's sweep and selected
rollout), mean over the trips of the window's untraced solves, in ms."""

from harness import spans


def read(run):
    return spans.phase_ms(run, "backpass", "linesearch")
