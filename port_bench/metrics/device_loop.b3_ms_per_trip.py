"""device_loop.b3_ms_per_trip: a trip's device time in kernel B3 (the
stamps ``body`` to ``backpass`` on the fused path, which stamps no
``derivs``: B3's derivatives and backward pass, its lambda retries and
their glue), mean over the trips of the window's untraced solves, in ms;
nothing where the trips stamp ``derivs`` (their derivatives are not
B3's)."""

from harness import spans


def read(run):
    if any("derivs" in c for _, calls in spans.untraced(run) or ()
           for c in calls):
        return None
    return spans.phase_ms(run, "body", "backpass")
