"""emission.device_ms_per_call: derivative emission's device time in a
body call (the stamps ``body`` to ``derivs``: ``cm_emit`` and the body's
first selections), mean over the body calls of the window's untraced
solves, in ms."""

from harness import spans


def read(run):
    return spans.phase_ms(run, "body", "derivs")
