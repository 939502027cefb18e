"""device_loop.glue_ms_per_trip: a trip's device time after its line
search (the stamp ``linesearch`` to the next trip's ``body``, the last
trip's to ``loop_end``: the accept/reject updates, the masked carry, the
loop's condition), mean over the trips of the window's untraced solves,
in ms."""

from harness import spans


def read(run):
    return spans.phase_ms(run, "linesearch", "next")
