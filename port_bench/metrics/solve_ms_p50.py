"""solve_ms_p50: the median over every solve of the window of one
entry call, from the call until its result is back (a device
synchronize), in ms; failed solves count with their time."""

import statistics


def read(run):
    if not run.solves:
        return None
    return 1e3 * statistics.median(r.wall_s for r in run.solves)
