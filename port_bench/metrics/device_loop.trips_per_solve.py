"""device_loop.trips_per_solve: trips of the solve's device loop (the
WHILE node of the whole-solve graph: a trip is one body call; at one lane
the lane's ``Solution.body_calls``), mean over the window's solves."""


def read(run):
    if not run.trips:
        return None
    return sum(run.trips) / len(run.trips)
