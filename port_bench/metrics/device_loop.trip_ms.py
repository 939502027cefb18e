"""device_loop.trip_ms: the window's solve time over all its trips, in
ms, over the solves that ran outside the profiler (every solve but the
traced first one of a ``--trace 1`` run)."""


def read(run):
    pairs = [(r.wall_s, t) for r, t in zip(run.solves, run.trips)
             if not r.traced]
    trips = sum(t for _, t in pairs)
    if trips <= 0:
        return None
    return 1e3 * sum(w for w, _ in pairs) / trips
