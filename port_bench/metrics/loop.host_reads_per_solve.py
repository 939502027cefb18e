"""loop.host_reads_per_solve: device values the host loop of
``StepwiseSolver`` read (``last_stats.host_reads``), mean over the
window's solves."""


def read(run):
    if not run.solves or not any(r.loop_body_calls for r in run.solves):
        return None
    return sum(r.host_reads for r in run.solves) / len(run.solves)
