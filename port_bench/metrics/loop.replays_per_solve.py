"""loop.replays_per_solve: CUDA graph replays of ``StepwiseSolver``'s
body calls (``last_stats.replays``), mean over the window's solves."""


def read(run):
    if not run.solves or not any(r.loop_body_calls for r in run.solves):
        return None
    return sum(r.replays for r in run.solves) / len(run.solves)
