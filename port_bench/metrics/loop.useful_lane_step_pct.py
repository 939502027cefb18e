"""loop.useful_lane_step_pct: the share of ``StepwiseSolver``'s lane-steps
(the working width summed over its body calls, ``LoopStats.lane_steps``)
that advanced a running lane (the lanes' ``Solution.body_calls``), over
the window's solves, in percent: what compaction leaves of masked work."""

from harness import spans


def read(run):
    steps = spans.lane_steps(run)
    if not steps:
        return None
    useful = sum(int(r.out["body_calls"].sum()) for r in run.solves)
    return 100.0 * useful / steps
