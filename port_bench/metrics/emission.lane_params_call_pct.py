"""emission.lane_params_call_pct: the traced solve's launches of the
emission kernel that read per-lane params (the launch count
``emit_lane_params``) over its body calls (``LoopStats.body_calls``), in
percent: ~99 where every body call that derives emits with each lane's
own params (the last body call of a solve emits nothing), nothing on a
program without the count."""


def read(run):
    if run.trace is None or not run.launches or \
            "emit_lane_params" not in run.launches:
        return None
    calls = run.solves[0].loop_body_calls if run.solves else 0
    if calls <= 0:
        return None
    return 100.0 * run.launches["emit_lane_params"] / calls
