"""b2.lane_params_launch_pct: the traced solve's launches of kernel B2 that
did work and read per-lane params (the launch count
``rollout_lane_params``) over all of its launches that did work (sweeps
and selected rollouts, the initial rollout among them), in percent: 100
where B2 reads each lane's own params, nothing on a program without the
count or without a launch of B2."""


def read(run):
    if run.trace is None or not run.launches or \
            "rollout_lane_params" not in run.launches:
        return None
    b2 = run.launches["rollout_multi"] + run.launches["rollout_selected"]
    if b2 <= 0:
        return None
    return 100.0 * run.launches["rollout_lane_params"] / b2
