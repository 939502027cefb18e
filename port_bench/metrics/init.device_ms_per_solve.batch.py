"""init.device_ms_per_solve.batch: a solve's device time in ``init_fn`` (the
stamps ``init`` to ``init_end``: the initial rollout, the multipliers'
first record and the carry), mean over the window's untraced solves, in ms
(``harness/initial.py``); nothing on a program without the stamps."""

from harness import initial


def read(run):
    return initial.device_ms_per_solve(run)
