"""init.kernel_rollout_pct.batch: the traced solve's launches of its initial
rollout on kernel B2 (the launch count ``init_rollout``) over its solves,
in percent (``harness/initial.py``): 100 where ``init_fn`` rolls the
first trajectory as one launch of B2's selected rollout with cost at alpha
0, 0 where it rolls it as ``forward_pass``'s loop of torch operations;
nothing on a program without the count."""

from harness import initial


def read(run):
    return initial.kernel_rollout_pct(run)
