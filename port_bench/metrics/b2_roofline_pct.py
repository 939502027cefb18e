"""b2_roofline_pct: kernel B2's (the line search's rollouts,
``ops/cuda_rollout.py``) bound over its device time, in percent, over the
launches of the traced solve that did work: as many of the longest
sweeps and selected rollouts as the device counted (a launch whose stage
flag is 0 exits at entry), each at its own width (``harness/roofline.py``)."""

from harness import roofline


def read(run):
    if run.trace is None or run.launches is None:
        return None
    ks = run.trace.kernels()
    return roofline.share(
        [(ks, (roofline.B2_SWEEP,), run.launches["rollout_multi"]),
         (ks, (roofline.B2_SEL_COST, roofline.B2_SEL),
          run.launches["rollout_selected"])],
        run.shape, run.counts, run.batch)
