"""b1_roofline_pct: kernel B1's (the backward pass,
``ops/cuda_backpass.py``) bound over its device time, every launch of the
traced solve at its own width, in percent (``harness/roofline.py``)."""

from harness import roofline


def read(run):
    if run.trace is None:
        return None
    return roofline.share([(run.trace.kernels(), (roofline.B1,), None)],
                          run.shape, run.counts, run.batch)
