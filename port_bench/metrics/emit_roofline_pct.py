"""emit_roofline_pct: the emission kernel's (``ops/cuda_emit.py``, both
launches of a call) bound over its device time in the traced solve, each
call at its own width, in percent (``harness/emission.py``); nothing where
the trace holds no emission kernel (the torch emitter)."""

from harness import emission


def read(run):
    return emission.share(run)
