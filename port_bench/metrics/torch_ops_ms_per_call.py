"""torch_ops_ms_per_call: device time of every kernel that is not one of
the port's own (B1, B2, B3, the device loop's ``set_condition``) in the
traced solve, over its body calls, in ms: emission's autograd
kernels, the solver's selections and copies."""

from harness import roofline


def read(run):
    if run.trace is None:
        return None
    calls = run.solves[0].loop_body_calls
    if calls <= 0:
        return None
    dur = sum(o.dur_us for o in run.trace.kernels()
              if roofline.classify(o.name) is None)
    return 1e-3 * dur / calls
