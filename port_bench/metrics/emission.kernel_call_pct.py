"""emission.kernel_call_pct: the traced solve's launches of the emission
kernel (``ops/cuda_emit.py``, the launch count ``emit``) over its body calls
(``LoopStats.body_calls``), in percent: whether the kernel path's derivative
emission runs as the one hand-written kernel (~100, B1's launches over the
same body calls) or as the torch emitter (nothing to read: a program
without the count)."""


def read(run):
    if run.trace is None or not run.launches or "emit" not in run.launches:
        return None
    calls = run.solves[0].loop_body_calls if run.solves else 0
    if calls <= 0:
        return None
    return 100.0 * run.launches["emit"] / calls
