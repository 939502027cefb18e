"""loop.compact_idle_ms_per_solve: device idle time of the traced solve
inside the host loop's compaction (the span ``ddp.stepwise.compact``: the
new working set gathered and copied into its width's static carry), in
ms."""

from harness import spans


def read(run):
    s = spans.idle_in(run.trace, ("ddp.stepwise.compact",))
    return None if s is None else 1e3 * s
