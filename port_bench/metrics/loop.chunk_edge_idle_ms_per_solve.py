"""loop.chunk_edge_idle_ms_per_solve: device idle time of the traced solve
at the host loop's chunk edges (the spans ``ddp.stepwise.read_wait``, a
count's host read, and ``ddp.stepwise.enqueue``, a chunk's replays and its
count's copy), in ms."""

from harness import spans


def read(run):
    s = spans.idle_in(run.trace, ("ddp.stepwise.read_wait",
                                  "ddp.stepwise.enqueue"))
    return None if s is None else 1e3 * s
