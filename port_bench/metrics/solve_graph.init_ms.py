"""solve_graph.init_ms: a solve's device time before its device loop (the
stamps ``solve`` to ``loop``: ``init_fn``, the initial rollout), mean over
the window's untraced solves, in ms."""

from harness import spans


def read(run):
    got = [ns for ns, _ in spans.untraced(run) or ()
           if "solve" in ns and "loop" in ns]
    if not got:
        return None
    return 1e-6 * sum(ns["loop"] - ns["solve"] for ns in got) / len(got)
