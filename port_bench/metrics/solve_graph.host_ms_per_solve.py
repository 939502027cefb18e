"""solve_graph.host_ms_per_solve: the host's own time in a call of the
whole-solve graph: the solve's wall (call to result, host clock) less the
device's solve (the stamps ``solve`` to ``solve_end``), that is the copies
in, the launch's latency, the host read's wake-up and the copies out; mean
over the window's untraced solves, in ms.  (The spans
``ddp.solve_graph.call`` less ``ddp.solve_graph.read_wait`` of the traced
solve read several times more: under the profiler the launch of the
graph's ~39k top-level nodes is slow, and overlaps the device's work.)"""

from harness import spans


def read(run):
    got = spans.solves(run) or ()
    pairs = [(r.wall_s, ns) for r, (ns, _) in zip(run.solves, got)
             if "solve" in ns and "solve_end" in ns]
    pairs = pairs[1:] or pairs
    if not pairs:
        return None
    return 1e3 * sum(w - 1e-9 * (ns["solve_end"] - ns["solve"])
                     for w, ns in pairs) / len(pairs)
