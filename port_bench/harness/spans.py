"""What the program records of its own work, for the per-layer readers:
its host spans (``torch.profiler.record_function`` ranges named ``ddp.*``
in the traced solve's trace), its device stamps and its lane-steps
(``ddp_generator_tpu_torch.launches``: ``read_stamps``,
``read_lane_steps``; the harness's ``reset_launches`` at a traced window's
start empties both).  A program that records none of it (an older tree)
gives None here, and its readers report nothing.

A stamp is ``(tag, ns)``, the device's ``%globaltimer`` when a one-thread
kernel ran.  A body call stamps ``body`` at its entry, ``derivs`` after the
derivatives (none where kernel B3 computes them), ``backpass`` after the
backward pass, ``linesearch`` after the line search and ``body_end`` after
its masked carry; the whole-solve graph stamps ``solve``, ``loop`` (before
its WHILE node), each trip's body call, ``loop_end`` and ``solve_end``.
Stamps need no profiler, so their readers take the window's solves but the
traced first one, whose graphs ran under it.
"""

from __future__ import annotations

PREFIX = "ddp."  # the program's spans
TRIP_END = ("loop_end", "solve_end")  # a last trip ends at its loop's end


def program_spans(trace) -> list:
    """``[(start_us, end_us, name)]`` of the program's spans in ``trace``,
    in start order."""
    if trace is None:
        return []
    return sorted(h for h in trace.host if h[2].startswith(PREFIX))


def _innermost(spans: list) -> list:
    """The timeline the spans cover, cut where any starts or ends:
    ``[(start_us, end_us, name)]`` in order, each piece named by the
    innermost span over it (the latest to start; spans of one thread
    nest)."""
    cuts = sorted({t for a, b, _ in spans for t in (a, b)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        over = [s for s in spans if s[0] <= a and s[1] >= b]
        if over:
            inner = max(over, key=lambda s: (s[0], -s[1]))
            out.append((a, b, inner[2]))
    return out


def idle_by_span(trace) -> dict:
    """The device's idle time in the traced window (``Trace.gaps``), in us,
    by the innermost program span over it; the key None holds the idle
    time outside every program span.  Empty where the trace holds no
    program span."""
    pieces = _innermost(program_spans(trace))
    if not pieces:
        return {}
    out: dict = {None: 0.0}
    i = 0
    for g0, glen in trace.gaps():
        g1 = g0 + glen
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        covered, j = 0.0, i
        while j < len(pieces) and pieces[j][0] < g1:
            a, b, name = pieces[j]
            over = min(g1, b) - max(g0, a)
            if over > 0:
                out[name] = out.get(name, 0.0) + over
                covered += over
            j += 1
        out[None] += glen - covered
    return out


def idle_in(trace, names) -> float | None:
    """Idle seconds of the traced window whose innermost program span is
    one of ``names``; None where the trace holds no program span."""
    by = idle_by_span(trace)
    if not by:
        return None
    return 1e-6 * sum(by.get(n, 0.0) for n in names)


def _program():
    try:
        from ddp_generator_tpu_torch import launches
    except ImportError:
        return None
    return launches


def stamps(run) -> list | None:
    """The program's stamps since the window's start, oldest first (the
    run's own ``stamps`` where the harness keeps them); None where the
    program has none or the ring overwrote the window's first."""
    got = getattr(run, "stamps", None)
    if got is not None:
        return got or None
    launches = _program()
    if launches is None or not hasattr(launches, "read_stamps"):
        return None
    import torch

    if not torch.cuda.is_available():
        return None
    entries, lost = launches.read_stamps()
    return entries if entries and not lost else None


def lane_steps(run) -> int | None:
    """Lane-steps of the window's solves: the sum of the records'
    ``lane_steps`` where the harness keeps them, else the program's count
    since the window's start; None where neither exists."""
    if run.solves and all(hasattr(r, "lane_steps") for r in run.solves):
        return sum(r.lane_steps for r in run.solves)
    launches = _program()
    if launches is None or not hasattr(launches, "read_lane_steps"):
        return None
    return launches.read_lane_steps()


def body_calls(entries: list) -> list:
    """The body calls of a stamp sequence, in order: for each ``body``
    stamp a dict of its own stamps' ns by tag, and ``next``, the ns of the
    stamp that ends it (the next ``body``, or its loop's end)."""
    out, cur = [], None
    for tag, ns in entries:
        if tag == "body":
            if cur is not None:
                cur.setdefault("next", ns)
            cur = {"body": ns}
            out.append(cur)
        elif cur is not None and tag in TRIP_END:
            cur.setdefault("next", ns)
            cur = None
        elif cur is not None:
            cur.setdefault(tag, ns)
    return out


def whole_solves(entries: list) -> list:
    """The stamps of each whole-solve graph in ``entries``, ``solve`` to
    ``solve_end``, in order."""
    out, cur = [], None
    for tag, ns in entries:
        if tag == "solve":
            cur = []
        if cur is not None:
            cur.append((tag, ns))
            if tag == "solve_end":
                out.append(cur)
                cur = None
    return out


def solves(run) -> list | None:
    """Each solve of the window as ``(its stamps' first ns by tag, its body
    calls)``: the trips of a whole-solve graph, or a host loop's body calls
    split by the solves' ``loop_body_calls``; None without stamps."""
    entries = stamps(run)
    if entries is None or not run.solves:
        return None
    graphs = whole_solves(entries)
    if graphs:
        return [(dict(reversed(g)), body_calls(g)) for g in graphs]
    calls, out = body_calls(entries), []
    for r in run.solves:
        out.append(({}, calls[:r.loop_body_calls]))
        calls = calls[r.loop_body_calls:]
    return out


def untraced(run) -> list | None:
    """:func:`solves` of the window but its first, the traced one, whose
    replays ran under the profiler (all of them where it is the only
    one)."""
    got = solves(run)
    if not got:
        return None
    return got[1:] or got


def phase_ms(run, start: str, end: str) -> float | None:
    """The mean in ms over the body calls of the untraced solves of the
    time from stamp ``start`` to stamp ``end`` (``next``: the call's
    end)."""
    got = untraced(run)
    calls = [c for _, cs in got or () for c in cs]
    if not calls or any(start not in c or end not in c for c in calls):
        return None
    return 1e-6 * sum(c[end] - c[start] for c in calls) / len(calls)
