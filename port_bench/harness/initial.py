"""What the program records of a solve's initial rollout (``init_fn``, the
open-loop rollout of ``iLQG_mex.c:113-116``), for the ``init.*`` readers:
the launch count ``init_rollout`` (``launches.read_launches``: one for each
initial rollout that ran as one launch of kernel B2) and the device stamps
``init`` (``init_fn``'s entry) and ``init_end`` (its carry built), on both
entries.  A program that records neither gives None here, and the readers
report nothing."""

from __future__ import annotations

from . import spans


def kernel_rollout_pct(run) -> float | None:
    """The traced solve's ``init_rollout`` launches over its solves (one),
    in percent: 100 where the initial rollout ran on B2, 0 where it ran as
    ``forward_pass``."""
    if run.trace is None or not run.launches or \
            "init_rollout" not in run.launches:
        return None
    traced = sum(1 for r in run.solves if r.traced)
    if traced <= 0:
        return None
    return 100.0 * run.launches["init_rollout"] / traced


def device_ms_per_solve(run) -> float | None:
    """The stamps ``init`` to ``init_end`` of each solve, the mean over the
    window's untraced solves (all of them where the traced one is the only
    one), in ms."""
    entries = spans.stamps(run)
    if entries is None or not run.solves:
        return None
    spells, start = [], None
    for tag, ns in entries:
        if tag == "init":
            start = ns
        elif tag == "init_end" and start is not None:
            spells.append(ns - start)
            start = None
    spells = spells[1:] or spells
    if not spells:
        return None
    return 1e-6 * sum(spells) / len(spells)
