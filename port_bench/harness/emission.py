"""The emission kernel's (``ops/cuda_emit.py``) bound, as
``harness/roofline.py`` bounds kernels B1, B2 and B3: the larger of a
call's bytes over the card's memory rate and its operations over its float
rate (``roofline.py``'s peaks).

A call is two launches, ``emit_final_lanes`` (a thread a lane) and
``emit_steps`` (a thread a work-item group of a point (step, lane)).  Its
bytes: ``xs``, ``us``, the multipliers and penalty weights and the params
read once (a row per lane where they are per lane, else one array); the
packed bundle kernel B1 reads (``ops/cuda_backpass.py``: ``_BUNDLE_KEYS``
and ``u``), the final terms and ``ok`` written once.  Its operations: the
counts' ``emit`` entry, per step and lane and per lane, where the counts
have one.  A call's width comes from its ``emit_steps`` grid: a thread
takes all of a point's items from ``WHOLE_POINT_FROM`` points on, one item
below (``ops/cuda_emit.py``), each block ``THREADS`` threads.
"""

from __future__ import annotations

import numpy as np

from . import roofline

THREADS = 128  # csrc/emit_launch.cuh: kEmitThreads
WHOLE_POINT_FROM = 1 << 15  # ops/cuda_emit.py
STEPS, FINAL = "emit_steps", "emit_final_lanes"


def kind(name: str):
    """``STEPS``, ``FINAL`` or None: which launch of the emission kernel a
    trace name is."""
    for k in (STEPS, FINAL):
        if k in name:
            return k
    return None


def items(s: roofline.Shape) -> int:
    """Work items of a point (``ops/cuda_emit.py: items_per_point``)."""
    d = s.nx + s.nu
    return d * (d + 1) // 2 + (0 if s.full else d) + 1


def width(grid, s: roofline.Shape, batch: int) -> int:
    """The lanes of a call from its ``emit_steps`` grid."""
    threads = (int(grid[0]) if grid else 1) * THREADS
    B = threads // s.N  # all of a point's items on one thread
    if B * s.N < WHOLE_POINT_FROM:
        B = threads // (s.N * items(s))  # one item a thread
    return max(1, min(B, batch))


def param_values(cfg: dict, batch: int) -> tuple:
    """``(per lane, per call)`` params read: a row per lane where the
    configuration's params are per lane, else the one array."""
    total = sum(int(np.size(v)) for v in cfg["params"].values())
    if cfg.get("stepwise", {}).get("batch_params"):
        return total // batch, 0
    return 0, total


def values(s: roofline.Shape) -> tuple:
    """``(per step and lane, per lane)`` floating values a call moves
    besides its params, and its ``bool`` bytes per lane."""
    X, U = s.nx, s.nu
    tx, tu = X * (X + 1) // 2, U * (U + 1) // 2
    bundle = (X * X + X * U + X + U + tx + tu + X * U
              + (X * tx + X * tu + X * X * U if s.full else 0)
              + 2 * U + 2 * U * X + 2 * U + U)
    step = (X + U + s.hle + s.hli) + bundle
    lane = (X + 2 + s.hfe + s.hfi) + (X + X * X)  # x_N, weights -> Fx, Fxx
    return step, lane, 1  # ok


def call_bound_s(B: int, s: roofline.Shape, counts: dict, cfg: dict,
                 batch: int) -> float:
    """Seconds a call at width ``B`` takes at the card's peaks."""
    step_v, lane_v, lane_b = values(s)
    p_lane, p_call = param_values(cfg, batch)
    n_bytes = (B * ((s.N * step_v + lane_v + p_lane)
                    * roofline.BYTES[s.dtype] + lane_b)
               + p_call * roofline.BYTES[s.dtype])
    ops = counts.get("emit", {})
    n_ops = B * (s.N * ops.get("per_step", 0) + ops.get("per_lane", 0))
    return max(n_bytes / roofline.PEAK_BYTES_PER_S,
               n_ops / roofline.PEAK_OPS_PER_S[s.dtype])


def share(run):
    """The emission kernel's bound over its device time in the traced
    solve, each call at its own width, in percent; None without a
    launch."""
    if run.trace is None:
        return None
    mine = [o for o in run.trace.kernels() if kind(o.name)]
    steps = [o for o in mine if kind(o.name) == STEPS]
    dur = sum(o.dur_us for o in mine) * 1e-6
    if not steps or dur <= 0.0:
        return None
    bound = sum(call_bound_s(width(o.grid, run.shape, run.batch), run.shape,
                             run.counts, run.cfg, run.batch) for o in steps)
    return 100.0 * bound / dur
