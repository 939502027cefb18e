"""Roofline shares of the port's kernels B1, B2 and B3 from the trace.

A launch's bound is the larger of two times: its bytes over the card's
memory rate, and its operations over the card's float rate in the
configuration's dtype (NVIDIA H100 SXM data sheet, dense, outside the
tensor cores, at the full 700 W power limit).  Operations come from the
frozen counts (``counts/<config>.json``: per step and lane, per lane);
bytes from the configuration's shapes, each input read once and each
output written once.  A launch's width is its grid's ``x`` times the
kernels' 8 lanes a block (no more than the solve's batch); a sweep's
alphas are all of the options' alphas (every lane of the launch evaluates
each).  A kernel's share is the sum of its launches' bounds over the sum
of their device times, in percent; above 100 the counts or the bytes are
too high, or the time leaves out work.
"""

from __future__ import annotations

import re

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
BYTES = {"float32": 4, "float64": 8}
LANES_PER_BLOCK = 8

B1, B2_SWEEP, B2_SEL_COST, B2_SEL, B3, LOOP = (
    "b1", "b2_sweep", "b2_selected_cost", "b2_selected", "b3", "loop")
PORT_KERNELS = (B1, B2_SWEEP, B2_SEL_COST, B2_SEL, B3, LOOP)


def classify(name: str):
    """Which of the port's own kernels a trace name is, or None."""
    if "backpass_kernel" in name:
        return B1
    if "fused_kernel" in name:
        return B3
    if "set_condition" in name:
        return LOOP
    if "rollout_kernel" in name:
        name = name.replace("(anonymous namespace)::", "")
        m = re.search(r"rollout_kernel<([^()]*)>", name)
        if m:
            flags = [a.strip() for a in m.group(1).split(",")][-2:]
            multi, cost = (f == "true" for f in flags)
        else:  # a mangled name: template bools as Lb0E / Lb1E
            bits = re.findall(r"Lb([01])E", name)[-2:]
            multi, cost = (b == "1" for b in bits)
        if multi:
            return B2_SWEEP
        return B2_SEL_COST if cost else B2_SEL
    return None


class Shape:
    """What the byte and operation formulas need of a configuration."""

    def __init__(self, cfg: dict, n_alpha: int):
        self.nx, self.nu = int(cfg["n_x"]), int(cfg["n_u"])
        self.N = int(cfg["T"])
        self.dtype = cfg["dtype"]
        self.full = bool(cfg["options"].get("full_ddp", True))
        al = cfg.get("al_families", {})
        self.hle, self.hli = int(al.get("hle", 0)), int(al.get("hli", 0))
        self.hfe, self.hfi = int(al.get("hfe", 0)), int(al.get("hfi", 0))
        self.A = n_alpha


def values(kind: str, s: Shape) -> tuple:
    """``(per step and lane, per lane)`` floating values moved by one
    launch of ``kind``, and ``bool`` bytes per lane: inputs read once,
    outputs written once."""
    X, U = s.nx, s.nu
    tx, tu = X * (X + 1) // 2, U * (U + 1) // 2
    if kind == B1:
        # fx fu cx cu cxx cuu cxu [fxx fuu fxu] lower upper lo_hx up_hx
        # lo_s up_s us -> l L
        step = (X * X + X * U + X + U + tx + tu + X * U
                + (X * tx + X * tu + X * X * U if s.full else 0)
                + 2 * U + 2 * U * X + 2 * U + U) + (U + U * X)
        lane = (1 + X + X * X) + (2 + 1)  # lam, final cx, cxx -> dV, g
        return step, lane, 1  # failed
    if kind == B3:
        # x u mu_le mu_li -> l L
        step = (X + U + s.hle + s.hli) + (U + U * X)
        lane = (X + 3 + s.hfe + s.hfi) + (2 + 1)  # xf wpl wpf lam mu -> dV g
        return step, lane, 2  # failed, derivs_ok
    # B2: xnom unom l L mu_le mu_li; x0 wpl wpf mu_fe mu_fi
    step = X + U + U + U * X + s.hle + s.hli
    lane = X + 2 + s.hfe + s.hfi
    if kind == B2_SWEEP:
        return step, lane + s.A, s.A  # + alphas' costs, oks
    if kind == B2_SEL_COST:
        return step + X + U, lane + 1 + X + 1, 1  # alpha; xs us; xf cost; ok
    return step + X + U, lane + 1 + X, 0  # alpha; xs us; xf


def operations(kind: str, s: Shape, counts: dict) -> tuple:
    """``(per step and lane, per lane)`` operations of one launch."""
    if kind == B1:
        return counts["b1"]["per_step"], counts["b1"]["per_lane"]
    if kind == B3:
        return counts["b3"]["per_step"], counts["b3"]["per_lane"]
    if kind == B2_SWEEP:
        return s.A * counts["b2"]["cost_per_step"], 0
    if kind == B2_SEL_COST:
        return counts["b2"]["cost_per_step"], 0
    return counts["b2"]["nocost_per_step"], 0


def launch_bound_s(kind: str, width: int, s: Shape, counts: dict) -> float:
    step_v, lane_v, lane_b = values(kind, s)
    n_bytes = width * ((s.N * step_v + lane_v) * BYTES[s.dtype] + lane_b)
    step_o, lane_o = operations(kind, s, counts)
    n_ops = width * (s.N * step_o + lane_o)
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[s.dtype])


def width_of(grid, batch: int) -> int:
    gx = int(grid[0]) if grid else 1
    return max(1, min(gx * LANES_PER_BLOCK, batch))


def sums(launches, kinds, s: Shape, counts: dict, batch: int,
         did_work=None) -> tuple:
    """``(bound s, device s)`` summed over ``launches`` (trace
    :class:`DeviceOp`) of the given ``kinds``; with ``did_work``, only
    that many of them, the longest (a launch whose stage flag is 0 exits
    at entry: it did no work)."""
    mine = [o for o in launches if classify(o.name) in kinds]
    if did_work is not None:
        mine = sorted(mine, key=lambda o: -o.dur_us)[:did_work]
    bound = sum(launch_bound_s(classify(o.name), width_of(o.grid, batch),
                               s, counts) for o in mine)
    return bound, sum(o.dur_us for o in mine) * 1e-6


def share(parts, s: Shape, counts: dict, batch: int):
    """Percent of the device time that the bound is, summed over
    ``parts``, each ``(launches, kinds, did_work)``; None without time."""
    bound = dur = 0.0
    for launches, kinds, did_work in parts:
        b, d = sums(launches, kinds, s, counts, batch, did_work)
        bound, dur = bound + b, dur + d
    return 100.0 * bound / dur if dur > 0.0 else None
