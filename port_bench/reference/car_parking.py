"""CarParking in plain PyTorch: DDP-Generator ``examples/CarParking``
(``optDefCar.mac:1-19``, ``testCar.m:1-25``), written from the published
equations.

Four states ``[x, y, t, v]``, two inputs ``[w, a]``; front-axle kinematics
with the rolling distance ``s = d + h v cos w - sqrt(d^2 - (h v sin w)^2)``;
smooth-abs costs ``sqrtAbs(z, e) = sqrt(z^2 + e^2) - e``; the box
``limW[0] <= w <= limW[1]``, ``limA[0] <= a <= limA[1]``.  Arrays carry
the components on the last axis.

The numbers that decide ``correct`` (each a maximum over every lane the
window's solves returned, unless told otherwise):

* ``dyn``: the one-step dynamics residual of the returned trajectory
  (the model's dynamics and the line search's rollout, kernel B2);
* ``cost``: the returned cost against this module's cost of the returned
  trajectory, relative to ``1 + |cost|`` (running and final cost);
* ``box``: how far a returned input lies outside its box (exact: 0);
* ``descent_p90``: over the lanes reported solved, the 90th percentile of
  the relative cost decrease that a projected steepest-descent step from
  the returned inputs still finds (derivatives, backward pass, line
  search and the exits that end a lane: solved lanes must sit near a
  local minimum; lanes that kept their initial inputs read about
  0.03-0.08).  A percentile, not the maximum: the cost-change exit
  (``dcost < tolFun`` on one iteration, as the reference's iLQG has it)
  ends a few lanes in a thousand far from a minimum on every seed;
* ``unsolved``: the share of lanes, in percent, that did not end in a
  success exit (the loop's termination: lanes left out or cut short).
"""

from __future__ import annotations

import torch

from . import common


def _sqrt_abs(z, e):
    return torch.sqrt(z * z + e * e) - e


def f(x, u, p):
    X, Y, t, v = x.unbind(-1)
    w, a = u.unbind(-1)
    d, h = p["d"], p["h"]
    hvs = h * v * torch.sin(w)
    s = d + h * v * torch.cos(w) - torch.sqrt(d * d - hvs * hvs)
    return torch.stack([X + s * torch.cos(t), Y + s * torch.sin(t),
                        t + torch.asin(torch.sin(w) * h * v / d),
                        v + h * a], dim=-1)


def L(x, u, p):
    cu, cx, px = p["cu"], p["cx"], p["px"]
    return (cu[0] * u[..., 0] ** 2 + cu[1] * u[..., 1] ** 2
            + cx[0] * _sqrt_abs(x[..., 0], px[0])
            + cx[1] * _sqrt_abs(x[..., 1], px[1]))


def F(x, p):
    cf, pf, cx, px = p["cf"], p["pf"], p["cx"], p["px"]
    c = cx[0] * _sqrt_abs(x[..., 0], px[0]) + cx[1] * _sqrt_abs(x[..., 1], px[1])
    for i in range(4):
        c = c + cf[i] * _sqrt_abs(x[..., i], pf[i])
    return c


def box(p):
    lo = torch.stack([p["limW"][0], p["limA"][0]])
    hi = torch.stack([p["limW"][1], p["limA"][1]])
    return lo, hi


def per_lane(case, out) -> dict:
    """Each number's per-lane values (``descent`` on the solved lanes)."""
    p = case["p"]
    x0 = case["x0"]
    xs, us = out["xs"].double(), out["us"].double()
    lo, hi = box(p)
    ok = common.solved_mask(out["status"])
    ref_cost = common.total_cost(L, F, xs, us, p)
    gap = (out["cost"].double() - ref_cost).abs() / (1.0 + ref_cost.abs())
    return {
        "dyn": common.dyn_residual(f, x0, xs, us, p),
        "cost": torch.nan_to_num(gap, nan=float("inf")),
        "box": torch.clamp(torch.maximum(lo - us, us - hi), min=0.0)
        .nan_to_num(nan=float("inf")).flatten(1).amax(1),
        "descent": common.descent_available(f, L, F, x0[ok], us[ok], p, lo,
                                            hi),
    }


def numbers(case, out, lanes=None) -> dict:
    """``case``: the inputs (``x0``, ``p``: float64 tensors, lanes first);
    ``out``: the program's ``xs``, ``us``, ``cost``, ``status``;
    ``lanes``: :func:`per_lane`'s values if already worked out.  Returns
    each number's value."""
    lanes = per_lane(case, out) if lanes is None else lanes
    return {"dyn": float(lanes["dyn"].max()),
            "cost": float(lanes["cost"].max()),
            "box": float(lanes["box"].max()),
            "descent_p90": common.p90(lanes["descent"]),
            "unsolved": common.unsolved_pct(out["status"])}
