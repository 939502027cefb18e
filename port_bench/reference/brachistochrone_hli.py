"""The Brachistochrone with a moving floor in plain PyTorch: DDP-Generator
``examples/Brachistochrone`` (``optDefBrachi.mac:10``,
``optDefBrachi_hli.mac:13-14``, ``testBrachi_hli.m:7-26``), written from
the published equations.

One state, the height ``y`` (negative), one input, the slope ``dy`` over a
horizontal step ``dx``: ``y_{k+1} = y_k + dy_k dx``.  The running cost is
the segment's travel time.  The published cost is the symbolic integral
``int_0^dx sqrt((1 + dy^2) / (2 g (-y - dy s))) ds`` (``optDefBrachi.mac:10``);
this module takes its closed form (a departure in form only: the two agree
to rounding where ``y < 0`` and ``y + dy dx < 0``), with the difference of
square roots rationalized so that a small slope loses no digits::

    L = 2 sqrt((1 + dy^2) / (2 g)) dx / (sqrt(-y - dx dy) + sqrt(-y)).

No final cost.  Constraints: the moving floor ``hli_k = ymin[k] - y_k <= 0``
at the steps ``k = 0 .. N-1`` and the terminal equality ``hfe = y_N -
ymin[N] = 0`` (``ymin`` has ``N + 1`` entries).  Arrays carry the
components on the last axis.

The numbers that decide ``correct`` (each a maximum over every lane the
window's solves returned, unless told otherwise):

* ``dyn``: the one-step dynamics residual of the returned trajectory
  (the model's dynamics and the line search's rollout, kernel B2);
* ``floor``: the largest ``ymin[k] - y_k``, clipped at 0 (the floor);
* ``terminal``: ``|y_N - ymin[N]|`` (the terminal equality);
* ``cost_p50``: the median over lanes of the returned cost against this
  module's travel time of the returned trajectory, relative to ``1 +
  |J|``.  The returned cost holds the AL penalty terms too, and the harness
  keeps no multipliers: at most converged lanes those terms are small, but
  a lane that ends at the gradient exit with its penalty weights driven
  up (a tenth or more of the lanes) carries up to ~1e-2 of them, so the
  median and not the maximum;
* ``descent_p90``: over the lanes reported solved, the 90th percentile of
  the relative decrease that a steepest-descent step from the returned
  inputs still finds on the travel time plus a fixed exact penalty of both
  constraints (:data:`RHO` times the summed floor violation and the
  terminal gap): a first-order optimality number of the constrained
  problem (derivatives, backward pass, line search, the multiplier updates
  and the exits that end a lane);
* ``unsolved``: the share of lanes, in percent, that did not end in a
  success exit.
"""

from __future__ import annotations

import torch

from . import common

# Weight of the exact penalty in the descent probe: above the problem's
# multipliers (the travel time moves by well under 1 s per unit of height)
RHO = 10.0


def f(x, u, p):
    return x + u * p["dx"]


def L(x, u, p):
    y, dy = x[..., 0], u[..., 0]
    g, dx = p["g"], p["dx"]
    s = torch.sqrt((1.0 + dy * dy) / (2.0 * g))
    return 2.0 * s * dx / (torch.sqrt(-y - dx * dy) + torch.sqrt(-y))


def F(x, p):
    return torch.zeros_like(x[..., 0])


def floor(xs, p):
    """Per lane: the largest violation of the moving floor, ``ymin[k] -
    y_k`` over ``k < N``, clipped at 0 (NaN reads inf)."""
    N = xs.shape[1] - 1
    h = p["ymin"][:N] - xs[:, :N, 0]
    return torch.nan_to_num(h, nan=float("inf")).amax(1).clamp(min=0.0)


def terminal(xs, p):
    """Per lane: ``|y_N - ymin[N]|`` (NaN reads inf)."""
    N = xs.shape[1] - 1
    return torch.nan_to_num((xs[:, N, 0] - p["ymin"][N]).abs(),
                            nan=float("inf"))


def penalized_cost(x0, us, p, rho=RHO):
    """Per lane: the travel time of the rollout of ``us`` from ``x0`` plus
    ``rho`` times the summed floor violation and the terminal gap."""
    xs = common.rollout(f, x0, us, p)
    N = us.shape[1]
    y = xs[..., 0]
    viol = (p["ymin"][:N] - y[:, :N]).clamp(min=0.0).sum(1)
    return (L(xs[:, :-1], us, p).sum(1)
            + rho * (viol + (y[:, N] - p["ymin"][N]).abs()))


def descent_available(x0, us, p, rho=RHO, block=4096):
    """Per lane: the largest decrease of :func:`penalized_cost` that a
    steepest-descent step ``us - t g`` finds over
    :data:`common.DESCENT_STEPS`, relative to ``1 + |J(us)|``.  Small at a
    converged feasible lane; a lane that kept its initial inputs reads
    large."""
    out = []
    ts = torch.tensor(common.DESCENT_STEPS, dtype=us.dtype,
                      device=us.device)
    nt = len(common.DESCENT_STEPS)
    for i in range(0, us.shape[0], block):
        u = us[i:i + block].detach().clone().requires_grad_(True)
        x = x0[i:i + block]
        j0 = penalized_cost(x, u, p, rho)
        (g,) = torch.autograd.grad(j0.sum(), u)
        j0 = j0.detach()
        ut = u.detach()[None] - ts[:, None, None, None] * g[None]
        jt = penalized_cost(x.repeat(nt, 1), ut.flatten(0, 1), p, rho)
        dec = torch.nan_to_num(j0[None] - jt.view(nt, -1), nan=0.0)
        out.append(dec.amax(dim=0).clamp(min=0.0) / (1.0 + j0.abs()))
    return torch.cat(out) if out else us.new_zeros(0)


def per_lane(case, out) -> dict:
    """Each number's per-lane values (``descent`` on the solved lanes)."""
    p, x0 = case["p"], case["x0"]
    xs, us = out["xs"].double(), out["us"].double()
    ok = common.solved_mask(out["status"])
    ref_cost = common.total_cost(L, F, xs, us, p)
    gap = (out["cost"].double() - ref_cost).abs() / (1.0 + ref_cost.abs())
    return {
        "dyn": common.dyn_residual(f, x0, xs, us, p),
        "floor": floor(xs, p),
        "terminal": terminal(xs, p),
        "cost": torch.nan_to_num(gap, nan=float("inf")),
        "descent": descent_available(x0[ok], us[ok], p),
    }


def numbers(case, out, lanes=None) -> dict:
    """``case``: the inputs (``x0``, ``p``: float64 tensors, lanes first);
    ``out``: the program's ``xs``, ``us``, ``cost``, ``status``;
    ``lanes``: :func:`per_lane`'s values if already worked out.  Returns
    each number's value."""
    lanes = per_lane(case, out) if lanes is None else lanes
    return {"dyn": float(lanes["dyn"].max()),
            "floor": float(lanes["floor"].max()),
            "terminal": float(lanes["terminal"].max()),
            "cost_p50": float(lanes["cost"].median()),
            "descent_p90": common.p90(lanes["descent"]),
            "unsolved": common.unsolved_pct(out["status"])}
