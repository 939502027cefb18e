"""CarParking for a mixed fleet in plain PyTorch: the equations of
:mod:`reference.car_parking` (DDP-Generator ``examples/CarParking``,
``optDefCar.mac:1-19``), every vehicle with its own parameters, as the
reference's ``iLQG(x0, u_nom, params, opt_params)`` takes them per call
(``iLQG_mex.c:32-33``).

Params carry one row per vehicle: each leaf ``(R, *shape)``.  The window's
lanes are solve-major, so lane ``j`` of ``L`` judged lanes is row ``j %
R``; :func:`f`, :func:`L` and :func:`F` take params of ``R`` rows against
states of ``L`` lanes in that order (``L`` a multiple of ``R``, or equal
to it), as ``harness/control.py`` calls them.

The numbers that decide ``correct`` are :mod:`reference.car_parking`'s,
each lane judged under its own row: ``dyn``, ``cost``, ``box``,
``descent_p90`` and ``unsolved``.  ``box`` against each lane's own limits
is not exact here: the generated clamp takes a limit from its constraint,
``-s (h(u) - s u)`` (``iLQG_func.tem:68-73``), which returns the limit
itself only where ``u - lim`` rounds to no error, as with the published
limits 0.5 and 2; a fleet's limits (``0.3 + 0.3 j / 7`` and the like) come
back within a few float32 ulps of the unclamped input.
"""

from __future__ import annotations

import torch

from . import car_parking as car
from . import common


def rows(p: dict, lanes: int) -> dict:
    """Each leaf's row of every lane: ``(lanes, *shape)``, lane ``j`` on row
    ``j % R``."""
    out = {}
    for k, v in p.items():
        R = v.shape[0]
        if lanes % R:
            raise ValueError(f"{lanes} lanes on {R} rows of {k!r}")
        out[k] = v.repeat((lanes // R,) + (1,) * (v.dim() - 1))
    return out


def _lane_view(p: dict, x: torch.Tensor) -> dict:
    """Params of ``x``'s lanes (its first axis), shaped to broadcast against
    ``x[..., i]``: a leaf ``(L, *shape)`` becomes ``(*shape, L, 1, ...)``,
    so that ``v[i]`` is ``(L, 1, ...)``."""
    lead = x.dim() - 1  # lane axis plus any step axes before the components
    out = {}
    for k, v in rows(p, x.shape[0]).items():
        v = v.movedim(0, -1)  # (*shape, L)
        out[k] = v.reshape(v.shape + (1,) * (lead - 1))
    return out


def f(x, u, p):
    return car.f(x, u, _lane_view(p, x))


def L(x, u, p):
    return car.L(x, u, _lane_view(p, x))


def F(x, p):
    return car.F(x, _lane_view(p, x))


def box(p, lanes: int):
    """Each lane's limits: ``(lo, hi)``, each ``(lanes, 1, n_u)``."""
    q = rows(p, lanes)
    lo = torch.stack([q["limW"][:, 0], q["limA"][:, 0]], dim=-1)
    hi = torch.stack([q["limW"][:, 1], q["limA"][:, 1]], dim=-1)
    return lo[:, None], hi[:, None]


def descent_available(x0, us, p, lo, hi, block: int = 4096):
    """:func:`common.descent_available` with each lane's params and limits:
    blocks of lanes, each with its own rows (``p`` of ``us``'s lanes)."""
    out = [common.descent_available(
        f, L, F, x0[i:i + block], us[i:i + block],
        {k: v[i:i + block] for k, v in p.items()}, lo[i:i + block],
        hi[i:i + block], block=block)
        for i in range(0, us.shape[0], block)]
    return torch.cat(out) if out else us.new_zeros(0)


def per_lane(case, out) -> dict:
    """Each number's per-lane values (``descent`` on the solved lanes)."""
    p, x0 = case["p"], case["x0"]
    xs, us = out["xs"].double(), out["us"].double()
    n = us.shape[0]
    lo, hi = box(p, n)
    ok = common.solved_mask(out["status"])
    ref_cost = common.total_cost(L, F, xs, us, p)
    gap = (out["cost"].double() - ref_cost).abs() / (1.0 + ref_cost.abs())
    mine = {k: v[ok] for k, v in rows(p, n).items()}
    return {
        "dyn": common.dyn_residual(f, x0, xs, us, p),
        "cost": torch.nan_to_num(gap, nan=float("inf")),
        "box": torch.clamp(torch.maximum(lo - us, us - hi), min=0.0)
        .nan_to_num(nan=float("inf")).flatten(1).amax(1),
        "descent": descent_available(x0[ok], us[ok], mine, lo[ok], hi[ok]),
    }


def numbers(case, out, lanes=None) -> dict:
    """``case``: the inputs (``x0``, ``p``: float64 tensors, lanes first,
    ``p`` one row per vehicle); ``out``: the program's ``xs``, ``us``,
    ``cost``, ``status``; ``lanes``: :func:`per_lane`'s values if already
    worked out.  Returns each number's value."""
    lanes = per_lane(case, out) if lanes is None else lanes
    return {"dyn": float(lanes["dyn"].max()),
            "cost": float(lanes["cost"].max()),
            "box": float(lanes["box"].max()),
            "descent_p90": common.p90(lanes["descent"]),
            "unsolved": common.unsolved_pct(out["status"])}
