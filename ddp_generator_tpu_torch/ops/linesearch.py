"""Multi-alpha line search (``ddp_generator_tpu.ops.linesearch``).

The accepted candidate is the first (largest) alpha with ``z > zMin``; when
every alpha fails, ``new_cost``/``dcost``/``expected`` come from the last
alpha (``line_search.c:70-76``).  :func:`line_search` is the serial path
(``linesearch_method="serial"``): every alpha of every lane rolls out
through :func:`.forward.forward_pass` as one rollout of ``A*B``
trajectories.  The kernel path runs on kernel B2, ``ops/cuda_rollout.py``.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch

from ..problem import LaneParams
from .forward import forward_pass

Tensor = torch.Tensor


class LineSearchResult(NamedTuple):
    success: Tensor  # (B,) bool
    xs: Tensor  # (B, N+1, n_x) accepted candidate trajectory
    us: Tensor  # (B, N, n_u)
    new_cost: Tensor
    dcost: Tensor
    expected: Tensor
    z: Tensor
    alpha_index: Tensor  # int32 index into the alpha schedule (n_alpha if none)


def first_accept(al: Tensor, costs: Tensor, ok: Tensor, cost: Tensor,
                 dV: Tensor, z_min: float):
    """First accepted alpha per lane (``line_search.c:41-54``) from the
    costs ``(A, B)`` and finiteness ``ok (A, B)`` of every rollout;
    ``al (A, 1)``.  Returns ``(idx, any_ok, dcost, expected, z)``, ``idx``
    the last alpha where none is accepted."""
    A = costs.shape[0]
    dcost = cost[None, :] - costs
    expected = -al * (dV[:, 0][None, :] + al * dV[:, 1][None, :])
    pos = expected > 0.0
    z = torch.where(pos, dcost / torch.where(pos, expected, 1.0), 0.0)
    accepted = ok & (z > z_min)
    idx_first = accepted.to(torch.int32).argmax(0)
    any_ok = accepted.any(0)
    idx = torch.where(any_ok, idx_first, A - 1)
    return idx, any_ok, dcost, expected, z


def line_search(problem, alphas: Tensor | Sequence[float], x0, xs_nom,
                us_nom, l, L_gain, dV, cost, z_min: float, p: Any, mu_le,
                mu_li, mu_fe, mu_fi, w_pen_l, w_pen_f) -> LineSearchResult:
    """Serial line search of every lane: batch-major operands as
    :func:`.cuda_rollout.kernel_line_search` takes them (``x0 (B, n_x)``,
    ``xs_nom (B, N+1, n_x)``, ``L_gain (B, N, n_u, n_x)``, ``dV (B, 2)``,
    ``cost (B,)``); ``p`` shared, or per lane as
    :class:`~..problem.LaneParams`.  ``alphas`` is the schedule as a
    tensor in the operands' dtype and device, as the solver's body call
    passes it (a copy from host memory cannot be captured in a CUDA
    graph), or a sequence of numbers, copied here."""
    A, B = len(alphas), x0.shape[0]
    al = (alphas if isinstance(alphas, Tensor) else
          torch.tensor(alphas, dtype=us_nom.dtype, device=us_nom.device))

    def rep(t):  # (B, ...) -> (A*B, ...), alpha-major
        return t.expand((A,) + t.shape).reshape((A * B,) + t.shape[1:])

    if isinstance(p, LaneParams):  # lane a*B + b reads lane b's params
        p = p.take(torch.arange(A * B, device=x0.device) % B)
    al_lanes = al[:, None].expand(A, B).reshape(A * B)  # alpha-major
    r = forward_pass(problem, rep(x0), rep(xs_nom), rep(us_nom), rep(l),
                     rep(L_gain), al_lanes, p, rep(mu_le), rep(mu_li),
                     rep(mu_fe), rep(mu_fi), rep(w_pen_l), rep(w_pen_f))
    costs = r.cost.reshape(A, B)
    idx, any_ok, dcost, expected, z = first_accept(
        al[:, None], costs, r.ok.reshape(A, B), cost, dV, z_min)
    lanes = torch.arange(B, device=idx.device)
    take = lambda m: m[idx, lanes]
    return LineSearchResult(
        success=any_ok, xs=r.xs.reshape((A, B) + r.xs.shape[1:])[idx, lanes],
        us=r.us.reshape((A, B) + r.us.shape[1:])[idx, lanes],
        new_cost=take(costs), dcost=take(dcost), expected=take(expected),
        z=take(z), alpha_index=torch.where(any_ok, idx, A).to(torch.int32))
