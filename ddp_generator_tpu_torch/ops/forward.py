"""Forward rollout (``ddp_generator_tpu.ops.forward``), batched.

The initial open-loop rollout of the solver, the rollouts of the serial
line search (``ops/linesearch.py``) and :func:`cost_only`.  A Python loop
over the horizon on ``(comp, B)`` lane tensors: the control update
``u = u_nom + alpha*l + L*(x - x_nom)`` (``alpha`` one number or one per
lane) with the exact open-loop branch ``alpha == 0 => u_nom``
(``iLQG_func.tem:145-158``), ``clampU``,
dynamics and AL-augmented cost; NaN/Inf anywhere turns into ``ok=False``
(``genenerator_main.mac:193-198``), never an exception.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..al import augmented_F, augmented_L
from ..problem import Problem, clamp_u, step_index
from .small import mv

Tensor = torch.Tensor


class Rollout(NamedTuple):
    xs: Tensor  # (B, N+1, n_x)
    us: Tensor  # (B, N, n_u)
    cost: Tensor  # (B,) total AL-augmented cost
    ok: Tensor  # (B,) bool: everything finite


def forward_pass(
    problem: Problem,
    x0: Tensor,  # (B, n_x)
    xs_nom: Tensor,  # (B, N+1, n_x)
    us_nom: Tensor,  # (B, N, n_u)
    l: Tensor,  # (B, N, n_u)
    L_gain: Tensor,  # (B, N, n_u, n_x)
    alpha,  # float, or (B,) per lane; 0 => open loop
    p: Any,
    mu_le: Tensor,  # (B, N, n_hle)
    mu_li: Tensor,
    mu_fe: Tensor,  # (B, n_hfe)
    mu_fi: Tensor,
    w_pen_l: Tensor,  # (B,)
    w_pen_f: Tensor,
) -> Rollout:
    N = us_nom.shape[1]
    x = x0.T  # (n_x, B)
    csum = torch.zeros_like(w_pen_l)
    # sum of (v - v) over every state and cost: 0 while all are finite,
    # NaN from the first inf/NaN on
    nonfinite = torch.zeros_like(w_pen_l)
    xs, us = [], []
    per_lane = isinstance(alpha, Tensor)
    if per_lane:
        open_loop = alpha == 0.0
    for k in range(N):
        u_nom = us_nom[:, k].T
        if not per_lane and alpha == 0.0:
            u = u_nom  # exact open-loop branch (iLQG_func.tem:155-158)
        else:
            dx = x - xs_nom[:, k].T
            du = alpha * l[:, k].T + mv(L_gain[:, k], dx.T).T
            u = u_nom + du
            if per_lane:
                u = torch.where(open_loop, u_nom, u)
        u = clamp_u(problem, x, u, p, k)
        x_next = problem.f(x, u, p, k)
        c = augmented_L(problem, x, u, p, k, mu_le[:, k].T, mu_li[:, k].T,
                        w_pen_l)
        nonfinite = nonfinite + (x_next - x_next).sum(0) + (c - c)
        xs.append(x)
        us.append(u)
        csum = csum + c
        x = x_next
    cf = augmented_F(problem, x, p, N, mu_fe.T, mu_fi.T, w_pen_f)
    xs.append(x)
    return Rollout(xs=torch.stack(xs).permute(2, 0, 1),
                   us=torch.stack(us).permute(2, 0, 1),
                   cost=csum + cf, ok=(nonfinite == 0.0) & torch.isfinite(cf))


def cost_only(problem: Problem, xs: Tensor, us: Tensor, p: Any, mu_le, mu_li,
              mu_fe, mu_fi, w_pen_l, w_pen_f) -> Tensor:
    """Cost of existing trajectories ``xs (B, N+1, n_x)``, ``us (B, N, n_u)``
    under (possibly new) penalties (``forward_pass(..., cost_only=1)``,
    ``iLQG.c:338,348``).  Returns ``(B,)``."""
    N = us.shape[1]
    x_cm = xs[:, :N].permute(2, 1, 0)  # (n_x, N, B)
    u_cm = us.permute(2, 1, 0)
    k = step_index(p, N, us.device)
    cs = augmented_L(problem, x_cm, u_cm, p, k, mu_le.permute(2, 1, 0),
                     mu_li.permute(2, 1, 0), w_pen_l)  # (N, B)
    cf = augmented_F(problem, xs[:, N].T, p, N, mu_fe.T, mu_fi.T, w_pen_f)
    return cs.sum(0) + cf
