"""Augmented-Lagrangian handling of general constraints (``ddp_generator_tpu.al``).

* equality (hle/hfe):   ``p  = mu*h + 0.5*w_pen*h^2``,  ``mu+ = mu + w_pen*h``
* inequality (hli/hfi): ``p  = mu*h*(1 + w_pen*h)`` if ``h >= 0``, else
  ``mu*h / (1 - w_pen*h)``; ``mu+ = mu*(1 + 2*w_pen*h)`` if ``h >= 0``,
  else ``mu*(1 - w_pen*h)^-2``  (``iLQG_func.tem:417-509``).

Batched layout: running multipliers are ``(B, N, n)``, final ones
``(B, n)``, penalty weights ``(B,)``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .problem import Problem, step_index

Tensor = torch.Tensor


class Multipliers(NamedTuple):
    """AL multiplier state (reference ``multipliers_t``)."""

    mu_le: Tensor  # (B, N, n_hle)
    mu_li: Tensor  # (B, N, n_hli)
    mu_fe: Tensor  # (B, n_hfe)
    mu_fi: Tensor  # (B, n_hfi)
    last_hle: Tensor  # (B, N, n_hle)
    last_hli: Tensor  # (B, N, n_hli)
    last_hfe: Tensor  # (B, n_hfe)
    last_hfi: Tensor  # (B, n_hfi)


def init_multipliers(problem: Problem, B: int, n_hor: int, dtype,
                     device) -> Multipliers:
    """mu_e = 0, mu_i = 1, last_h = 0 (``iLQG_func.tem:371-400``)."""
    z = lambda *s: torch.zeros((B,) + s, dtype=dtype, device=device)
    o = lambda *s: torch.ones((B,) + s, dtype=dtype, device=device)
    return Multipliers(
        mu_le=z(n_hor, problem.n_hle),
        mu_li=o(n_hor, problem.n_hli),
        mu_fe=z(problem.n_hfe),
        mu_fi=o(problem.n_hfi),
        last_hle=z(n_hor, problem.n_hle),
        last_hli=z(n_hor, problem.n_hli),
        last_hfe=z(problem.n_hfe),
        last_hfi=z(problem.n_hfi),
    )


def _eq_penalty(mu, h, w_pen):
    return mu * h + 0.5 * w_pen * h * h


def _ineq_penalty(mu, h, w_pen):
    # Ruxton: active branch mu*h*(1+w*h); inactive mu*h/(1-w*h).
    active = mu * h * (1.0 + w_pen * h)
    inactive = mu * h / (1.0 - w_pen * h)
    return torch.where(h >= 0.0, active, inactive)


def augmented_L(problem: Problem, x, u, p, k, mu_le, mu_li, w_pen_l):
    """Running cost with AL penalties (``genenerator_main.mac:89-124``).

    Component-first: ``x (n_x, *b)``, ``mu_le (n_hle, *b)``, ``w_pen_l``
    broadcastable to ``b``."""
    c = problem.L(x, u, p, k)
    for i, fn in enumerate(problem.hle):
        c = c + _eq_penalty(mu_le[i], fn(x, u, p, k), w_pen_l)
    for i, fn in enumerate(problem.hli):
        c = c + _ineq_penalty(mu_li[i], fn(x, u, p, k), w_pen_l)
    return c


def augmented_F(problem: Problem, x, p, k, mu_fe, mu_fi, w_pen_f):
    """Final cost with AL penalties (``genenerator_main.mac:46-87``)."""
    c = problem.F(x, p, k)
    for i, fn in enumerate(problem.hfe):
        c = c + _eq_penalty(mu_fe[i], fn(x, p, k), w_pen_f)
    for i, fn in enumerate(problem.hfi):
        c = c + _ineq_penalty(mu_fi[i], fn(x, p, k), w_pen_f)
    return c


class MultiplierUpdate(NamedTuple):
    multipliers: Multipliers
    w_pen_l: Tensor
    w_pen_f: Tensor


def _stack_or_empty(vals, like_shape, dtype, device):
    if vals:
        return torch.stack(vals, dim=-1)
    return torch.zeros(like_shape + (0,), dtype=dtype, device=device)


def update_multipliers(
    problem: Problem,
    xs: Tensor,  # (B, N+1, n_x)
    us: Tensor,  # (B, N, n_u)
    p: Any,
    mult: Multipliers,
    w_pen_l: Tensor,  # (B,)
    w_pen_f: Tensor,
    w_pen_max_l: float,
    w_pen_max_f: float,
    w_pen_fact1: float,
    tolConstraint: float,
    init: bool,
) -> MultiplierUpdate:
    """Batched ``update_multipliers`` (``iLQG_func.tem:417-509``).  With
    ``init=True`` only ``last_*`` are recorded (``iLQG_func.tem:443,489``)."""
    B, N = us.shape[0], us.shape[1]
    dtype, dev = us.dtype, us.device
    x_cm = xs[:, :N].permute(2, 1, 0)  # (n_x, N, B)
    u_cm = us.permute(2, 1, 0)
    k = step_index(p, N, dev)
    hle_all = _stack_or_empty(
        [fn(x_cm, u_cm, p, k).expand(N, B).T for fn in problem.hle],
        (B, N), dtype, dev)  # (B, N, n_hle)
    hli_all = _stack_or_empty(
        [fn(x_cm, u_cm, p, k).expand(N, B).T for fn in problem.hli],
        (B, N), dtype, dev)
    xF = xs[:, N].T  # (n_x, B)
    hfe = _stack_or_empty([fn(xF, p, N).expand(B) for fn in problem.hfe],
                          (B,), dtype, dev)
    hfi = _stack_or_empty([fn(xF, p, N).expand(B) for fn in problem.hfi],
                          (B,), dtype, dev)

    def any_lane(m):  # (B, ...) bool -> (B,)
        return m.reshape(B, -1).any(dim=1)

    # increase_pen tests (iLQG_func.tem:428-440, 471-483)
    inc_l = torch.zeros(B, dtype=torch.bool, device=dev)
    if problem.n_hle:
        inc_l |= any_lane((hle_all.abs() > tolConstraint)
                          & (w_pen_fact1 * hle_all.abs() > mult.last_hle.abs()))
    if problem.n_hli:
        inc_l |= any_lane((hli_all > tolConstraint)
                          & (w_pen_fact1 * hli_all > mult.last_hli))
    inc_f = torch.zeros(B, dtype=torch.bool, device=dev)
    if problem.n_hfe:
        inc_f |= any_lane((hfe.abs() > tolConstraint)
                          & (w_pen_fact1 * hfe.abs() > mult.last_hfe.abs()))
    if problem.n_hfi:
        inc_f |= any_lane((hfi > tolConstraint)
                          & (w_pen_fact1 * hfi > mult.last_hfi))

    if init:
        new_mult = mult._replace(last_hle=hle_all, last_hli=hli_all,
                                 last_hfe=hfe, last_hfi=hfi)
        return MultiplierUpdate(new_mult, w_pen_l, w_pen_f)

    # Multiplier updates use the current w_pen (iLQG_func.tem:456-457,486).
    wl3, wf2 = w_pen_l[:, None, None], w_pen_f[:, None]
    mu_le = mult.mu_le + wl3 * hle_all
    mu_li = torch.where(hli_all >= 0.0,
                        mult.mu_li * (1.0 + 2.0 * wl3 * hli_all),
                        mult.mu_li * (1.0 - wl3 * hli_all) ** -2)
    mu_fe = mult.mu_fe + wf2 * hfe
    mu_fi = torch.where(hfi >= 0.0,
                        mult.mu_fi * (1.0 + 2.0 * wf2 * hfi),
                        mult.mu_fi * (1.0 - wf2 * hfi) ** -2)
    new_w_pen_l = torch.where(
        inc_l, torch.clamp(w_pen_l * w_pen_fact1, max=w_pen_max_l), w_pen_l)
    new_w_pen_f = torch.where(
        inc_f, torch.clamp(w_pen_f * w_pen_fact1, max=w_pen_max_f), w_pen_f)
    new_mult = Multipliers(mu_le=mu_le, mu_li=mu_li, mu_fe=mu_fe, mu_fi=mu_fi,
                           last_hle=hle_all, last_hli=hli_all,
                           last_hfe=hfe, last_hfi=hfi)
    return MultiplierUpdate(new_mult, new_w_pen_l, new_w_pen_f)
