"""What the configurations' references share: rollouts, the one-step
dynamics residual, projected gradients and the solved-lane share.

Shapes: ``x0 (L, n_x)``, ``us (L, N, n_u)``, ``xs (L, N+1, n_x)`` with L
lanes (every lane of every solve judged, stacked).  Status codes 1 and 2
are the solver's two success exits (gradient and cost-change tolerance).
"""

from __future__ import annotations

import torch

SOLVED = (1, 2)


def solved_mask(status: torch.Tensor) -> torch.Tensor:
    return (status == SOLVED[0]) | (status == SOLVED[1])


def p90(values: torch.Tensor) -> float:
    """The 90th percentile (linear interpolation); inf if empty or not
    finite anywhere it reaches."""
    if values.numel() == 0:
        return float("inf")
    v = torch.nan_to_num(values.double(), nan=float("inf"))
    return float(torch.quantile(v, 0.9))


def quantiles(values: torch.Tensor) -> dict:
    """p50, p90, p99 and max of a per-lane number (calibration)."""
    if values.numel() == 0:
        return {}
    v = torch.nan_to_num(values.double(), nan=float("inf"))
    q = torch.quantile(v, torch.tensor([0.5, 0.9, 0.99], dtype=v.dtype,
                                       device=v.device)).tolist()
    return {"p50": q[0], "p90": q[1], "p99": q[2], "max": float(v.max())}


def unsolved_pct(status: torch.Tensor) -> float:
    """Share of lanes that did not end in a success exit, in percent."""
    return 100.0 * float((~solved_mask(status)).double().mean())


def dyn_residual(f, x0, xs, us, p) -> torch.Tensor:
    """Per lane: the largest gap, relative to ``1 + |x|``, between each
    returned state and the reference's step from the returned state and
    input before it (and between ``xs[:, 0]`` and the input ``x0``)."""
    step = f(xs[:, :-1], us, p)  # (L, N, n_x)
    ref = torch.cat([x0[:, None], step], dim=1)
    gap = (xs - ref).abs() / (1.0 + ref.abs())
    gap = torch.where(torch.isfinite(gap), gap, torch.full_like(gap, float("inf")))
    return gap.flatten(1).amax(dim=1)


def rollout(f, x0, us, p) -> torch.Tensor:
    """States of the open-loop rollout of ``us`` from ``x0``."""
    xs = [x0]
    for k in range(us.shape[1]):
        xs.append(f(xs[-1], us[:, k], p))
    return torch.stack(xs, dim=1)


def total_cost(L, F, xs, us, p) -> torch.Tensor:
    """Per lane: the running costs summed in step order, plus the final cost."""
    run = L(xs[:, :-1], us, p)  # (L, N)
    return run.sum(dim=1) + F(xs[:, -1], p)


def cost_gradient(f, L, F, x0, us, p, block: int = 4096) -> torch.Tensor:
    """d(total cost of the rollout of ``us`` from ``x0``)/d``us``, float64,
    in blocks of lanes."""
    out = []
    for i in range(0, us.shape[0], block):
        u = us[i:i + block].detach().clone().requires_grad_(True)
        x = x0[i:i + block]
        xs = [x]
        for k in range(u.shape[1]):
            xs.append(f(xs[-1], u[:, k], p))
        cost = total_cost(L, F, torch.stack(xs, dim=1), u, p).sum()
        (g,) = torch.autograd.grad(cost, u)
        out.append(g)
    return torch.cat(out)


def rollout_cost(f, L, F, x0, us, p) -> torch.Tensor:
    """Per lane: the total cost of the rollout of ``us`` from ``x0``,
    accumulated step by step (no trajectory kept)."""
    x, cost = x0, torch.zeros_like(x0[:, 0])
    for k in range(us.shape[1]):
        cost = cost + L(x, us[:, k], p)
        x = f(x, us[:, k], p)
    return cost + F(x, p)


# Step sizes of the projected steepest-descent probe (10^-8 .. 10^2).
DESCENT_STEPS = tuple(10.0 ** (e / 4.0) for e in range(-32, 9))


def descent_available(f, L, F, x0, us, p, lo, hi,
                      block: int = 4096) -> torch.Tensor:
    """Per lane: the largest decrease of the total cost that a projected
    steepest-descent step ``clip(us - t g, lo, hi)`` finds over
    :data:`DESCENT_STEPS`, relative to ``1 + |J(us)|``.  At a converged
    lane it is small; a lane that kept its initial inputs reads large.
    Every step size of a block of lanes is one batched rollout."""
    out = []
    ts = torch.tensor(DESCENT_STEPS, dtype=us.dtype, device=us.device)
    nt = len(DESCENT_STEPS)
    for i in range(0, us.shape[0], block):
        u, x = us[i:i + block], x0[i:i + block]
        g = cost_gradient(f, L, F, x, u, p)
        j0 = rollout_cost(f, L, F, x, u, p)
        ut = torch.minimum(torch.maximum(
            u[None] - ts[:, None, None, None] * g[None], lo), hi)
        jt = rollout_cost(f, L, F, x.repeat(nt, 1), ut.flatten(0, 1), p)
        dec = torch.nan_to_num(j0[None] - jt.view(nt, -1), nan=0.0)
        out.append(dec.amax(dim=0).clamp(min=0.0) / (1.0 + j0.abs()))
    return torch.cat(out) if out else us.new_zeros(0)
