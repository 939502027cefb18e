"""Kernel B2: the line-search rollouts as one hand-written CUDA kernel.

Replaces ``ddp_generator_tpu/ops/pallas_rollout.py:rollout_call`` (the
``pl.pallas_call`` at line 424, body ``_make_rollout_kernel``).  Sources:
``csrc/rollout.cu`` and the problem's CUDA model, e.g.
``csrc/models/car_parking.cuh``.  Two modes:

* ``multi=True``: the cost sweep.  One thread per (alpha, lane) rolls the
  whole horizon and writes ``costs (A, B)`` and ``ok (A, B)``, no
  trajectories;
* ``multi=False``: the selected rollout.  One thread per lane rolls its own
  ``alpha_vec`` and writes ``xs (N, n_x, B)``, ``xf (n_x, B)``,
  ``us (N, n_u, B)``, plus ``cost``/``ok (1, B)`` when ``want_cost``.

Each step: ``u = u_nom + alpha*l + L*dx`` (exactly ``u_nom`` when alpha is
0), sequential clamping in constraint order with every limit taken from the
unclamped ``u``, the running cost with AL penalties, the dynamics; ``ok``
needs a finite cost and state at every step while the cost keeps
accumulating.  The final cost is ``F(x_N, p, N)`` plus the ``hfe``/``hfi``
penalties.

The Pallas kernel traced the user's Python functions inside itself; CUDA
cannot, so each problem names a CUDA model of hand-written ``__device__``
functions (``Problem.cuda_model``).  A problem without one raises on a CUDA
device.

On the card (H100): one thread per trajectory, a sequential loop over the
horizon, state in registers.  The bound is the dependent chain of
transcendentals per step (sin, cos, asin, sqrt for CarParking) at low
occupancy: 16k threads in the sweep, 2k in the selected rollout.  Loads of
the nominal trajectory and gains are coalesced over the lane axis, and the
sweep's 8 alphas of one lane read the same addresses, so they hit in L1/L2.

The plain PyTorch version is :func:`rollout_plain`; :func:`rollout_call`
takes it for CPU tensors only.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch

from .. import _build
from ..al import _eq_penalty, _ineq_penalty
from ..problem import Problem
from .linesearch import LineSearchResult

Tensor = torch.Tensor

# Threads per block of the rollout kernel.
BLOCK = 64


def rollout_plain(problem: Problem, alphas: Sequence[float], xnom_cm,
                  unom_cm, l_cm, L_cm, mu_le_cm, mu_li_cm, x0_cm, w_pen_l,
                  w_pen_f, mu_fe_cm, mu_fi_cm, alpha_vec, params: Any,
                  multi: bool, want_cost: bool = False):
    """Plain PyTorch version of kernel B2 on the same operands: a Python
    loop over time on ``(comp, A, B)`` (multi) or ``(comp, B)`` lanes."""
    N, n_x, B = xnom_cm.shape
    n_u = unom_cm.shape[1]
    p = params
    if multi:
        alpha = torch.tensor(alphas, dtype=xnom_cm.dtype,
                             device=xnom_cm.device)[:, None]  # (A, 1)
        x = x0_cm[:, None, :].expand(n_x, len(alphas), B)
        lane = lambda v: v[..., None, :]  # (c, B) -> (c, 1, B)
    else:
        alpha = alpha_vec[0]  # (B,)
        x = x0_cm
        lane = lambda v: v
    wpl, wpf = w_pen_l[0], w_pen_f[0]
    c_acc = torch.zeros_like(x[0])
    ok = torch.ones_like(x[0], dtype=torch.bool)
    open_loop = alpha == 0.0
    xs, us = [], []
    for k in range(N):
        dx = x - lane(xnom_cm[k])
        rows = []
        for j in range(n_u):
            du = alpha * l_cm[k, j]
            for a in range(n_x):
                du = du + L_cm[k, j * n_x + a] * dx[a]
            u_nom = unom_cm[k, j]
            rows.append(torch.where(open_loop, u_nom, u_nom + du))
        u0 = torch.stack(rows)
        # clampU: sequential, every limit from the unclamped u
        for bc in problem.box_constraints:
            hval = bc.fn(x, u0, p, k)
            lim = -bc.sign * (hval - bc.sign * u0[bc.u_index])
            cur = rows[bc.u_index]
            rows[bc.u_index] = (torch.minimum(cur, lim) if bc.sign > 0
                                else torch.maximum(cur, lim))
        u = torch.stack(rows)
        c = problem.L(x, u, p, k)
        for i, fn in enumerate(problem.hle):
            c = c + _eq_penalty(mu_le_cm[k, i], fn(x, u, p, k), wpl)
        for i, fn in enumerate(problem.hli):
            c = c + _ineq_penalty(mu_li_cm[k, i], fn(x, u, p, k), wpl)
        x_next = problem.f(x, u, p, k)
        ok = ok & torch.isfinite(c) & torch.isfinite(x_next).all(0)
        if not multi:
            xs.append(x)
            us.append(u)
        c_acc = c_acc + c
        x = x_next
    out_cost = None
    if multi or want_cost:
        cf = problem.F(x, p, N)
        for i, fn in enumerate(problem.hfe):
            cf = cf + _eq_penalty(mu_fe_cm[i], fn(x, p, N), wpf)
        for i, fn in enumerate(problem.hfi):
            cf = cf + _ineq_penalty(mu_fi_cm[i], fn(x, p, N), wpf)
        out_cost = c_acc + cf
        ok = ok & torch.isfinite(cf)
    if multi:
        return out_cost, ok
    res = (torch.stack(xs), x, torch.stack(us))
    if want_cost:
        res += (out_cost[None], ok[None])
    return res


def rollout_call(problem: Problem, alphas: Sequence[float], xnom_cm, unom_cm,
                 l_cm, L_cm, mu_le_cm, mu_li_cm, x0_cm, w_pen_l, w_pen_f,
                 mu_fe_cm, mu_fi_cm, alpha_vec, params: Any, multi: bool,
                 want_cost: bool = False):
    """One rollout (cost sweep or selected rollout).

    Operands in ``(N, C, B)``/``(C, B)`` layout: ``xnom_cm (N, n_x, B)``,
    ``unom_cm (N, n_u, B)``, ``l_cm (N, n_u, B)``, ``L_cm (N, n_u*n_x, B)``,
    ``mu_le_cm (N, n_hle, B)``, ``x0_cm (n_x, B)``, ``w_pen_* (1, B)``,
    ``mu_fe_cm (n_hfe, B)``, ``alpha_vec (1, B)`` (selected mode only);
    ``params`` a dict of tensors.

    Returns ``(costs (A, B), ok (A, B) bool)`` when ``multi``, else
    ``(xs (N, n_x, B), xf (n_x, B), us (N, n_u, B))`` plus
    ``(cost (1, B), ok (1, B) bool)`` when ``want_cost``.

    CPU tensors run :func:`rollout_plain`; CUDA tensors launch kernel B2 and
    count it in ``rollout_call.launches["multi" | "selected"]``."""
    dev = xnom_cm.device
    if dev.type == "cpu":
        return rollout_plain(problem, alphas, xnom_cm, unom_cm, l_cm, L_cm,
                             mu_le_cm, mu_li_cm, x0_cm, w_pen_l, w_pen_f,
                             mu_fe_cm, mu_fi_cm, alpha_vec, params, multi,
                             want_cost)
    if dev.type != "cuda":
        raise ValueError(f"rollout_call: unsupported device {dev}")
    model = problem.cuda_model
    if model is None:
        raise NotImplementedError(
            f"problem {problem.name!r} names no CUDA model "
            "(Problem.cuda_model): the rollout kernel cannot run it")
    N, n_x, B = xnom_cm.shape
    n_u = unom_cm.shape[1]
    A = len(alphas)
    dtype = xnom_cm.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"rollout_call: dtype {dtype} is not float32/64")
    checks = [("xnom_cm", xnom_cm, (N, n_x, B)),
              ("unom_cm", unom_cm, (N, n_u, B)),
              ("l_cm", l_cm, (N, n_u, B)),
              ("L_cm", L_cm, (N, n_u * n_x, B)),
              ("x0_cm", x0_cm, (n_x, B)),
              ("w_pen_l", w_pen_l, (1, B)), ("w_pen_f", w_pen_f, (1, B))]
    opt = [("mu_le_cm", mu_le_cm, (N, problem.n_hle, B), problem.n_hle),
           ("mu_li_cm", mu_li_cm, (N, problem.n_hli, B), problem.n_hli),
           ("mu_fe_cm", mu_fe_cm, (problem.n_hfe, B), problem.n_hfe),
           ("mu_fi_cm", mu_fi_cm, (problem.n_hfi, B), problem.n_hfi)]
    checks += [(nm, t, s) for nm, t, s, n in opt if n]
    if multi:
        alpha_t = torch.tensor(alphas, dtype=dtype, device=dev)
    else:
        checks.append(("alpha_vec", alpha_vec, (1, B)))
        alpha_t = alpha_vec
    for name, t, shape in checks:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.dtype != dtype or t.device != dev:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, want {dtype} "
                            f"on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (n_x, n_u) != (problem.n_x, problem.n_u):
        raise ValueError("operand widths do not match the problem")
    p_flat = model.flat_params(params, dtype, dev)

    def opt_t(t, n):
        return t if n else None

    if multi:
        cost = torch.empty((A, B), dtype=dtype, device=dev)
        ok = torch.empty((A, B), dtype=torch.bool, device=dev)
        xs = xf = us = None
    else:
        xs = torch.empty((N, n_x, B), dtype=dtype, device=dev)
        xf = torch.empty((n_x, B), dtype=dtype, device=dev)
        us = torch.empty((N, n_u, B), dtype=dtype, device=dev)
        cost = torch.empty((1, B), dtype=dtype, device=dev) if want_cost else None
        ok = (torch.empty((1, B), dtype=torch.bool, device=dev)
              if want_cost else None)
    lib = _build.load_library()
    ptrs = _build.pointer_array([
        xnom_cm, unom_cm, l_cm, L_cm, opt_t(mu_le_cm, problem.n_hle),
        opt_t(mu_li_cm, problem.n_hli), x0_cm, w_pen_l, w_pen_f,
        opt_t(mu_fe_cm, problem.n_hfe), opt_t(mu_fi_cm, problem.n_hfi),
        alpha_t, p_flat, cost, ok, xs, xf, us,
    ])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ddp_rollout(
            0 if dtype == torch.float32 else 1, model.name.encode(),
            int(multi), int(want_cost), N, B, A, BLOCK, ptrs, stream)
    _build.check(lib, rc, "rollout")
    rollout_call.launches["multi" if multi else "selected"] += 1
    if multi:
        return cost, ok
    if want_cost:
        return xs, xf, us, cost, ok
    return xs, xf, us


rollout_call.launches = {"multi": 0, "selected": 0}


def _to_cm(a: Tensor) -> Tensor:
    """``(B, N, d...) -> (N, prod(d), B)``, contiguous."""
    B, N = a.shape[:2]
    return a.reshape(B, N, math.prod(a.shape[2:])).permute(1, 2, 0).contiguous()


class _LSCtx:
    """Component-major operands shared by the line-search rollouts."""

    def __init__(self, problem, x0, xs_nom, us_nom, l, L_gain, dV, cost,
                 mu_le, mu_li, mu_fe, mu_fi, w_pen_l, w_pen_f):
        B, Np1, n_x = xs_nom.shape
        self.B, self.N = B, Np1 - 1
        self.dtype, self.device = us_nom.dtype, us_nom.device
        N = self.N
        self.xnom_cm = _to_cm(xs_nom[:, :N])
        self.unom_cm = _to_cm(us_nom)
        self.l_cm = _to_cm(l)
        self.L_cm = _to_cm(L_gain)
        self.mu_le_cm = _to_cm(mu_le)
        self.mu_li_cm = _to_cm(mu_li)
        self.x0_cm = x0.T.contiguous()
        self.mu_fe_cm = mu_fe.T.contiguous()
        self.mu_fi_cm = mu_fi.T.contiguous()
        self.wpl = w_pen_l[None, :].contiguous()
        self.wpf = w_pen_f[None, :].contiguous()
        self.dV = dV
        self.cost = cost
        self.xs_nom = xs_nom
        self.us_nom = us_nom

    def call(self, problem, alphas, params, alpha_vec, multi,
             want_cost=False):
        return rollout_call(
            problem, alphas, self.xnom_cm, self.unom_cm, self.l_cm,
            self.L_cm, self.mu_le_cm, self.mu_li_cm, self.x0_cm, self.wpl,
            self.wpf, self.mu_fe_cm, self.mu_fi_cm, alpha_vec, params,
            multi=multi, want_cost=want_cost)


def _select_first_accept(alphas, costs, ok, ctx: _LSCtx, z_min: float):
    """First accepted alpha per lane (``line_search.c:41-54``).  Returns
    ``(idx, any_ok, dcost, expected, z, al (A, 1))``."""
    A = len(alphas)
    al = torch.tensor(alphas, dtype=ctx.dtype, device=ctx.device)[:, None]
    dcost = ctx.cost[None, :] - costs
    expected = -al * (ctx.dV[:, 0][None, :] + al * ctx.dV[:, 1][None, :])
    pos = expected > 0.0
    z = torch.where(pos, dcost / torch.where(pos, expected, 1.0), 0.0)
    accepted = ok & (z > z_min)
    idx_first = accepted.to(torch.int32).argmax(0)
    any_ok = accepted.any(0)
    idx = torch.where(any_ok, idx_first, A - 1)
    return idx, any_ok, dcost, expected, z, al


def _traj_out(xs_cm, xf_cm, us_cm):
    xs_full = torch.cat([xs_cm, xf_cm[None]], 0)  # (N+1, n_x, B)
    return xs_full.permute(2, 0, 1), us_cm.permute(2, 0, 1)


def kernel_line_search(problem, alphas, x0, xs_nom, us_nom, l, L_gain, dV,
                       cost, z_min, params, mu_le, mu_li, mu_fe, mu_fi,
                       w_pen_l, w_pen_f) -> LineSearchResult:
    """Batched line search on the two rollout modes (port of JAX's
    ``pallas_line_search``): full sweep, first-accept selection, selected
    rollout.  Batch-major operands (``x0 (B, n_x)``, ``xs_nom (B, N+1,
    n_x)``, ``L_gain (B, N, n_u, n_x)``, ``dV (B, 2)``, ``cost (B,)``)."""
    A = len(alphas)
    ctx = _LSCtx(problem, x0, xs_nom, us_nom, l, L_gain, dV, cost,
                 mu_le, mu_li, mu_fe, mu_fi, w_pen_l, w_pen_f)
    costs, okf = ctx.call(problem, alphas, params, None, multi=True)
    idx, any_ok, dcost, expected, z, al = _select_first_accept(
        alphas, costs, okf, ctx, z_min)
    take = lambda m: m.gather(0, idx[None, :])[0]
    alpha_vec = take(al.expand(A, ctx.B))
    xs_cm, xf_cm, us_cm = ctx.call(problem, alphas, params,
                                   alpha_vec[None, :].contiguous(),
                                   multi=False)
    xs_out, us_out = _traj_out(xs_cm, xf_cm, us_cm)
    return LineSearchResult(
        success=any_ok, xs=xs_out, us=us_out, new_cost=take(costs),
        dcost=take(dcost), expected=take(expected), z=take(z),
        alpha_index=torch.where(any_ok, idx, A).to(torch.int32))


def kernel_line_search_staged(problem, alphas, x0, xs_nom, us_nom, l, L_gain,
                              dV, cost, z_min, params, mu_le, mu_li, mu_fe,
                              mu_fi, w_pen_l, w_pen_f,
                              alive: Tensor) -> LineSearchResult:
    """Line search with the alpha[0] fast path (port of JAX's
    ``pallas_line_search_staged``).

    Stage 1 rolls only alpha[0] (trajectory and cost); the full sweep runs
    only when some ``alive`` lane rejects it, and inside that path the
    selected rollout is skipped when no live lane accepted an alpha past
    alpha[0].  With no live lane at all, no rollout runs.  Each ``lax.cond``
    of the JAX version is a Python branch on a host-read boolean: at most
    three host syncs per call.  Per live lane the result equals
    :func:`kernel_line_search`'s."""
    A = len(alphas)
    ctx = _LSCtx(problem, x0, xs_nom, us_nom, l, L_gain, dV, cost,
                 mu_le, mu_li, mu_fe, mu_fi, w_pen_l, w_pen_f)
    B, dtype, dev = ctx.B, ctx.dtype, ctx.device
    if not bool(alive.any()):
        # No live lane consumes this search: skip both rollouts.
        zeros = torch.zeros((B,), dtype=dtype, device=dev)
        return LineSearchResult(
            success=torch.zeros((B,), dtype=torch.bool, device=dev),
            xs=ctx.xs_nom, us=ctx.us_nom, new_cost=ctx.cost, dcost=zeros,
            expected=zeros, z=zeros,
            alpha_index=torch.full((B,), A, dtype=torch.int32, device=dev))

    a0 = float(alphas[0])
    alpha0_vec = torch.full((1, B), a0, dtype=dtype, device=dev)
    xs0, xf0, us0, cost0, ok0 = ctx.call(problem, alphas, params, alpha0_vec,
                                         multi=False, want_cost=True)
    cost0, ok0 = cost0[0], ok0[0]
    dcost0 = ctx.cost - cost0
    expected0 = -a0 * (ctx.dV[:, 0] + a0 * ctx.dV[:, 1])
    pos0 = expected0 > 0.0
    z0 = torch.where(pos0, dcost0 / torch.where(pos0, expected0, 1.0), 0.0)
    acc0 = ok0 & (z0 > z_min)
    if not bool((alive & ~acc0).any()):
        xs_out, us_out = _traj_out(xs0, xf0, us0)
        return LineSearchResult(
            success=acc0, xs=xs_out, us=us_out, new_cost=cost0,
            dcost=dcost0, expected=expected0, z=z0,
            alpha_index=torch.where(acc0, 0, A).to(torch.int32))

    costs, okf = ctx.call(problem, alphas, params, None, multi=True)
    idx, any_ok, dcost, expected, z, al = _select_first_accept(
        alphas, costs, okf, ctx, z_min)
    take = lambda m: m.gather(0, idx[None, :])[0]
    if bool((alive & any_ok & (idx > 0)).any()):
        alpha_vec = take(al.expand(A, B))
        xs_cm, xf_cm, us_cm = ctx.call(problem, alphas, params,
                                       alpha_vec[None, :].contiguous(),
                                       multi=False)
    else:
        # every accepting live lane took alpha[0]: stage 1's trajectory is
        # the selected one (same kernel, same alpha)
        xs_cm, xf_cm, us_cm = xs0, xf0, us0
    xs_out, us_out = _traj_out(xs_cm, xf_cm, us_cm)
    return LineSearchResult(
        success=any_ok, xs=xs_out, us=us_out, new_cost=take(costs),
        dcost=take(dcost), expected=take(expected), z=take(z),
        alpha_index=torch.where(any_ok, idx, A).to(torch.int32))
