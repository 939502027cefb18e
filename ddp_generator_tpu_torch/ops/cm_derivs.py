"""Component-major derivative bundle emission (``ddp_generator_tpu.ops.cm_derivs``).

The batched solve feeds the backward-pass kernel a packed, component-OUTER
bundle: every per-step quantity is a ``(C, N, B)`` array with the batch
contiguous, so thread ``b`` of the kernel reads ``comp*N*B + t*B + b`` and
neighbouring threads read neighbouring addresses.  Symmetric components
(``cxx``, ``cuu`` and the last two axes of ``fxx``/``fuu``) are packed as
row-major upper triangles: 159 components per step for CarParking with
FULL_DDP, which the kernel reads beside the 2 of ``us``.

The derivatives come from reverse-mode ``torch.autograd.grad`` on the
whole ``(comp, N, B)`` plane at once: the user functions are component-
first and act on each lane separately (see ``problem.py``), so the gradient
of a lane-sum is every lane's own gradient.  First-order columns keep their
graph, and each is differentiated once more for the second-order family:
the bundle is emitted family by family, never as one Jacobian tower.  This
ports ``ddp_generator_tpu.ops.pallas_fused.step_derivative_components`` and
``final_derivative_components`` (plain XLA math in the JAX package too;
reverse mode here because ``torch.func``'s nested forward mode costs ~8x
more host time per call).  This is torch code, not a hand kernel.  Unlike
the JAX version there is no 128-lane padding.

``derivs_emitter="shared"`` takes :func:`step_derivative_components_shared`
instead (JAX's ``step_derivative_components_shared``): one primal trace of
``(f, L)`` and every column of an order in one batched autograd call.
Both emitters give the same bundle to rounding; which is faster is a
question of scheduling (PERF.md records the launches of each).
"""

from __future__ import annotations

from typing import Any

import torch

from ..al import _eq_penalty, _ineq_penalty
from ..problem import Problem, step_index
from .cuda_backpass import BackPassResult, back_pass_cm, result_from_cm

Tensor = torch.Tensor


def _lane_grads(y: Tensor, inputs, create_graph: bool):
    """Per-lane gradients of a lane-separable plane ``y`` w.r.t. each of
    ``inputs``; zeros where ``y`` does not depend on one."""
    zeros = [torch.zeros_like(t) for t in inputs]
    if not y.requires_grad:
        return zeros
    gs = torch.autograd.grad(y.sum(), inputs, create_graph=create_graph,
                             retain_graph=True, allow_unused=True)
    return [z if g is None else g for g, z in zip(gs, zeros)]


def _columns(y: Tensor, xx: Tensor, uu: Tensor, create_graph: bool):
    """``[dy/dx_0, ..., dy/dx_{n_x-1}, dy/du_0, ...]`` as ``(N, B)`` planes."""
    gx, gu = _lane_grads(y, (xx, uu), create_graph)
    return list(gx) + list(gu)


def _box_limit_components(problem: Problem, x, u, p, k):
    """Box limits (limitsU, ``iLQG_func.tem:75-119``) as component lists of
    ``(N, B)`` planes, bounds relative to ``u``."""
    NX, NU = problem.n_x, problem.n_u
    zero = torch.zeros_like(x[0])
    inf = torch.full_like(zero, float("inf"))
    lower, upper = [-inf] * NU, [inf] * NU
    lo_hx = [[zero] * NX for _ in range(NU)]
    up_hx = [[zero] * NX for _ in range(NU)]
    lo_s, up_s = [zero] * NU, [zero] * NU
    for bc in problem.box_constraints:
        hval = bc.fn(x, u, p, k)
        lim = -bc.sign * (hval - bc.sign * u[bc.u_index])
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            (gx,) = _lane_grads(bc.fn(xx, u, p, k).expand_as(zero), (xx,),
                                create_graph=False)
        hx = [g.detach() for g in gx]
        j = bc.u_index
        sgn = torch.full_like(zero, bc.sign)
        # where, not a blend: the untightened bound is +-inf.
        if bc.sign > 0:
            tighter = lim < upper[j]
            upper[j] = torch.where(tighter, lim, upper[j])
            up_s[j] = torch.where(tighter, sgn, up_s[j])
            up_hx[j] = [torch.where(tighter, hx[b], up_hx[j][b])
                        for b in range(NX)]
        else:
            tighter = lim > lower[j]
            lower[j] = torch.where(tighter, lim, lower[j])
            lo_s[j] = torch.where(tighter, sgn, lo_s[j])
            lo_hx[j] = [torch.where(tighter, hx[b], lo_hx[j][b])
                        for b in range(NX)]
    lower = [lower[a] - u[a] for a in range(NU)]
    upper = [upper[a] - u[a] for a in range(NU)]
    return lower, upper, lo_hx, up_hx, lo_s, up_s


def step_derivative_components(problem: Problem, x, u, p, k, mu_le, mu_li,
                               wpl, full_ddp: bool) -> dict:
    """Packed per-step derivative objects on the ``(N, B)`` plane.

    ``x (n_x, N, B)``, ``u (n_u, N, B)``, ``mu_le (n_hle, N, B)``,
    ``wpl (B,)``, ``k (N, 1)``.  Returns a dict keyed like ``StepDerivs`` of
    component-outer ``(C, N, B)`` tensors."""
    NX, NU = problem.n_x, problem.n_u

    def L_fn(xx, uu):
        c = problem.L(xx, uu, p, k)
        for i, fn in enumerate(problem.hle):
            c = c + _eq_penalty(mu_le[i], fn(xx, uu, p, k), wpl)
        for i, fn in enumerate(problem.hli):
            c = c + _ineq_penalty(mu_li[i], fn(xx, uu, p, k), wpl)
        return c

    out = {}
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        uu = u.detach().requires_grad_(True)
        # dynamics: F1[i][j] = d f_i / d dir_j; F2[i][a][b] = d2 f_i / da db
        fv = problem.f(xx, uu, p, k)
        F1 = [_columns(fv[i], xx, uu, full_ddp) for i in range(NX)]
        if full_ddp:
            F2 = [[_columns(F1[i][a], xx, uu, False) for a in range(NX + NU)]
                  for i in range(NX)]
        # cost: C1[a] = dL/da, C2[a][b] = d2L/da db
        C1 = _columns(L_fn(xx, uu), xx, uu, True)
        C2 = [_columns(C1[a], xx, uu, False) for a in range(NX + NU)]
    out["fx"] = [F1[i][j] for i in range(NX) for j in range(NX)]
    out["fu"] = [F1[i][NX + j] for i in range(NX) for j in range(NU)]
    out["cx"] = [C1[a] for a in range(NX)]
    out["cu"] = [C1[NX + a] for a in range(NU)]
    out["cxx"] = [C2[a][b] for a in range(NX) for b in range(a, NX)]
    out["cuu"] = [C2[NX + a][NX + b] for a in range(NU) for b in range(a, NU)]
    out["cxu"] = [C2[a][NX + b] for a in range(NX) for b in range(NU)]
    if full_ddp:
        out["fxx"] = [F2[i][a][b] for i in range(NX)
                      for a in range(NX) for b in range(a, NX)]
        out["fuu"] = [F2[i][NX + a][NX + b] for i in range(NX)
                      for a in range(NU) for b in range(a, NU)]
        out["fxu"] = [F2[i][a][NX + b] for i in range(NX)
                      for a in range(NX) for b in range(NU)]
    else:
        out["fxx"] = out["fuu"] = out["fxu"] = []
    return _packed(problem, x, u, p, k, out)


def _packed(problem: Problem, x, u, p, k, out: dict) -> dict:
    """``out`` (lists of ``(N, B)`` planes) with the box limits added,
    each stacked into a ``(C, N, B)`` tensor."""
    lower, upper, lo_hx, up_hx, lo_s, up_s = _box_limit_components(
        problem, x, u, p, k)
    out["lower"], out["upper"] = lower, upper
    out["lower_hx"] = [v for row in lo_hx for v in row]
    out["upper_hx"] = [v for row in up_hx for v in row]
    out["lower_sign"], out["upper_sign"] = lo_s, up_s
    N, B = x.shape[1], x.shape[2]
    return {
        key: (torch.stack(v).detach() if v
              else torch.zeros((0, N, B), dtype=x.dtype, device=x.device))
        for key, v in out.items()
    }


def step_derivative_components_shared(problem: Problem, x, u, p, k, mu_le,
                                      mu_li, wpl, full_ddp: bool) -> dict:
    """:func:`step_derivative_components` from ONE primal trace of ``f``
    and ``L`` together (port of JAX's
    ``pallas_fused.step_derivative_components_shared``).

    The outputs ``Y = [f_0 .. f_{n_x-1}, L]`` are traced once; one batched
    vector-Jacobian product (``is_grads_batched``, a one-hot cotangent per
    output) gives every first-order column ``J[r][a] = dY_r / d dir_a``,
    and one more over the columns that have a second order (all with
    ``full_ddp``, else ``L``'s) gives ``d J[r][a] / d dir_b``: two autograd
    calls where the per-family emitter makes ``(n_x + 1) (1 + n_x + n_u)``.
    Same contract; values agree to rounding (the association differs where
    a vmapped backward sums in another order)."""
    NX, NU = problem.n_x, problem.n_u
    D, R = NX + NU, NX + 1
    N, B = x.shape[1], x.shape[2]

    def onehot(m):  # (m, m, N, B) one-hot cotangents, stride 0 over (N, B)
        eye = torch.eye(m, dtype=x.dtype, device=x.device)
        return eye[:, :, None, None].expand(m, m, N, B)

    def columns(y, xx, uu, create_graph):  # (m, N, B) -> (m, D, N, B)
        gs = torch.autograd.grad(y, (xx, uu), onehot(y.shape[0]),
                                 create_graph=create_graph, allow_unused=True,
                                 is_grads_batched=True)
        gx, gu = (torch.zeros((y.shape[0],) + t.shape, dtype=x.dtype,
                              device=x.device) if g is None else g
                  for g, t in zip(gs, (xx, uu)))
        return torch.cat([gx, gu], 1)

    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        uu = u.detach().requires_grad_(True)
        c = problem.L(xx, uu, p, k)
        for i, fn in enumerate(problem.hle):
            c = c + _eq_penalty(mu_le[i], fn(xx, uu, p, k), wpl)
        for i, fn in enumerate(problem.hli):
            c = c + _ineq_penalty(mu_li[i], fn(xx, uu, p, k), wpl)
        Y = torch.cat([problem.f(xx, uu, p, k), c.expand(N, B)[None]])
        J = columns(Y, xx, uu, True)  # (R, D, N, B)
        rows = J if full_ddp else J[NX:]  # the outputs with a 2nd order
        H = columns(rows.reshape(-1, N, B), xx, uu, False)
        H = H.reshape(rows.shape[0], D, D, N, B)
    C2 = H[-1]  # L's: C2[a][b] = d2L / d dir_a d dir_b
    out = {
        "fx": [J[i, j] for i in range(NX) for j in range(NX)],
        "fu": [J[i, NX + j] for i in range(NX) for j in range(NU)],
        "cx": [J[NX, a] for a in range(NX)],
        "cu": [J[NX, NX + a] for a in range(NU)],
        "cxx": [C2[a, b] for a in range(NX) for b in range(a, NX)],
        "cuu": [C2[NX + a, NX + b] for a in range(NU)
                for b in range(a, NU)],
        "cxu": [C2[a, NX + b] for a in range(NX) for b in range(NU)],
    }
    if full_ddp:
        out["fxx"] = [H[i, a, b] for i in range(NX)
                      for a in range(NX) for b in range(a, NX)]
        out["fuu"] = [H[i, NX + a, NX + b] for i in range(NX)
                      for a in range(NU) for b in range(a, NU)]
        out["fxu"] = [H[i, a, NX + b] for i in range(NX)
                      for a in range(NX) for b in range(NU)]
    else:
        out["fxx"] = out["fuu"] = out["fxu"] = []
    return _packed(problem, x, u, p, k, out)


def final_derivative_components(problem: Problem, xF, p, N: int, mu_fe,
                                mu_fi, wpf):
    """``Fx (n_x, B)`` and full ``Fxx (n_x*n_x, B)`` of the AL-augmented
    final cost at ``xF (n_x, B)``."""
    NX = problem.n_x

    def F_fn(xx):
        c = problem.F(xx, p, N)
        for i, fn in enumerate(problem.hfe):
            c = c + _eq_penalty(mu_fe[i], fn(xx, p, N), wpf)
        for i, fn in enumerate(problem.hfi):
            c = c + _ineq_penalty(mu_fi[i], fn(xx, p, N), wpf)
        return c

    with torch.enable_grad():
        xx = xF.detach().requires_grad_(True)
        (gx,) = _lane_grads(F_fn(xx), (xx,), True)
        Fx = list(gx)
        Fxx = [_lane_grads(Fx[a], (xx,), False)[0] for a in range(NX)]
    # one value per unordered pair, mirrored (the row of the lower index)
    full = [Fxx[min(a, b)][max(a, b)] for a in range(NX) for b in range(NX)]
    return torch.stack(Fx).detach(), torch.stack(full).detach()


_FINITE_KEYS = ("fx", "fu", "cx", "cu", "cxx", "cuu", "cxu", "fxx", "fuu",
                "fxu")


def batched_calc_derivs_cm(problem: Problem, xs, us, params, mu_le, mu_li,
                           mu_fe, mu_fi, w_pen_l, w_pen_f, full_ddp: bool,
                           shared: bool = False):
    """Batched ``calc_derivs`` with packed component-major output.

    ``xs (B, N+1, n_x)``, ``us (B, N, n_u)``, ``mu_le (B, N, n_hle)``,
    ``mu_fe (B, n_hfe)``, ``w_pen_* (B,)``; ``params`` shared, or per lane
    as :class:`~..problem.LaneParams`.  Returns
    ``(sd_cm, final_cx (n_x, B), final_cxx (n_x*n_x, B), ok (B,))`` -- the
    contract of JAX's ``batched_calc_derivs_cm``; ``shared`` is its
    ``shared_primal`` (the single-trace emitter)."""
    B, Np1, _ = xs.shape
    N = Np1 - 1
    to_cm = lambda a: a.permute(2, 1, 0).contiguous()  # (B,N,c) -> (c,N,B)
    k = step_index(params, N, xs.device)
    step = (step_derivative_components_shared if shared
            else step_derivative_components)
    sd_cm = step(
        problem, to_cm(xs[:, :N]), to_cm(us), params, k, to_cm(mu_le),
        to_cm(mu_li), w_pen_l, full_ddp)
    final_cx, final_cxx = final_derivative_components(
        problem, xs[:, N].T.contiguous(), params, N, mu_fe.T, mu_fi.T,
        w_pen_f)
    ok = torch.isfinite(final_cx).all(0) & torch.isfinite(final_cxx).all(0)
    for key in _FINITE_KEYS:
        v = sd_cm[key]
        if v.shape[0]:
            ok = ok & torch.isfinite(v).all(0).all(0)
    return sd_cm, final_cx, final_cxx, ok


def cm_emit(problem: Problem, xs, us, mu_le, mu_li, mu_fe, mu_fi, w_pen_l,
            w_pen_f, params, full_ddp: bool, shared: bool = False):
    """Emit the packed CM bundle.  Returns ``(sd_cm, final_cx, final_cxx,
    us_cm (n_u, N, B), ok (B,))``: the emission half of the backward pass,
    split out so a lambda retry could re-run only the kernel on a frozen
    bundle (``iLQG.c:261-284``).  ``shared``: the single-trace emitter."""
    sd_cm, final_cx, final_cxx, ok = batched_calc_derivs_cm(
        problem, xs, us, params, mu_le, mu_li, mu_fe, mu_fi, w_pen_l,
        w_pen_f, full_ddp, shared)
    us_cm = us.permute(2, 1, 0).contiguous()
    return sd_cm, final_cx, final_cxx, us_cm, ok


def cm_back_pass_from_bundle(sd_cm: dict, final_cx, final_cxx, us_cm, lam,
                             n_x: int, reg_type: int, full_ddp: bool,
                             when: Tensor | None = None) -> BackPassResult:
    """Run the backward pass (kernel B1, or its plain version on the CPU)
    on an emitted bundle; returns the batch-major result.  ``when``: the
    launch-count predicate of :func:`.cuda_backpass.back_pass_cm`."""
    return result_from_cm(*back_pass_cm(
        sd_cm, final_cx, final_cxx, us_cm, lam[None, :], n_x,
        reg_type=reg_type, full_ddp=full_ddp, when=when))
