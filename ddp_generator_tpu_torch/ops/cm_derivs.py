"""Component-major derivative bundle emission (``ddp_generator_tpu.ops.cm_derivs``).

The batched solve feeds the backward-pass kernel a packed, component-OUTER
bundle: every per-step quantity is a ``(C, N, B)`` array with the batch
contiguous, so thread ``b`` of the kernel reads ``comp*N*B + t*B + b`` and
neighbouring threads read neighbouring addresses.  Symmetric components
(``cxx``, ``cuu`` and the last two axes of ``fxx``/``fuu``) are packed as
row-major upper triangles: 159 components per step for CarParking with
FULL_DDP, which the kernel reads beside the 2 of ``us``.

The derivatives come from ``torch.autograd`` on the whole ``(comp, N, B)``
plane at once: the user functions are component-first and act on each
lane separately (see ``problem.py``), so the gradient of a lane-sum is
every lane's own gradient.  First-order columns are reverse mode;
second-order columns are forward-over-reverse, JAX's own mode
(``jacfwd(grad(...))``): the lane axis is replicated once per direction
(``n_x + n_u`` copies, :func:`_replicate`), copy ``b`` carries the tangent
of direction ``b`` (a ``forward_ad`` dual), and ONE reverse pass through
the primal graph gives every column of the first order (the primal of
copy 0) and of the second (the tangent of copy ``b`` is ``d col / d
dir_b``).  No accumulation order then depends on autograd's sequence
numbers across passes: reverse-over-reverse differentiated the first
backward's nodes, which on CUDA are numbered by the autograd device
thread's counter while the forward's are numbered by the main thread's,
so the order in which the second pass summed its gradients (and their
rounding) moved with what each thread had done before in the process.
This ports ``ddp_generator_tpu.ops.pallas_fused.step_derivative_components``
and ``final_derivative_components`` (plain XLA math in the JAX package
too).  This is torch code, not a hand kernel.  Unlike the JAX version
there is no 128-lane padding.

``derivs_emitter="shared"`` takes :func:`step_derivative_components_shared`
instead (JAX's ``step_derivative_components_shared``): one primal trace of
``(f, L)`` and every column in one batched reverse call.  Both emitters
give the same bundle to rounding; which is faster is a question of
scheduling (PERF.md records the launches of each).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.autograd.forward_ad as fwAD

from ..al import _eq_penalty, _ineq_penalty
from ..problem import LaneParams, Problem, step_index
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


def _replicate(t: Tensor, D: int) -> Tensor:
    """``(..., B) -> (..., D*B)``: ``D`` copies of the lane axis, copy-major
    (copy ``d`` is lanes ``[d*B, (d+1)*B)``)."""
    return t.repeat((1,) * (t.dim() - 1) + (D,))


def _replicate_params(p, B: int, D: int, device):
    """Per-lane params follow their lanes into the copies; shared ones
    broadcast as they are."""
    if isinstance(p, LaneParams):
        return p.take(torch.arange(B, device=device).repeat(D))
    return p


def _tangents(like: Tensor, offset: int, D: int) -> Tensor:
    """The tangent of ``like (n, *mid, B)`` replicated ``D`` times: 1 in
    component ``a`` of copy ``offset + a``, else 0."""
    n, B = like.shape[0], like.shape[-1]
    mid = tuple(like.shape[1:-1])
    eye = torch.eye(D, dtype=like.dtype, device=like.device)[offset:offset + n]
    eye = eye.reshape((n,) + (1,) * len(mid) + (D, 1))
    return eye.expand((n,) + mid + (D, B)).reshape((n,) + mid + (D * B,))


def _split(g: Tensor, B: int, D: int):
    """A dual gradient ``(n, *mid, D*B)`` -> ``(first, second)``: the
    primal of copy 0 ``(n, *mid, B)`` and the tangents ``(n, *mid, D, B)``
    (zeros where the gradient carries none)."""
    primal, tangent = fwAD.unpack_dual(g)
    shape = tuple(g.shape[:-1]) + (D, B)
    second = (torch.zeros(shape, dtype=g.dtype, device=g.device)
              if tangent is None else tangent.reshape(shape))
    return primal[..., :B], second


def _second_order(fn, inputs, lane_args, p):
    """First- and second-order columns of every output of ``fn`` by
    forward-over-reverse on lane-replicated inputs.

    ``fn(*inputs, *lane_args, p)`` returns a list of lane planes;
    ``inputs`` are the differentiated component-first tensors
    ``(n_i, *mid, B)`` whose components, in order, are the directions;
    ``lane_args`` other lane tensors (last axis ``B``).  Returns ``(J, H)``
    with ``J[r][a]`` = ``d y_r / d dir_a`` and ``H[r][a][b]`` = ``d J[r][a]
    / d dir_b``, planes of ``(*mid, B)``."""
    B = inputs[0].shape[-1]
    D = sum(t.shape[0] for t in inputs)
    offsets = [sum(t.shape[0] for t in inputs[:i]) for i in range(len(inputs))]
    args = [_replicate(a, D) for a in lane_args]
    pr = _replicate_params(p, B, D, inputs[0].device)
    J, H = [], []
    with fwAD.dual_level(), torch.enable_grad():
        leaves = [_replicate(t.detach(), D).requires_grad_(True)
                  for t in inputs]
        duals = [fwAD.make_dual(leaf, _tangents(t, off, D))
                 for leaf, t, off in zip(leaves, inputs, offsets)]
        for y in fn(*duals, *args, pr):
            cols, secs = [], []
            for g in _lane_grads(y, leaves, create_graph=False):
                first, second = _split(g, B, D)
                cols += list(first)
                secs += [list(s.unbind(-2)) for s in second]
            J.append(cols)
            H.append(secs)
    return J, H


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

    def L_fn(xx, uu, mle, mli, w, pp):
        c = problem.L(xx, uu, pp, k)
        for i, fn in enumerate(problem.hle):
            c = c + _eq_penalty(mle[i], fn(xx, uu, pp, k), w)
        for i, fn in enumerate(problem.hli):
            c = c + _ineq_penalty(mli[i], fn(xx, uu, pp, k), w)
        return [c]

    out = {}
    # dynamics: F1[i][j] = d f_i / d dir_j; F2[i][a][b] = d2 f_i / da db
    if full_ddp:
        F1, F2 = _second_order(
            lambda xx, uu, pp: list(problem.f(xx, uu, pp, k)), (x, u), (), p)
    else:
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            uu = u.detach().requires_grad_(True)
            fv = problem.f(xx, uu, p, k)
            F1 = [_columns(fv[i], xx, uu, False) for i in range(NX)]
    # cost: C1[a] = dL/da, C2[a][b] = d2L/da db
    (C1,), (C2,) = _second_order(L_fn, (x, u), (mu_le, mu_li, wpl), p)
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

    The outputs ``Y = [f_0 .. f_{n_x-1}, L]`` are traced once on the
    lane-replicated duals; one batched vector-Jacobian product
    (``is_grads_batched``, a one-hot cotangent per output) gives every
    first-order column ``J[r][a] = dY_r / d dir_a`` as its primal and
    ``d J[r][a] / d dir_b`` as its tangent: one reverse call where the
    per-family emitter makes ``n_x + 1`` (one per output).  Same contract;
    values agree to rounding (the association may differ where a vmapped
    backward sums in another order)."""
    NX, NU = problem.n_x, problem.n_u
    D, R = NX + NU, NX + 1
    N, B = x.shape[1], x.shape[2]
    W = D * B  # lanes of the replicated plane
    eye = torch.eye(R, dtype=x.dtype, device=x.device)
    onehot = eye[:, :, None, None].expand(R, R, N, W)  # stride 0 over (N, W)
    args = [_replicate(a, D) for a in (mu_le, mu_li, wpl)]
    pr = _replicate_params(p, B, D, x.device)
    with fwAD.dual_level(), torch.enable_grad():
        xx = _replicate(x.detach(), D).requires_grad_(True)
        uu = _replicate(u.detach(), D).requires_grad_(True)
        xd = fwAD.make_dual(xx, _tangents(x, 0, D))
        ud = fwAD.make_dual(uu, _tangents(u, NX, D))
        mle, mli, w = args
        c = problem.L(xd, ud, pr, k)
        for i, fn in enumerate(problem.hle):
            c = c + _eq_penalty(mle[i], fn(xd, ud, pr, k), w)
        for i, fn in enumerate(problem.hli):
            c = c + _ineq_penalty(mli[i], fn(xd, ud, pr, k), w)
        Y = torch.cat([problem.f(xd, ud, pr, k), c.expand(N, W)[None]])
        gs = torch.autograd.grad(Y, (xx, uu), onehot, allow_unused=True,
                                 is_grads_batched=True)
        parts = [_split(torch.zeros((R,) + t.shape, dtype=x.dtype,
                                    device=x.device) if g is None else g,
                        B, D) for g, t in zip(gs, (xx, uu))]
    J = torch.cat([parts[0][0], parts[1][0]], 1)  # (R, D, N, B)
    H = torch.cat([parts[0][1], parts[1][1]], 1)  # (R, D, N, D, B)
    H = H.movedim(3, 2)  # H[r, a, b] = d J[r, a] / d dir_b
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

    def F_fn(xx, mfe, mfi, w, pp):
        c = problem.F(xx, pp, N)
        for i, fn in enumerate(problem.hfe):
            c = c + _eq_penalty(mfe[i], fn(xx, pp, N), w)
        for i, fn in enumerate(problem.hfi):
            c = c + _ineq_penalty(mfi[i], fn(xx, pp, N), w)
        return c

    (Fx,), (Fxx,) = _second_order(
        lambda xx, mfe, mfi, w, pp: [F_fn(xx, mfe, mfi, w, pp)], (xF,),
        (mu_fe, mu_fi, wpf), p)
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
