"""Kernel B2: the line-search rollouts as one hand-written CUDA kernel.

Replaces ``ddp_generator_tpu/ops/pallas_rollout.py:rollout_call`` (the
``pl.pallas_call`` at line 424, body ``_make_rollout_kernel``).  Sources:
``csrc/rollout.cu``, ``csrc/rollout.cuh``, ``csrc/staged.cuh`` and the
problem's CUDA model, e.g. ``csrc/models/car_parking.cuh``.  Two modes:

* ``multi=True``: the cost sweep.  Every (alpha, lane) is rolled over the
  whole horizon; writes ``costs (A, B)`` and ``ok (A, B)``, no
  trajectories;
* ``multi=False``: the selected rollout.  Every lane is rolled with its own
  ``alpha_vec`` entry; writes ``xs (N, n_x, B)``, ``xf (n_x, B)``,
  ``us (N, n_u, B)``, plus ``cost``/``ok (1, B)`` when ``want_cost``.

Each step: ``u = u_nom + alpha*l + L*dx`` (exactly ``u_nom`` when alpha is
0), sequential clamping in constraint order with every limit taken from the
unclamped ``u``, the running cost with AL penalties, the dynamics; ``ok``
needs a finite cost and state at every step while the cost keeps
accumulating.  The final cost is ``F(x_N, p, N)`` plus the ``hfe``/``hfi``
penalties.

The Pallas kernel traced the user's Python functions inside itself; CUDA
cannot, so the kernel runs a CUDA model of ``__device__`` functions: the
hand-written one a problem names (``Problem.cuda_model``), or else the one
generated from its torch functions (:mod:`..codegen`), built at first use.

On the card (H100) neither bytes (~16 operand values a step and lane) nor
operations (~84 a step) bound the kernel: a trajectory is one dependent
chain over the horizon, and its latency times ``N`` is the time at every
width.  So the kernel keeps on that chain only what the next state needs.
A block owns 8 lanes.  A producer warp copies each time tile of the
operands into a shared-memory ring with ``cp.async``, a tile ahead; the
chain warps, one thread per trajectory, run ``dx -> u -> clamp -> f`` on
operands from that ring and leave ``x_k``, ``u_k`` in a second ring; the
cost warps take each finished tile from it, evaluate the running cost and
the finiteness flags one work item per (step, trajectory), add them per
trajectory in step order, and in the selected mode write ``xs``/``us`` to
device memory.  In the sweep a block rolls its 8 lanes under up to 8
alphas, all reading one copy of the lane's tile.  Every floating-point
expression is the one-thread reference's (``rollout.cuh: rollout_lane``),
in its order; ``tests/test_torch_rollout_host.py`` holds the staged
schedule against it on the host, bit for bit.

The plain PyTorch version is :func:`rollout_plain`; :func:`rollout_call`
takes it for CPU tensors only.

Every rollout takes an optional stage flag ``run``, a one-element device
``int32``: 0 makes the kernel return at entry, writing nothing (the plain
version fills its outputs with NaN instead).  The staged line search
decides its stages with such flags on the device, so a body call holds no
host read and can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any

import torch

from .. import _build, codegen, launches
from ..al import _eq_penalty, _ineq_penalty
from ..problem import Problem
from .forward import Rollout
from .linesearch import LineSearchResult, first_accept

Tensor = torch.Tensor

# ``ddp_rollout``'s block-size argument: checked, otherwise unused (the
# block's shape follows from the tile constants in ``csrc/rollout.cuh``).
BLOCK = 64


def _alpha_tensor(alphas, like: Tensor) -> Tensor:
    """The alpha schedule ``(A,)`` in ``like``'s dtype and device: as given
    when it is a tensor (the solver builds it once, outside any capture;
    a copy from host memory cannot be captured), else made here."""
    if isinstance(alphas, Tensor):
        return alphas
    return torch.tensor(alphas, dtype=like.dtype, device=like.device)


def rollout_plain(problem: Problem, alphas, xnom_cm, unom_cm, l_cm, L_cm,
                  mu_le_cm, mu_li_cm, x0_cm, w_pen_l, w_pen_f, mu_fe_cm,
                  mu_fi_cm, alpha_vec, params: Any, multi: bool,
                  want_cost: bool = False, run: Tensor | None = None):
    """Plain PyTorch version of kernel B2 on the same operands: a Python
    loop over time on ``(comp, A, B)`` (multi) or ``(comp, B)`` lanes.
    With a stage flag ``run`` of 0 every output is NaN (``ok`` False), the
    stand-in for the kernel's unwritten outputs; the flag is never read on
    the host."""
    out = _rollout_plain(problem, alphas, xnom_cm, unom_cm, l_cm, L_cm,
                         mu_le_cm, mu_li_cm, x0_cm, w_pen_l, w_pen_f,
                         mu_fe_cm, mu_fi_cm, alpha_vec, params, multi,
                         want_cost)
    if run is None:
        return out
    keep = run.reshape(()) != 0
    return tuple(torch.where(keep, t, False if t.dtype == torch.bool
                             else float("nan")) for t in out)


def _rollout_plain(problem, alphas, xnom_cm, unom_cm, l_cm, L_cm, mu_le_cm,
                   mu_li_cm, x0_cm, w_pen_l, w_pen_f, mu_fe_cm, mu_fi_cm,
                   alpha_vec, params, multi, want_cost):
    N, n_x, B = xnom_cm.shape
    n_u = unom_cm.shape[1]
    p = params
    if multi:
        alpha = _alpha_tensor(alphas, xnom_cm)[:, None]  # (A, 1)
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


def rollout_call(problem: Problem, alphas, xnom_cm, unom_cm, l_cm, L_cm,
                 mu_le_cm, mu_li_cm, x0_cm, w_pen_l, w_pen_f, mu_fe_cm,
                 mu_fi_cm, alpha_vec, params: Any, multi: bool,
                 want_cost: bool = False, run: Tensor | None = None):
    """One rollout (cost sweep or selected rollout).

    ``alphas`` is the schedule, a sequence of floats or an ``(A,)`` tensor
    of the operands' dtype and device.  ``run``: the stage flag, ``None``
    or a one-element ``int32`` tensor on the operands' device; where it is
    0 the kernel writes nothing and the outputs hold whatever
    ``torch.empty`` gave them.

    Operands in ``(N, C, B)``/``(C, B)`` layout: ``xnom_cm (N, n_x, B)``,
    ``unom_cm (N, n_u, B)``, ``l_cm (N, n_u, B)``, ``L_cm (N, n_u*n_x, B)``,
    ``mu_le_cm (N, n_hle, B)``, ``x0_cm (n_x, B)``, ``w_pen_* (1, B)``,
    ``mu_fe_cm (n_hfe, B)``, ``alpha_vec (1, B)`` (selected mode only);
    ``params`` a dict of tensors.

    Returns ``(costs (A, B), ok (A, B) bool)`` when ``multi``, else
    ``(xs (N, n_x, B), xf (n_x, B), us (N, n_u, B))`` plus
    ``(cost (1, B), ok (1, B) bool)`` when ``want_cost``.

    CPU tensors run :func:`rollout_plain`; CUDA tensors launch kernel B2 and
    count it (:func:`..launches.count`: on the host, or on the device, the
    flag's value, with ``run`` or inside a capture)."""
    dev = xnom_cm.device
    if dev.type == "cpu":
        return rollout_plain(problem, alphas, xnom_cm, unom_cm, l_cm, L_cm,
                             mu_le_cm, mu_li_cm, x0_cm, w_pen_l, w_pen_f,
                             mu_fe_cm, mu_fi_cm, alpha_vec, params, multi,
                             want_cost, run)
    if dev.type != "cuda":
        raise ValueError(f"rollout_call: unsupported device {dev}")
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
        alpha_t = _alpha_tensor(alphas, xnom_cm)
        checks.append(("alphas", alpha_t, (A,)))
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
    if run is not None and (run.numel() != 1 or run.dtype != torch.int32
                            or run.device != dev):
        raise TypeError(f"run: {run.numel()} {run.dtype} on {run.device}, "
                        f"want one int32 on {dev}")
    model, lib = codegen.kernel_model(problem, params)
    p_flat = model.flat_params(params, dtype, dev, N)

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
    ptrs = _build.pointer_array([
        xnom_cm, unom_cm, l_cm, L_cm, opt_t(mu_le_cm, problem.n_hle),
        opt_t(mu_li_cm, problem.n_hli), x0_cm, w_pen_l, w_pen_f,
        opt_t(mu_fe_cm, problem.n_hfe), opt_t(mu_fi_cm, problem.n_hfi),
        alpha_t, p_flat, cost, ok, xs, xf, us, run,
    ])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ddp_rollout(
            0 if dtype == torch.float32 else 1, model.name.encode(),
            int(multi), int(want_cost), N, B, A, BLOCK, ptrs, stream)
    _build.check(lib, rc, "rollout")
    launches.count("rollout_multi" if multi else "rollout_selected", dev,
                   run)
    if multi:
        return cost, ok
    if want_cost:
        return xs, xf, us, cost, ok
    return xs, xf, us


def kernel_info(model: str, dtype: torch.dtype, multi: bool,
                want_cost: bool = False) -> dict:
    """Tile shape and resources of one instantiation of kernel B2, as
    :func:`.cuda_backpass.kernel_info`: lanes per block ``G``, steps per
    tile ``S``, warps of a block ``W`` (chain, producer and cost warps
    together), dynamic shared memory per block, registers and local memory
    per thread; ``model`` a CUDA model name (hand-written or generated).
    Builds the library; needs a CUDA device."""
    lib = codegen.library_of(model)
    out = (ctypes.c_int * 6)()
    rc = lib.ddp_rollout_info(0 if dtype == torch.float32 else 1,
                              model.encode(), int(multi), int(want_cost), out)
    _build.check(lib, rc, "rollout info")
    return _build.info_dict(out)


def _to_cm(a: Tensor) -> Tensor:
    """``(B, N, d...) -> (N, prod(d), B)``, contiguous."""
    B, N = a.shape[:2]
    return a.reshape(B, N, math.prod(a.shape[2:])).permute(1, 2, 0).contiguous()


class _LSCtx:
    """Component-major operands shared by the line-search rollouts."""

    def __init__(self, problem, x0, xs_nom, us_nom, l, L_gain, dV, cost,
                 mu_le, mu_li, mu_fe, mu_fi, w_pen_l, w_pen_f, alphas=None):
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
        self.alphas = (None if alphas is None  # (A,)
                       else _alpha_tensor(alphas, us_nom))

    def call(self, problem, params, alpha_vec, multi, want_cost=False,
             run=None):
        return rollout_call(
            problem, self.alphas, self.xnom_cm, self.unom_cm, self.l_cm,
            self.L_cm, self.mu_le_cm, self.mu_li_cm, self.x0_cm, self.wpl,
            self.wpf, self.mu_fe_cm, self.mu_fi_cm, alpha_vec, params,
            multi=multi, want_cost=want_cost, run=run)

    def select_first_accept(self, costs, ok, z_min: float):
        """First accepted alpha per lane (``line_search.c:41-54``).
        Returns ``(idx, any_ok, dcost, expected, z, take)``, ``take(m)``
        the entry of an ``(A, B)`` plane at each lane's ``idx``."""
        al = self.alphas[:, None]
        idx, any_ok, dcost, expected, z = first_accept(
            al, costs, ok, self.cost, self.dV, z_min)
        take = lambda m: m.gather(0, idx[None, :])[0]
        return idx, any_ok, dcost, expected, z, take


def _traj_out(xs_cm, xf_cm, us_cm):
    xs_full = torch.cat([xs_cm, xf_cm[None]], 0)  # (N+1, n_x, B)
    return xs_full.permute(2, 0, 1), us_cm.permute(2, 0, 1)


def initial_rollout(problem, x0, u0, params, mult, w_pen_l,
                    w_pen_f) -> Rollout:
    """The solver's initial open-loop rollout (``iLQG_mex.c:113-116``) as
    one selected rollout with cost at alpha 0: :func:`.forward.forward_pass`
    at alpha 0, in one launch of kernel B2 on a CUDA device (its plain
    version on the CPU, where the result is ``forward_pass``'s bit for
    bit).  ``x0 (B, n_x)``, ``u0 (B, N, n_u)``, ``mult`` the
    :class:`~..al.Multipliers`, ``w_pen_* (B,)``.  At alpha 0 the kernel
    reads ``x_nom``, ``l`` and ``L`` but uses none of them: they are views
    of one zero buffer.  Counted as ``init_rollout`` (:mod:`..launches`)
    beside the launch's own ``rollout_selected``."""
    B, N, n_u = u0.shape
    n_x = x0.shape[1]
    dev = u0.device
    zero = torch.zeros(N * n_u * n_x * B, dtype=u0.dtype, device=dev)
    L_cm = zero.view(N, n_u * n_x, B)
    xnom_cm = zero[:N * n_x * B].view(N, n_x, B)
    l_cm = zero[:N * n_u * B].view(N, n_u, B)
    xs_cm, xf_cm, us_cm, cost, ok = rollout_call(
        problem, (0.0,), xnom_cm, _to_cm(u0), l_cm, L_cm,
        _to_cm(mult.mu_le), _to_cm(mult.mu_li), x0.T.contiguous(),
        w_pen_l[None, :].contiguous(), w_pen_f[None, :].contiguous(),
        mult.mu_fe.T.contiguous(), mult.mu_fi.T.contiguous(),
        zero[:B].view(1, B), params, multi=False, want_cost=True)
    if dev.type == "cuda":
        launches.count("init_rollout", dev)
    xs, us = _traj_out(xs_cm, xf_cm, us_cm)
    return Rollout(xs=xs, us=us, cost=cost[0], ok=ok[0])


def _flag(pred: Tensor) -> Tensor:
    """A device predicate as B2's stage flag: one ``int32``."""
    return pred.to(torch.int32).reshape(1)


def kernel_line_search(problem, alphas, x0, xs_nom, us_nom, l, L_gain, dV,
                       cost, z_min, params, mu_le, mu_li, mu_fe, mu_fi,
                       w_pen_l, w_pen_f) -> LineSearchResult:
    """Batched line search on the two rollout modes (port of JAX's
    ``pallas_line_search``): full sweep, first-accept selection, selected
    rollout.  Batch-major operands (``x0 (B, n_x)``, ``xs_nom (B, N+1,
    n_x)``, ``L_gain (B, N, n_u, n_x)``, ``dV (B, 2)``, ``cost (B,)``);
    ``alphas`` a sequence of floats or the ``(A,)`` tensor."""
    A = len(alphas)
    ctx = _LSCtx(problem, x0, xs_nom, us_nom, l, L_gain, dV, cost,
                 mu_le, mu_li, mu_fe, mu_fi, w_pen_l, w_pen_f, alphas)
    costs, okf = ctx.call(problem, params, None, multi=True)
    idx, any_ok, dcost, expected, z, take = ctx.select_first_accept(
        costs, okf, z_min)
    alpha_vec = take(ctx.alphas[:, None].expand(A, ctx.B))
    xs_cm, xf_cm, us_cm = ctx.call(problem, params,
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
    selected rollout only when some live lane accepted an alpha past
    alpha[0] (else stage 1's trajectory is the selected one: same kernel,
    same alpha).  With no live lane at all, no rollout runs.  Each
    ``lax.cond`` of the JAX version is a device predicate: the stage flag
    that kernel B2 reads at entry (a stage not needed launches and returns
    at once) and the ``torch.where`` that selects its result, so the call
    reads nothing on the host.  Per live lane the result equals
    :func:`kernel_line_search`'s.  ``alphas`` as there; its floats are read
    only when it is a sequence."""
    A = len(alphas)
    ctx = _LSCtx(problem, x0, xs_nom, us_nom, l, L_gain, dV, cost,
                 mu_le, mu_li, mu_fe, mu_fi, w_pen_l, w_pen_f, alphas)
    B = ctx.B
    any_alive = alive.any()

    # stage 1: alpha[0] alone, trajectory and cost
    a0 = ctx.alphas[0]
    alpha0_vec = a0.expand(1, B).contiguous()
    xs0, xf0, us0, cost0, ok0 = ctx.call(problem, params, alpha0_vec,
                                         multi=False, want_cost=True,
                                         run=_flag(any_alive))
    cost0, ok0 = cost0[0], ok0[0]
    dcost0 = ctx.cost - cost0
    expected0 = -a0 * (ctx.dV[:, 0] + a0 * ctx.dV[:, 1])
    pos0 = expected0 > 0.0
    z0 = torch.where(pos0, dcost0 / torch.where(pos0, expected0, 1.0), 0.0)
    acc0 = ok0 & (z0 > z_min)

    # stage 2: the sweep, when a live lane rejects alpha[0] (never without
    # a live lane: then acc0 is read from unwritten outputs, but `alive`
    # masks it)
    need_sweep = (alive & ~acc0).any()
    costs, okf = ctx.call(problem, params, None, multi=True,
                          run=_flag(need_sweep))
    idx, any_ok, dcost, expected, z, take = ctx.select_first_accept(
        costs, okf, z_min)
    # stage 3: the selected rollout, when a live lane took an alpha past
    # alpha[0] (any_ok and idx exist only after a sweep)
    need_sel = need_sweep & (alive & any_ok & (idx > 0)).any()
    alpha_vec = take(ctx.alphas[:, None].expand(A, B))
    sel = ctx.call(problem, params, alpha_vec[None, :].contiguous(),
                   multi=False, run=_flag(need_sel))

    def pick(swept, staged, dead):
        """The branch the stages took: the sweep's result, stage 1's, or
        the nominal one of a search without a live lane."""
        out = torch.where(any_alive, staged, dead)
        return torch.where(need_sweep, swept, out)

    traj = [torch.where(need_sel, s_, t0) for s_, t0 in zip(sel,
                                                            (xs0, xf0, us0))]
    xs_out, us_out = _traj_out(*traj)
    no = torch.zeros_like(acc0)
    zero = torch.zeros_like(cost0)
    return LineSearchResult(
        success=pick(any_ok, acc0, no),
        xs=torch.where(any_alive, xs_out, ctx.xs_nom),
        us=torch.where(any_alive, us_out, ctx.us_nom),
        new_cost=pick(take(costs), cost0, ctx.cost),
        dcost=pick(take(dcost), dcost0, zero),
        expected=pick(take(expected), expected0, zero),
        z=pick(take(z), z0, zero),
        alpha_index=pick(torch.where(any_ok, idx, A),
                         torch.where(acc0, 0, A),
                         torch.full_like(idx, A)).to(torch.int32))
