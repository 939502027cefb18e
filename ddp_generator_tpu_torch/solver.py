"""The outer iLQG loop (``ddp_generator_tpu.solver``), batched, in PyTorch.

One body call is one masked outer iteration of every lane of the batch
(``iLQG.c:239-361``): the derivatives and the backward pass -- with
``backpass_method="serial"`` the step-major bundle (``derivs.py``) and the
reverse loop of ``ops/backpass.py``, with ``"kernel"`` derivative emission
into the packed component-major bundle (on a card the emission kernel,
``ops/cuda_emit.py``; on the CPU ``ops/cm_derivs.py``) then kernel B1,
with ``"fused"`` kernel B3, which computes the derivatives inside the
backward pass (``ops/cuda_fused.py``) -- the lambda retries
(``lam_retry``), the gradient-tolerance exit, the line search (serial,
``ops/linesearch.py``, or kernel B2), then the accept/reject updates.
``backpass_method="parallel"`` takes the step-major bundle through the
associative-scan pass of ``ops/parallel_riccati.py`` (unconstrained
problems, ``full_ddp=False``).  The JAX package writes one lane and
``vmap``s it, with ``custom_vmap`` rules that hand the batch
to its kernels; here the batch dimension is written out, every masked
update is a ``torch.where`` per lane, and a lane whose loop condition is
false keeps its carry.

Two loops share the body: :func:`make_batched_solver` loops until no lane
is active, and on a CUDA device runs the whole solve as one CUDA graph
whose loop is a WHILE node (``ops/device_loop.py``, the counterpart of
JAX's ``lax.while_loop``), so the host reads the device once a solve;
:class:`StepwiseSolver` runs chunks of iterations with active-lane
compaction, and on a CUDA device replays each body call as one CUDA graph
per working width (:func:`_graphable`: every route but ``debug_level >=
3``).  The loops inside a body call -- the inline lambda retries, boxQP's
Newton iteration and its Armijo backtracking -- are device loops too.
Per-lane results are identical between them, with compaction on or off,
graphed or eager (:func:`.ops.device_loop.eager_loops`).

``batch_params=True`` gives every lane its own params (the JAX convention:
each leaf ``(B, *leaf_shape)``), cast once to lanes-last
:class:`~.problem.LaneParams`.  The emission kernel and kernel B2 read them
as a lane-major matrix (:attr:`~.problem.LaneParams.rows`, made once a
solve on a card and gathered with each compaction), so ``"kernel"`` keeps
emission, B1 and B2 (line search and initial rollout), as with shared
params.  B3 reads one shared param vector: ``"fused"`` takes the serial
derivatives, backward pass and line search, as the JAX package does.
"""

from __future__ import annotations

import functools
import sys
import time
from collections import deque
from typing import Any, NamedTuple

import numpy as np
import torch

from . import _build, codegen, launches
from . import solution as sol
from .al import Multipliers, init_multipliers, update_multipliers
from .convert import to_torch
from .derivs import batched_calc_derivs
from .ops.backpass import back_pass
from .ops.boxqp import BoxQPHyper
from .ops import cuda_backpass, cuda_emit, device_loop
from .ops.cm_derivs import cm_back_pass_from_bundle
from .ops.cuda_fused import fused_derivs_back_pass
from .ops.cuda_rollout import (
    initial_rollout,
    kernel_line_search,
    kernel_line_search_staged,
)
from .ops.forward import cost_only, forward_pass
from .ops.linesearch import line_search
from .ops.parallel_riccati import parallel_back_pass
from .options import SolverOptions
from .problem import Problem, lanes_last
from .solution import Solution
from .utils.tree import tree_map, tree_where

Tensor = torch.Tensor

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class _Carry(NamedTuple):
    """Per-lane loop state, every field with a leading lane axis ``B``
    (see ``ddp_generator_tpu.solver._Carry``)."""

    xs: Tensor  # (B, N+1, n_x); xs[:, 0] is always x0
    us: Tensor
    cost: Tensor
    mult: Multipliers
    lam: Tensor
    dlam: Tensor
    w_pen_l: Tensor
    w_pen_f: Tensor
    # Penalty weights the derivative bundle is evaluated with: frozen at the
    # last accept, so reject/retry calls re-derive the STALE bundle exactly
    # (iLQG.c:241-256 only recomputes when newDeriv).
    w_pen_l_d: Tensor
    w_pen_f_d: Tensor
    new_deriv: Tensor  # bool
    back_pass_done: Tensor  # bool
    it: Tensor  # int32
    done: Tensor  # bool
    status: Tensor  # int32
    g_norm: Tensor
    dcost: Tensor
    expected: Tensor
    z: Tensor
    log_linesearch: Tensor
    log_z: Tensor
    log_cost: Tensor
    body_calls: Tensor  # int32
    stale_calls: Tensor  # int32
    bp_retry_calls: Tensor  # int32
    was_bp_retry: Tensor  # bool: previous call ended in a lambda retry


def _check_supported(problem: Problem, o: SolverOptions) -> None:
    """Raise for options that validate but that this problem cannot run
    (the JAX package's guards, ``jax:solver.py:395-409``)."""
    if o.backpass_method == "parallel":
        if problem.n_h > 0:
            raise ValueError(
                "backpass_method='parallel' requires an unconstrained "
                "problem (no h constraints): boxQP clamping is a per-step "
                "nonlinearity that breaks the associative-scan formulation")
        if o.full_ddp:
            raise ValueError(
                "backpass_method='parallel' requires full_ddp=False (the "
                "FULL_DDP tensor terms couple the stage cost to the "
                "downstream Vx)")
    if o.dtype not in _DTYPES:
        raise ValueError(f"dtype must be float32|float64, got {o.dtype!r}")
    if o.backpass_method in ("kernel", "fused") and problem.n_u > 3:
        raise ValueError(f"backpass_method={o.backpass_method!r} supports "
                         "n_u <= 3")


def _graphable(problem: Problem, o: SolverOptions) -> bool:
    """Does a body call of these options read nothing on the host, so that
    :class:`StepwiseSolver` can replay it as a CUDA graph?  Every backward
    pass and line search qualifies, with shared or per-lane params, boxQP's
    enumeration or its projected-Newton iteration, deferred or inline
    lambda retries: the loops inside a body call (Newton and its Armijo
    backtracking, the inline retries) are device loops
    (:func:`.ops.device_loop.while_loop`).  Only ``debug_level >= 3``
    reads the host: it prints every iteration from there."""
    return o.debug_level < 3


def _line_search_of(o: SolverOptions, batch_params: bool) -> str:
    """The line search a solve runs: the options', but per-lane params on
    the fused path, which fall back to the serial derivatives and backward
    pass (B3 reads one shared param vector), take the serial one too
    (jax:solver.py:458-462)."""
    if batch_params and o.backpass_method == "fused":
        return "serial"
    return o.linesearch_method


def _check_kernels(device, o: SolverOptions, batch_params: bool) -> None:
    """``require_kernels``: on a CUDA device, raise where a torch route
    would run in place of a kernel the options name.  Today that is
    per-lane params on the fused path (see :func:`_line_search_of`)."""
    if (torch.device(device).type == "cuda" and batch_params
            and o.backpass_method == "fused"):
        raise NotImplementedError(
            "require_kernels: per-lane params on the fused path run the "
            "serial derivatives, backward pass and line search (B3 reads "
            "one shared param vector)")


def _init_on_b2(device, o: SolverOptions, batch_params: bool) -> bool:
    """Does ``init_fn`` roll the initial trajectory on kernel B2
    (:func:`.ops.cuda_rollout.initial_rollout`)?  Where B2 rolls the line
    search: a CUDA device and the kernel line search, shared or per-lane
    params, so that a solve builds every trajectory it holds with one piece
    of code.  Elsewhere :func:`.ops.forward.forward_pass`."""
    return (torch.device(device).type == "cuda"
            and _line_search_of(o, batch_params) == "kernel")


def _boxqp_hyper(o: SolverOptions) -> BoxQPHyper:
    # "auto" resolves the boxQP tolerances per dtype as the JAX package
    # does: the reference values (boxQP.c:52-57) are calibrated for double
    # precision; in float32 a QP warm-started at its optimum cannot drive
    # its gradient below ~eps*|g| ~ 1e-8.  Explicit floats are used as given.
    f32 = o.dtype == "float32"
    min_grad = o.boxqp_min_grad
    if min_grad == "auto":
        min_grad = 1e-5 if f32 else 1e-8
    min_rel_improve = o.boxqp_min_rel_improve
    if min_rel_improve == "auto":
        min_rel_improve = 1e-6 if f32 else 1e-8
    return BoxQPHyper(
        max_iter=o.boxqp_max_iter, min_grad=min_grad,
        min_rel_improve=min_rel_improve, step_dec=o.boxqp_step_dec,
        min_step=o.boxqp_min_step, armijo=o.boxqp_armijo,
        method=o.boxqp_method, use_mod_chol=o.use_mod_chol)


class _Retry(NamedTuple):
    """The inline lambda retries' per-lane state."""

    bp: Any  # BackPassResult: the last attempt's, on the lanes that made one
    lam: Tensor
    dlam: Tensor
    cont: Tensor  # bool: failed, and lambda may still rise
    n: Tensor  # int32: attempts made


def _lam_retry_loop(bp_call, bp0, lam0: Tensor, dlam0: Tensor, can: Tensor,
                    o: SolverOptions):
    """The reference's inner lambda-escalation loop (``iLQG.c:261-284``),
    batched: a failed backward pass escalates lambda and re-runs ONLY the
    backward pass (``bp_call(lam)``, closed over the frozen derivatives).

    A :func:`.ops.device_loop.while_loop` while any lane retries
    (``jax:solver.py:148-183``; a WHILE node in a CUDA graph, reading
    nothing on the host); each retry runs ``bp_call`` on the whole batch
    and keeps its result on the lanes that retried.  Per lane the (lambda,
    attempt) sequence is that of ``lam_retry="deferred"``.  Returns ``(bp,
    lam, dlam, n_attempts)``; a lane that exhausts the schedule keeps
    ``bp.failed`` with lambda past ``lambdaMax``."""
    def body(r: _Retry) -> _Retry:
        dlam_f = torch.clamp(r.dlam * o.lambdaFactor, min=o.lambdaFactor)
        lam_f = torch.clamp(r.lam * dlam_f, min=o.lambdaMin)
        do = r.cont & ~(lam_f > o.lambdaMax)
        bp1 = bp_call(lam_f)
        return _Retry(bp=tree_where(do, bp1, r.bp),
                      lam=torch.where(r.cont, lam_f, r.lam),
                      dlam=torch.where(r.cont, dlam_f, r.dlam),
                      cont=do & bp1.failed, n=r.n + do.to(torch.int32))

    cont = bp0.failed & can
    r = device_loop.while_loop(
        lambda r: r.cont.any(), body,
        _Retry(bp0, lam0, dlam0, cont,
               torch.zeros_like(cont, dtype=torch.int32)))
    return r.bp, r.lam, r.dlam, r.n


def _same_device(t: Tensor, device: torch.device) -> bool:
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index)


def _check_device(tree, device: torch.device, what: str) -> None:
    """Raise if a tensor in ``tree`` lies on another device than the solve's:
    inputs are never moved across devices behind the caller's back."""
    if isinstance(tree, Tensor):
        if not _same_device(tree, device):
            raise ValueError(f"{what} is on {tree.device}, the solver on "
                             f"{device}; move it or pass device={tree.device}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _check_device(v, device, f"{what}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _check_device(v, device, what)


def _make_parts(problem: Problem, options: SolverOptions, device,
                batch_params: bool = False):
    """Build ``(init_fn, body_fn, finalize_fn, cast_params)`` on batched
    carries.

    * ``init_fn(x0s, u0s, params) -> _Carry``: initial open-loop rollout and
      multiplier recording (``iLQG_mex.c:113-116``, ``iLQG.c:237``);
    * ``body_fn(carry, params) -> _Carry``: one outer iteration of every
      lane (the caller keeps the carry of lanes whose loop is over);
    * ``finalize_fn(carry) -> Solution``;
    * ``cast_params(params, B, N)``: the params of ``B`` lanes over ``N``
      steps in the solve's dtype and layout (:class:`~.problem.LaneParams`
      with ``batch_params``; on a card whose kernels read them, with their
      :attr:`~.problem.LaneParams.rows`, which ``init_fn`` and ``body_fn``
      then require).
    """
    o = options
    _check_supported(problem, o)
    dtype = _DTYPES[o.dtype]
    device = torch.device(device)
    alphas = tuple(float(a) for a in o.alpha)
    A = len(alphas)
    # made once here: a copy from host memory inside a body call could not
    # be captured in a CUDA graph
    alphas_t = torch.tensor(alphas, dtype=dtype, device=device)
    lambda_success_thresh = 1e-5  # iLQG.c:297
    n_log = max(o.max_iter, 1)
    has_al = (problem.n_hle + problem.n_hli + problem.n_hfe
              + problem.n_hfi) > 0
    hyper = _boxqp_hyper(o)
    inline = o.lam_retry == "inline"
    # B3 reads one flat shared param vector: per-lane params take the
    # serial methods there (jax:solver.py:366-371, :458-462)
    backpass = ("serial" if batch_params and o.backpass_method == "fused"
                else o.backpass_method)
    linesearch = _line_search_of(o, batch_params)
    init_on_b2 = _init_on_b2(device, o, batch_params)
    # the kernels that read params on a card: the emission kernel, B2, B3
    kernels_read_params = device.type == "cuda" and (
        backpass in ("kernel", "fused") or linesearch == "kernel")
    # the serial and fused paths compute their derivatives themselves, and
    # per-lane params emit per family (JAX: the batch-major fallback)
    shared = o.derivs_emitter == "shared" and not batch_params
    i32 = torch.int32

    def full(B, v, dt=dtype):
        return torch.full((B,), v, dtype=dt, device=device)

    def derivs_back_pass(c: _Carry, w_pen_l_d, w_pen_f_d, params):
        """Derivatives at the nominal trajectory and one backward-pass
        attempt: ``(bp_call, BackPassResult, derivs_ok (B,))``, where
        ``bp_call(lam)`` re-runs only the backward pass on the same
        derivatives (the inline lambda retries)."""
        m = c.mult
        # B1 and B3 count a launch only in a body call where a lane runs
        # (launches.py): a graph replay after the last lane retired
        # counts none
        runs = (_running(c, o.max_iter).any()
                if backpass in ("kernel", "fused") else None)
        if backpass == "fused":
            # B3 re-derives the bundle per attempt (it never exists in
            # memory): a retry re-launches the kernel on unchanged inputs.
            def bp_call(lam):
                return fused_derivs_back_pass(
                    problem, c.xs, c.us, m.mu_le, m.mu_li, m.mu_fe, m.mu_fi,
                    w_pen_l_d, w_pen_f_d, lam, params, o.regType, o.full_ddp,
                    when=runs)
            bp, d_ok = bp_call(c.lam)
            return lambda lam: bp_call(lam)[0], bp, d_ok
        if backpass == "kernel":
            # emission once (the emission kernel on a card); a retry
            # re-runs B1 on the same bundle
            sd_cm, fcx, fcxx, us_cm, d_ok = cuda_emit.emit(
                problem, c.xs, c.us, m.mu_le, m.mu_li, m.mu_fe, m.mu_fi,
                w_pen_l_d, w_pen_f_d, params, o.full_ddp, shared, when=runs)
            launches.stamp("derivs", device)

            def bp_call(lam):
                return cm_back_pass_from_bundle(sd_cm, fcx, fcxx, us_cm, lam,
                                                problem.n_x, o.regType,
                                                o.full_ddp, when=runs)
        else:
            d = batched_calc_derivs(
                problem, c.xs, c.us, params, m.mu_le, m.mu_li, m.mu_fe,
                m.mu_fi, w_pen_l_d, w_pen_f_d, o.full_ddp)
            launches.stamp("derivs", device)
            d_ok = d.ok
            if backpass == "parallel":
                def bp_call(lam):
                    return parallel_back_pass(d, c.us, lam, o.regType, hyper)
            else:
                def bp_call(lam):
                    return back_pass(d, c.us, lam, o.regType, o.full_ddp,
                                     hyper)
        return bp_call, bp_call(c.lam), d_ok

    def need_rows(params) -> None:
        """Per-lane params reach the kernels with the lane-major rows
        ``cast_params`` made: a launch that made them from the leaves would
        add nodes to every graph replay."""
        if (kernels_read_params and batch_params
                and getattr(params, "rows", None) is None):
            raise ValueError("per-lane params without the kernels' rows: "
                             "pass them through cast_params")

    def prepare_kernels(params) -> None:
        """Generate and build the kernels this solve launches on a CUDA
        device before any body call, so before any graph capture (an
        ``nvcc`` run cannot be captured): B1 at the problem's shape, and
        B2, B3 and the emission kernel on its CUDA model, hand-written or
        generated."""
        need_rows(params)
        if device.type != "cuda":
            return
        if backpass == "kernel":
            cuda_backpass.library(problem.n_x, problem.n_u)
        if kernels_read_params:
            codegen.kernel_model(problem, params)

    def init_fn(x0s, u0s, params) -> _Carry:
        _check_device(x0s, device, "x0s")
        _check_device(u0s, device, "u0s")
        launches.stamp("init", device)
        prepare_kernels(params)
        x0 = torch.as_tensor(x0s, device=device).to(dtype)
        u0 = torch.as_tensor(u0s, device=device).to(dtype)
        B, N = u0.shape[0], u0.shape[1]
        mult0 = init_multipliers(problem, B, N, dtype, device)
        w_pen_l0, w_pen_f0 = full(B, o.w_pen_init_l), full(B, o.w_pen_init_f)
        # Initial open-loop rollout (iLQG_mex.c:113-116): alpha=0, u = u0;
        # one launch of B2 where B2 rolls the line search
        if init_on_b2:
            r0 = initial_rollout(problem, x0, u0, params, mult0, w_pen_l0,
                                 w_pen_f0)
        else:
            r0 = forward_pass(
                problem, x0, None, u0, None, None, 0.0, params,
                mult0.mu_le, mult0.mu_li, mult0.mu_fe, mult0.mu_fi,
                w_pen_l0, w_pen_f0)
        mu0 = update_multipliers(
            problem, r0.xs, r0.us, params, mult0, w_pen_l0, w_pen_f0,
            o.w_pen_max_l, o.w_pen_max_f, o.w_pen_fact1, o.tolConstraint,
            init=True)
        init_failed = ~r0.ok
        xs0 = r0.xs.clone()
        xs0[:, 0] = x0  # x0 even when the rollout NaN'd out mid-way
        zeros = full(B, 0.0)
        c = _Carry(
            xs=xs0, us=r0.us, cost=r0.cost, mult=mu0.multipliers,
            lam=full(B, o.lambdaInit), dlam=full(B, o.dlambdaInit),
            w_pen_l=w_pen_l0, w_pen_f=w_pen_f0,
            w_pen_l_d=w_pen_l0, w_pen_f_d=w_pen_f0,
            new_deriv=full(B, True, torch.bool),
            back_pass_done=full(B, False, torch.bool),
            it=full(B, 0, i32), done=init_failed,
            status=torch.where(init_failed, sol.STATUS_INIT_FAILED,
                               sol.STATUS_RUNNING).to(i32),
            g_norm=zeros, dcost=zeros, expected=zeros, z=zeros,
            log_linesearch=torch.zeros((B, n_log), dtype=i32, device=device),
            log_z=torch.zeros((B, n_log), dtype=dtype, device=device),
            log_cost=torch.zeros((B, n_log), dtype=dtype, device=device),
            body_calls=full(B, 0, i32), stale_calls=full(B, 0, i32),
            bp_retry_calls=full(B, 0, i32),
            was_bp_retry=full(B, False, torch.bool),
        )
        launches.stamp("init_end", device)
        return c

    def set_log(log, it, alive, value):
        new = log.clone()
        rows = torch.arange(log.shape[0], device=device)
        new[rows, it.clamp(max=n_log - 1).long()] = value.to(log.dtype)
        return torch.where(alive[:, None], new, log)

    def body_fn(c: _Carry, params) -> _Carry:
        need_rows(params)
        launches.stamp("body", device)
        where = torch.where
        lf = o.lambdaFactor
        status = c.status
        # A done lane passing through a body call is not a processed
        # iteration.
        processed = (~c.done).to(i32)
        body_calls = c.body_calls + processed
        stale_calls = c.stale_calls + processed * (~c.new_deriv).to(i32)

        # ===== STEP 1: derivatives (iLQG.c:241-256) =====
        w_pen_l_d = where(c.new_deriv, c.w_pen_l, c.w_pen_l_d)
        w_pen_f_d = where(c.new_deriv, c.w_pen_f, c.w_pen_f_d)
        # ===== STEP 2: backward pass + lambda escalation (iLQG.c:261-284)
        bp_call, bp, d_ok = derivs_back_pass(c, w_pen_l_d, w_pen_f_d, params)
        derivs_failed = c.new_deriv & ~d_ok
        status = where(derivs_failed, sol.STATUS_DERIVS_FAILED, status)
        alive = ~derivs_failed
        if inline:
            # The reference's inner while around only the backward pass:
            # a lane still failed after it has lambda past lambdaMax.
            live = ~c.done & (c.it < o.max_iter)
            bp, lam, dlam, n_att = _lam_retry_loop(
                bp_call, bp, c.lam, c.dlam, live & ~(c.new_deriv & ~d_ok), o)
            bp_failed = alive & bp.failed
            gave_up = bp_failed & live
            retrying = torch.zeros_like(bp_failed)
            bp_retry_calls = c.bp_retry_calls + n_att
        else:
            # Deferred: a failed pass escalates lambda; the lane retries on
            # the next call WITHOUT advancing `it`.
            dlam_f = torch.clamp(c.dlam * lf, min=lf)
            lam_f = torch.clamp(c.lam * dlam_f, min=o.lambdaMin)
            bp_failed = alive & bp.failed
            gave_up = bp_failed & (lam_f > o.lambdaMax)
            retrying = bp_failed & ~gave_up
            lam = where(bp_failed, lam_f, c.lam)
            dlam = where(bp_failed, dlam_f, c.dlam)
            bp_retry_calls = c.bp_retry_calls + processed * (
                c.was_bp_retry & ~c.new_deriv).to(i32)
        launches.stamp("backpass", device)
        status = where(gave_up, sol.STATUS_NO_DESCENT, status)
        alive = alive & ~bp_failed
        back_pass_done = c.back_pass_done | alive
        g_norm = where(alive, bp.g_norm, c.g_norm)

        # ===== gradient-tolerance exit (iLQG.c:297-303) =====
        grad_exit = alive & (g_norm < o.tolGrad) & (lam < lambda_success_thresh)
        dlam_g = torch.clamp(dlam / lf, max=1.0 / lf)
        lam_g = lam * dlam_g * (lam > o.lambdaMin).to(dtype)
        dlam = where(grad_exit, dlam_g, dlam)
        lam = where(grad_exit, lam_g, lam)
        status = where(grad_exit, sol.STATUS_SUCCESS_GRADIENT, status)
        alive = alive & ~grad_exit

        # ===== STEP 3: line search (iLQG.c:305-309) =====
        ls_alive = alive & ~c.done & (c.it < o.max_iter)
        ls_args = (problem, alphas_t, c.xs[:, 0], c.xs, c.us, bp.l, bp.L,
                   bp.dV, c.cost, o.zMin, params, c.mult.mu_le, c.mult.mu_li,
                   c.mult.mu_fe, c.mult.mu_fi, c.w_pen_l, c.w_pen_f)
        if linesearch == "serial":
            ls = line_search(*ls_args)
        elif o.linesearch_staged:
            ls = kernel_line_search_staged(*ls_args, alive=ls_alive)
        else:
            ls = kernel_line_search(*ls_args)
        launches.stamp("linesearch", device)
        log_linesearch = set_log(c.log_linesearch, c.it, alive,
                                 torch.clamp(ls.alpha_index + 1, max=A))
        log_z = set_log(c.log_z, c.it, alive, ls.z)
        log_cost = set_log(c.log_cost, c.it, alive, ls.new_cost)

        accepted = alive & ls.success
        rejected = alive & ~ls.success

        # ===== STEP 4a: accept (iLQG.c:312-339) =====
        dlam_a = torch.clamp(dlam / lf, max=1.0 / lf)
        lam_a = lam * dlam_a * (lam > o.lambdaMin).to(dtype)
        xs = where(accepted[:, None, None], ls.xs, c.xs)
        us = where(accepted[:, None, None], ls.us, c.us)
        cost = where(accepted, ls.new_cost, c.cost)
        new_deriv = accepted

        tolfun_exit = accepted & (ls.dcost < o.tolFun)
        status = where(tolfun_exit, sol.STATUS_SUCCESS_TOLFUN, status)
        do_mult_update = accepted & ~tolfun_exit

        # With no AL families the multiplier update and the penalty
        # re-rollout are no-ops and statically skipped (iLQG.c:337-348).
        if has_al:
            upd = update_multipliers(
                problem, xs, us, params, c.mult, c.w_pen_l, c.w_pen_f,
                o.w_pen_max_l, o.w_pen_max_f, o.w_pen_fact1,
                o.tolConstraint, init=False)
            mult = tree_where(do_mult_update, upd.multipliers, c.mult)
            w_pen_l = where(do_mult_update, upd.w_pen_l, c.w_pen_l)
            w_pen_f = where(do_mult_update, upd.w_pen_f, c.w_pen_f)
        else:
            mult, w_pen_l, w_pen_f = c.mult, c.w_pen_l, c.w_pen_f

        # ===== STEP 4b: reject (iLQG.c:340-361) =====
        dlam_r = torch.clamp(dlam * lf, min=lf)
        lam_r = torch.clamp(lam * dlam_r, min=o.lambdaMin)
        dlam = where(accepted, dlam_a, where(rejected, dlam_r, dlam))
        lam = where(accepted, lam_a, where(rejected, lam_r, lam))

        if o.w_pen_fact2 > 1.0:
            bump = rejected
            w_pen_l = where(bump, torch.clamp(w_pen_l * o.w_pen_fact2,
                                              max=o.w_pen_max_l), w_pen_l)
            w_pen_f = where(bump, torch.clamp(w_pen_f * o.w_pen_fact2,
                                              max=o.w_pen_max_f), w_pen_f)
            recost = do_mult_update | bump
        else:
            recost = do_mult_update
        if has_al:
            new_cost_eval = cost_only(
                problem, xs, us, params, mult.mu_le, mult.mu_li, mult.mu_fe,
                mult.mu_fi, w_pen_l, w_pen_f)
            cost = where(recost, new_cost_eval, cost)
            launches.count_al_updates(do_mult_update
                                      & _running(c, o.max_iter))
            launches.stamp("al", device)

        lammax_exit = rejected & (lam > o.lambdaMax)
        status = where(lammax_exit, sol.STATUS_EXIT_LAMBDA_MAX, status)
        done = status != sol.STATUS_RUNNING
        halt = done | retrying
        if o.debug_level >= 3:
            _print_iteration(~c.done & (c.it < o.max_iter), c.it + 1,
                             accepted, cost, ls.dcost, g_norm, ls.z, lam,
                             w_pen_l, w_pen_f)
        return _Carry(
            xs=xs, us=us, cost=cost, mult=mult, lam=lam, dlam=dlam,
            w_pen_l=w_pen_l, w_pen_f=w_pen_f, w_pen_l_d=w_pen_l_d,
            w_pen_f_d=w_pen_f_d, new_deriv=new_deriv,
            back_pass_done=back_pass_done,
            # a lambda retry does not consume an iteration (iLQG.c:261)
            it=where(halt, c.it, c.it + 1),
            done=done, status=status, g_norm=g_norm,
            dcost=where(alive, ls.dcost, c.dcost),
            expected=where(alive, ls.expected, c.expected),
            z=where(alive, ls.z, c.z),
            log_linesearch=log_linesearch, log_z=log_z, log_cost=log_cost,
            body_calls=body_calls, stale_calls=stale_calls,
            bp_retry_calls=bp_retry_calls, was_bp_retry=retrying,
        )

    def finalize_fn(final: _Carry) -> Solution:
        max_iter_hit = ((final.status == sol.STATUS_RUNNING)
                        & (final.it >= o.max_iter))
        status = torch.where(max_iter_hit, sol.STATUS_MAX_ITER,
                             final.status).to(i32)
        # Reference success semantics (iLQG.c:367-378).
        success = final.back_pass_done & (final.it < o.max_iter)
        return Solution(
            success=success, xs=final.xs, us=final.us, cost=final.cost,
            iterations=final.it, g_norm=final.g_norm, lam=final.lam,
            dlam=final.dlam, w_pen_l=final.w_pen_l, w_pen_f=final.w_pen_f,
            status=status, dcost=final.dcost, expected=final.expected,
            z=final.z, log_linesearch=final.log_linesearch,
            log_z=final.log_z, log_cost=final.log_cost,
            body_calls=final.body_calls, stale_calls=final.stale_calls,
            bp_retry_calls=final.bp_retry_calls,
        )

    def cast_params(params, B: int, N: int):
        # All floating params in the solve dtype, on the solve device.
        _check_device(params, device, "params")
        p = to_torch(dict(params), dtype, device)
        if not batch_params:
            return p
        p = lanes_last(p, B)
        if kernels_read_params:
            # the kernels' lane-major operand, made once here
            model = codegen.kernel_model(problem, p)[0]
            p.rows = model.flat_params(p, dtype, device, N)
        return p

    return init_fn, body_fn, finalize_fn, cast_params


def _print_iteration(run, it, accepted, cost, dcost, g_norm, z, lam,
                     w_pen_l, w_pen_f) -> None:
    """``debug_level >= 3``: one line per running lane, the fields of the
    JAX body's print (``jax:solver.py:755-763``); ``lane`` is the index in
    the working set.  Reads the device: a host sync per body call."""
    lanes = run.nonzero()[:, 0]
    log_lam = torch.log10(torch.clamp(lam, min=1e-300))
    cols = [t[lanes].tolist() for t in (it, accepted, cost, dcost, g_norm, z,
                                        log_lam, w_pen_l, w_pen_f)]
    for b, (i, a, c, d, g, zz, ll, wl, wf) in zip(lanes.tolist(),
                                                  zip(*cols)):
        print(f"lane: {b}  iter: {i}  accepted: {a}  cost: {c:.6g}"
              f"  reduction: {d:.3g}  gradient: {g:.3g}  z: {zz:.3g}"
              f"  log10(lam): {ll:.1f}  w_pen_l: {wl:.3g} w_pen_f: {wf:.3g}",
              flush=True)


def _running(c: _Carry, max_iter: int) -> Tensor:
    return (~c.done) & (c.it < max_iter)


def _masked(body_fn, max_iter: int):
    """One body call of the loop: the new carry on the lanes whose loop
    condition held, the old one elsewhere (no host read)."""
    def step(c: _Carry, params) -> _Carry:
        c = tree_where(_running(c, max_iter), body_fn(c, params), c)
        launches.stamp("body_end", c.cost.device)
        return c
    return step


def _masked_steps(body_fn, c: _Carry, params, max_iter: int, n: int,
                  read=bool):
    """Up to ``n`` body calls; each keeps the new carry only on lanes whose
    loop condition held (the per-lane while-loop of the JAX version), and
    stops at the first call with no running lane, ``read`` taking that
    from the device before every call.  Returns ``(carry, calls)``."""
    for calls in range(n):
        run = _running(c, max_iter)
        if not read(run.any()):
            return c, calls
        c = tree_where(run, body_fn(c, params), c)
        launches.stamp("body_end", c.cost.device)
    return c, n


class _Loop(NamedTuple):
    """The whole solve's loop state: the carry and the body calls made."""

    carry: _Carry
    calls: Tensor  # int32, 0-d


def _solve_loop(body_fn, c: _Carry, params, o: SolverOptions) -> _Carry:
    """Masked body calls while a lane runs, at most
    :func:`_max_body_calls` of them: ``jax:solver.py:854``'s
    ``lax.while_loop`` of the whole solve, as one
    :func:`.ops.device_loop.while_loop` (a WHILE node in a CUDA graph
    capture; on the host elsewhere, one read before every body call)."""
    step = _masked(body_fn, o.max_iter)
    cap = _max_body_calls(o)

    def cond(s: _Loop) -> Tensor:
        return _running(s.carry, o.max_iter).any() & (s.calls < cap)

    def body(s: _Loop) -> _Loop:
        return _Loop(step(s.carry, params), s.calls + 1)

    dev = c.cost.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    launches.stamp("loop", dev)
    c = device_loop.while_loop(cond, body, _Loop(c, zero)).carry
    launches.stamp("loop_end", dev)
    return c


def _check_done(running: Tensor) -> None:
    """Raise if a lane still runs after the loop (a host read): each lane
    runs at most max_iter*(1+n_lam_steps) body calls."""
    if bool(running):
        raise RuntimeError("batched solver: lanes still active after "
                           "the body-call bound; this is a masking bug")


class SolveStats(NamedTuple):
    """What the last call of a :func:`make_batched_solver` solver did."""

    graphed: bool  # the solve was one CUDA graph replay
    captured: bool  # this call captured that graph (first call of its shapes)
    capture_s: float  # seconds of the capture, warm-up included (0 if none)


class _SolveGraph:
    """One input signature's whole solve as one CUDA graph: ``init_fn``,
    the WHILE node of :func:`_solve_loop`, ``finalize_fn`` and the count of
    still-running lanes, on static inputs that each call copies its own
    into.  Before the capture, ``init_fn``, :data:`_WARMUP_CALLS` masked
    body calls and ``finalize_fn`` run eagerly on a side stream (emission's
    autograd and the kernels' index tables must not meet their first use
    inside a capture).  The WHILE bodies allocate from a pool of their own,
    kept as long as the graph.  A capture error raises: there is no eager
    fallback.  ``nodes`` counts the graph's top-level nodes, its WHILE
    nodes and the nodes of their bodies.  The captured solve stamps
    ``solve`` before ``init_fn`` and ``solve_end`` after ``finalize_fn``
    (``launches.stamp``; ``loop`` and ``loop_end`` around the WHILE node,
    and each trip its body call's stamps); a call is the span
    ``ddp.solve_graph.call``, its host read ``ddp.solve_graph.read_wait``
    (``launches.span``), ``calls`` their id."""

    def __init__(self, parts, o: SolverOptions, x0: Tensor, u0: Tensor,
                 params):
        init_fn, body_fn, finalize_fn = parts
        t0 = time.time()
        dev = x0.device
        self.x0, self.u0 = x0.clone(), u0.clone()
        self.params = _params_map(torch.clone, params)
        self.calls = 0
        launches.before_capture(dev)  # the capture records adds to them
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            c = init_fn(self.x0, self.u0, self.params)
            step = _masked(body_fn, o.max_iter)
            for _ in range(_WARMUP_CALLS):
                c = step(c, self.params)
            finalize_fn(c)
            del c
        torch.cuda.current_stream(dev).wait_stream(side)
        self.pool = device_loop.BodyPool(dev)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = dict(device_loop.NODE_COUNTS)
        with device_loop.body_pool(self.pool), torch.cuda.graph(self.graph):
            launches.stamp("solve", dev)
            c = _solve_loop(body_fn, init_fn(self.x0, self.u0, self.params),
                            self.params, o)
            self.running = _running(c, o.max_iter).any()
            self.out = finalize_fn(c)
            launches.stamp("solve_end", dev)
            del c
        top = device_loop.graph_nodes(self.graph.raw_cuda_graph())
        loops = {k: device_loop.NODE_COUNTS[k] - before[k] for k in before}
        self.nodes = dict(top=top, while_nodes=loops["while"],
                          body_nodes=loops["body"],
                          total=top + loops["body"])
        self.graph.instantiate()
        torch.cuda.synchronize(dev)
        self.capture_s = time.time() - t0

    def __call__(self, x0: Tensor, u0: Tensor, params) -> Solution:
        self.calls += 1
        with launches.span("ddp.solve_graph.call", self.calls):
            self.x0.copy_(x0)
            self.u0.copy_(u0)
            _params_map(lambda d, v: d.copy_(v), self.params, params)
            self.graph.replay()
            with launches.span("ddp.solve_graph.read_wait", self.calls):
                _check_done(self.running)  # the one host read
            # the result must not alias the graph's outputs, which the next
            # call overwrites
            return Solution(*(t.clone() for t in self.out))


class _BatchedSolver:
    """The solver :func:`make_batched_solver` returns (one per problem,
    options, ``batch_params`` and device).  ``graphs`` holds a
    :class:`_SolveGraph` per input signature; ``last_stats``
    (:class:`SolveStats`) says what the last call did."""

    def __init__(self, problem: Problem, options: SolverOptions,
                 batch_params: bool, device: torch.device):
        self.options, self.device = options, device
        init_fn, body_fn, finalize_fn, self._cast = _make_parts(
            problem, options, device, batch_params)
        self._parts = (init_fn, body_fn, finalize_fn)
        self.graphs: dict = {}
        self.last_stats: SolveStats | None = None

    def graphed(self) -> bool:
        """Does a call run as a CUDA graph (a CUDA device, ``debug_level <
        3`` and no :func:`.ops.device_loop.eager_loops`)?"""
        return (self.device.type == "cuda" and self.options.debug_level < 3
                and not device_loop.loops_eager())

    def __call__(self, x0s, u0s, params) -> Solution:
        o = self.options
        p = self._cast(params, len(u0s), _horizon(u0s))
        init_fn, body_fn, finalize_fn = self._parts
        if not self.graphed():
            c = _solve_loop(body_fn, init_fn(x0s, u0s, p), p, o)
            _check_done(_running(c, o.max_iter).any())
            self.last_stats = SolveStats(False, False, 0.0)
            return finalize_fn(c)
        _check_device(x0s, self.device, "x0s")
        _check_device(u0s, self.device, "u0s")
        dtype = _DTYPES[o.dtype]
        x0 = torch.as_tensor(x0s, device=self.device).to(dtype)
        u0 = torch.as_tensor(u0s, device=self.device).to(dtype)
        key = (tuple(x0.shape), tuple(u0.shape), _params_key(p))
        g = self.graphs.get(key)
        captured = g is None
        if captured:
            g = self.graphs[key] = _SolveGraph(self._parts, o, x0, u0, p)
        sol = g(x0, u0, p)
        self.last_stats = SolveStats(True, captured,
                                     g.capture_s if captured else 0.0)
        return sol


@functools.lru_cache(maxsize=16)
def _batched_solver(problem: Problem, options: SolverOptions,
                    batch_params: bool, device: torch.device):
    return _BatchedSolver(problem, options, batch_params, device)


def make_batched_solver(problem: Problem,
                        options: SolverOptions = SolverOptions(),
                        batch_params: bool = False, *, device):
    """Batched solver ``(x0s (B, n_x), u0s (B, N, n_u), params) -> Solution``
    looping until no lane is active (JAX: ``jit(vmap(...))`` of the whole
    solve, ``jax:solver.py:878-892``).  ``params`` are shared by all lanes,
    or with ``batch_params`` per lane, every leaf ``(B, *leaf_shape)``.
    ``device`` is where the solve runs; tensor inputs on another device
    raise.

    On a CUDA device the whole solve is one CUDA graph (:class:`_SolveGraph`:
    the loop a WHILE node, its body the masked body call), captured at the
    first call of each input signature and replayed by every call; the
    host reads one value after the replay, the check that no lane is still
    running.  The solver, and so its graphs, is cached per (problem,
    options, ``batch_params``, device), as JAX caches its jitted solver per
    (problem, options).  Two cases keep the host loop, one read before
    every body call: ``debug_level >= 3``, whose per-iteration print reads
    the device from the host (JAX prints with ``jax.debug.print``, a host
    callback; a WHILE body holds no host node), and calls under
    :func:`.ops.device_loop.eager_loops` (the reference); on the CPU the
    same loop runs on the host."""
    return _batched_solver(problem, options, batch_params,
                           torch.device(device))


def make_solver(problem: Problem, options: SolverOptions = SolverOptions(),
                *, device):
    """One-instance solver ``(x0 (n_x,), u0 (N, n_u), params) -> Solution``
    (``jax:solver.py:836-861``): the batched solver at ``B=1``, so on a
    CUDA device one graph replay per call.  ``u0`` defines the horizon;
    ``params`` are the problem's (scalars, fixed arrays and ``[k]``-indexed
    arrays of length N+1)."""
    batched = make_batched_solver(problem, options, device=device)

    def solve_fn(x0, u0, params) -> Solution:
        # arrays go to the solve's device; tensors are checked there
        x0, u0 = (v[None] if isinstance(v, Tensor) else torch.as_tensor(
            np.asarray(v), device=device)[None] for v in (x0, u0))
        return Solution(*(f[0] for f in batched(x0, u0, params)))

    return solve_fn


def solve(problem: Problem, x0, u0, params: Any,
          options: SolverOptions = SolverOptions(), *, device) -> Solution:
    """One instance: :func:`make_solver`'s solver, called once (its graph
    is cached with the solver: a second call with the same problem,
    options and shapes replays it)."""
    return make_solver(problem, options, device=device)(x0, u0, params)


def _n_lam_steps(o: SolverOptions) -> int:
    # lambda multiplies by at least lambdaFactor per consecutive failure, so
    # it walks lambdaMin -> lambdaMax in at most this many attempts
    # (iLQG.c:261-275).
    lam_lo = max(o.lambdaMin, 1e-300)
    return 2 + int(np.ceil(np.log(max(o.lambdaMax / lam_lo, 2.0))
                           / np.log(o.lambdaFactor)))


def _max_body_calls(o: SolverOptions) -> int:
    return max(1, o.max_iter * (1 + _n_lam_steps(o)))


class LoopStats(NamedTuple):
    """What the last :class:`StepwiseSolver` call did on the host."""

    body_calls: int  # body calls of the loop, graph replays included
    replays: int  # of which CUDA graph replays
    host_reads: int  # device values the loop read (debug prints excluded)
    graphed: tuple  # working widths whose body calls were graph replays
    eager: tuple  # working widths whose body calls ran eagerly
    chunks: int = 0  # chunks of the loop (each ends in one count read)
    allreduces: int = 0  # all-reduces of the active count (with a mesh)
    global_counts: tuple = ()  # the all-reduced count of each chunk
    lane_steps: int = 0  # working width summed over the body calls


def _copy_into(dst, src) -> None:
    """``dst.copy_(src)`` leaf by leaf over a carry-like tree."""
    tree_map(lambda d, s: d.copy_(s), dst, src)


def _params_key(p):
    """Type, structure, shapes and dtypes of cast params (dicts of tensors,
    :class:`~.problem.LaneParams` per lane): a captured graph reads a
    static copy of exactly this."""
    if isinstance(p, dict):
        return (type(p),) + tuple((k, _params_key(v))
                                  for k, v in sorted(p.items()))
    return (tuple(p.shape), p.dtype)


def _params_map(fn, *trees):
    """``fn`` over the tensors of cast params (dicts of tensors), keeping
    each dict's type (:class:`~.problem.LaneParams` stays one, and its
    ``rows`` go with its leaves)."""
    if isinstance(trees[0], dict):
        out = type(trees[0])({k: _params_map(fn, *(t[k] for t in trees))
                              for k in trees[0]})
        rows = [getattr(t, "rows", None) for t in trees]
        if rows[0] is not None:
            if any(r is None for r in rows):
                raise ValueError("per-lane params without the kernels' rows")
            out.rows = fn(*rows)
        return out
    return fn(*trees)


def _horizon(u0s) -> int:
    """``N`` of batched initial inputs ``(B, N, n_u)``."""
    return int(u0s.shape[1]) if hasattr(u0s, "shape") else len(u0s[0])


# eager calls before a capture, as torch.cuda.graph's documentation does
_WARMUP_CALLS = 3


class _WidthBody:
    """The body call of one working width on a static carry it owns, updated
    in place: ``run()`` replays the body call's CUDA graph, or without a
    graph runs the same step eagerly.  ``active`` holds the count of running
    lanes after the last call (computed inside the graph, as JAX's chunk
    program returns its count).

    Capture follows ``torch.cuda.graph``'s rules: a few eager calls on a
    side stream first (emission's autograd must not meet its first use
    inside a capture), all on the static carry, a scratch copy of ``like``;
    the caller copies its working set in before the first ``run()``.  The
    device loops inside a body call (Newton boxQP, inline retries) are
    WHILE nodes whose bodies allocate from ``body_pool`` (a
    :class:`.ops.device_loop.BodyPool` the caller keeps).  A capture error
    raises: there is no eager fallback."""

    def __init__(self, step, like: _Carry, params, max_iter: int,
                 graph: bool, pool=None, body_pool=None):
        self._step, self._max_iter = step, max_iter
        self.carry = tree_map(torch.clone, like)
        self.params = params
        self.active = torch.zeros((), dtype=torch.int64,
                                  device=like.cost.device)
        self.graph = None
        if not graph:
            return
        dev = like.cost.device
        launches.before_capture(dev)  # the capture records adds to them
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(_WARMUP_CALLS):
                self._call()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with device_loop.body_pool(body_pool), \
                torch.cuda.graph(self.graph, pool=pool):
            self._call()

    def _call(self) -> None:
        _copy_into(self.carry, self._step(self.carry, self.params))
        self.active.copy_(_running(self.carry, self._max_iter).sum())

    def run(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        else:
            self._call()


class _LaggedCounts:
    """The active counts of the static route, read ``depth - 1`` chunks
    after they are computed (``jax:solver.py:1258-1300``): each is copied
    out when its chunk of replays is enqueued, and the oldest is read once
    ``depth`` are pending, so the host queues ``depth - 1`` more chunks
    before it waits on one.  ``depth=1`` reads each count at once.

    On a CUDA device a copy goes into one of at most ``depth`` pinned host
    slots (reused once read) with an event; ``w.active`` itself is
    overwritten by the next replay and is never kept.  On the CPU the copy
    is a clone."""

    def __init__(self, depth: int):
        self.depth = depth
        self._pending: deque = deque()  # (host copy, event or None)
        self._free: list = []  # pinned slots read and ready for reuse

    def push(self, count: Tensor) -> None:
        if count.device.type != "cuda":
            self._pending.append((count.clone(), None))
            return
        slot = (self._free.pop() if self._free else
                torch.empty((), dtype=count.dtype, pin_memory=True))
        slot.copy_(count, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(count.device))
        self._pending.append((slot, event))

    def pending(self) -> int:
        """Counts pushed and not yet read."""
        return len(self._pending)

    def pop(self):
        """The oldest pending count (its one host read) once ``depth`` are
        pending, else None."""
        if len(self._pending) < self.depth:
            return None
        slot, event = self._pending.popleft()
        if event is not None:
            event.synchronize()
            self._free.append(slot)
        return int(slot)

    def clear(self) -> None:
        """Drop the pending counts (a fresher one is known)."""
        for slot, event in self._pending:
            if event is not None:
                event.synchronize()
                self._free.append(slot)
        self._pending.clear()


class StepwiseSolver:
    """Host-driven batched solver: chunks of iterations with active-lane
    compaction (``ddp_generator_tpu.solver.StepwiseSolver``).

    When the active count falls to half the working width, finished lanes
    are scattered back into the full carry and the active ones gathered
    into a half-width working set (at most ``compact_levels`` times, never
    below ``min_compact_batch``).  Per-lane results are bit-identical with
    compaction on or off: every lane sees the same iteration sequence.

    **CUDA graphs.**  On a CUDA device a body call that reads nothing on
    the host is one replay of a CUDA graph captured for its working width
    (the port's counterpart of JAX's jitted chunk program, one per width):
    the graph reads and updates a static carry of that width and static
    params in place, and computes the active count inside it.  The host
    reads that count once every ``chunk`` replays and ends a chunk early
    when it is 0 (masked replays change no lane); compaction copies the
    gathered working set into the next width's static carry, and with
    ``batch_params`` its params into the width's own static params.
    Widths are captured at first use, or all before the timed call by
    :meth:`precompile`.  Graphed (:func:`_graphable`): every
    ``backpass_method`` and ``linesearch_method``, shared or per-lane
    params, boxQP's enumeration or Newton iteration, deferred or inline
    lambda retries (``lam_retry="inline"`` or ``inline_below`` widths):
    the loops inside a body call are WHILE nodes of its graph.  Eager on
    the card, one host read per body call: the per-iteration trace of
    ``debug_level >= 3``, and every width under
    :func:`.ops.device_loop.eager_loops`.  On the CPU the graphable
    configurations run the same loop on the static carries with eager body
    calls.  A capture or replay error raises; nothing falls back to the
    eager body.
    ``last_stats`` (:class:`LoopStats`) says what the last call did:
    replays, host reads, which widths ran graphed.

    ``inline_below``: working widths ``<= inline_below`` run a body with
    ``lam_retry="inline"`` (the reference's inner while around only the
    backward pass) instead of the deferred retries; per-lane results are
    the same either way, only ``bp_retry_calls`` counts backward-pass
    attempts in inline calls.  0 disables.

    ``batch_params``: every params leaf carries a leading lane axis; each
    compaction gathers the working set's params with the carry's index.

    ``require_kernels`` (keyword only): on a CUDA device, raise
    ``NotImplementedError`` here rather than run a torch route in place of
    a kernel that ``backpass_method`` or ``linesearch_method`` names
    (:func:`_check_kernels`), for a caller sized on the kernels' speed.
    On the CPU the plain versions stand in for the kernels, as always.

    ``pipeline_depth``: on the static route the active count of a chunk of
    replays is read ``pipeline_depth - 1`` chunks late (:class:`_LaggedCounts`),
    so the host's read overlaps the replays queued behind it.  The count
    only shrinks, so ending and compacting on a late count is conservative:
    every Solution field equals the synchronous read's (``pipeline_depth=1``,
    each count read as its chunk ends), at the cost of up to
    ``pipeline_depth - 1`` chunks of masked replays after the last lane
    retires (``last_stats`` counts them; no lane changes).  The JAX
    package's depth ``d`` lags ``d`` chunks; here depth 1 is the
    synchronous read.  The eager route and ``debug_level >= 1`` read every
    count at once.

    ``mesh`` (a 1-D ``DeviceMesh`` of :func:`.parallel.mesh.make_mesh`,
    dimension ``mesh_axis``): every rank passes the global inputs and
    runs its own rows (:func:`.parallel.mesh.shard_range`) through the
    machinery above on its device, and returns its rows of the Solution.
    Each chunk is ``chunk`` body calls and ends in exactly one collective:
    an all-reduce (sum) of one ``int64`` host scalar, the rank's active
    count as the loop reads it (``pipeline_depth - 1`` chunks late; a
    rank with no count due yet sends its last one, or its width), on the
    mesh's ``gloo`` group, so the card's stream never waits on it.  No
    collective touches the carry, the bundle or the params.  Every rank
    loops in lockstep until the global count is 0; a rank whose own count
    is 0 skips its body calls but joins each all-reduce.  Compaction is
    per rank, from the rank's own count, on its local width; JAX compacts
    the global working set and moves lanes across devices
    (``jax:solver.py:925-934``), its ``(size // 2) % n_shards`` rule
    keeping that width divisible.  Lanes are independent, so every lane's
    result is the same either way, and here no lane moves between cards.
    ``last_stats`` counts the chunks and the all-reduces and keeps the
    global counts.

    The positional parameters are the JAX package's.  ``donate`` is
    accepted and does nothing: torch has no buffer donation.  ``device``
    (keyword only) is where the solve runs; tensor inputs on another device
    raise.
    """

    def __init__(
        self,
        problem: Problem,
        options: SolverOptions = SolverOptions(),
        chunk: int = 10,
        batch_params: bool = False,
        donate: bool = True,
        compact_levels: int = 4,
        min_compact_batch: int = 128,
        mesh=None,
        mesh_axis: str = "batch",
        pipeline_depth: int = 1,
        inline_below: int = 0,
        *,
        device,
        require_kernels: bool = False,
    ):
        if require_kernels:
            _check_kernels(device, options, batch_params)
        self.options = options
        self.chunk = chunk
        self.compact_levels = compact_levels
        self.min_compact_batch = min_compact_batch
        self.batch_params = batch_params
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh

            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a DeviceMesh "
                                f"(parallel.mesh.make_mesh), got {mesh!r}")
        self.mesh, self.mesh_axis = mesh, mesh_axis
        self.pipeline_depth = max(1, pipeline_depth)
        self.inline_below = inline_below
        self.device = torch.device(device)
        (self._init, self._body, self._finalize,
         self._cast_params) = _make_parts(problem, options, self.device,
                                          batch_params)
        self._body_inline = self._body
        if inline_below > 0 and options.lam_retry != "inline":
            self._body_inline = _make_parts(
                problem, options.replace(lam_retry="inline"), self.device,
                batch_params)[1]
        o = options
        self._static_ok = _graphable(problem, o)
        self._widths: dict = {}  # (width, N) -> _WidthBody
        self._counts = _LaggedCounts(
            1 if o.debug_level >= 1 else self.pipeline_depth)
        self._p_static = self._p_key = self._pool = self._body_pool = None
        self._calls = 0  # calls made: the id of a call's spans
        self.last_stats: LoopStats | None = None

    def precompile(self, x0s, u0s, params, max_workers: int = 8) -> float:
        """Build everything a solve at this batch shape needs before the
        first timed call (JAX: compile every chunk program): load the kernel
        library, run ``init`` (which generates and builds the problem's
        CUDA model and B1 shape where the built-in ones do not serve), then
        capture, in the order the loop reaches them, the body-call graph of
        every width of :meth:`_compact_sizes` (warm-up calls on scratch
        carries, then the capture; each width's static carry is allocated
        here, and with ``batch_params`` its static params, from the first
        lanes of ``params``).  Returns the elapsed seconds.
        ``max_workers`` is accepted and unused: capture is serial (a graph
        captures one stream).  On the CPU it validates the shapes and
        allocates the static carries, and captures nothing."""
        t0 = time.time()
        if self.device.type == "cuda":
            _build.load_library()
        x0s, u0s, params = self._local(x0s, u0s, params)
        p = self._cast_params(params, len(u0s), _horizon(u0s))
        full = self._init(x0s, u0s, p)
        B, N = int(full.cost.shape[0]), int(full.us.shape[1])
        if self._static_ok:
            p = self._static_params(p)
            for size in self._compact_sizes(B):
                if self._on_static(size):
                    p_size = (p.take(torch.arange(size, device=self.device))
                              if self.batch_params else p)
                    self._width(size, N, tree_map(lambda a: a[:size], full),
                                p_size)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.time() - t0

    def _local(self, x0s, u0s, params):
        """This rank's rows of the global inputs (all of them unmeshed)."""
        if self.mesh is None:
            return x0s, u0s, params
        from .parallel.mesh import local_rows, shard_range

        start, stop = shard_range(self.mesh, len(u0s), self.mesh_axis)
        if self.batch_params:
            params = {k: local_rows(v, start, stop)
                      for k, v in params.items()}
        return (local_rows(x0s, start, stop), local_rows(u0s, start, stop),
                params)

    def _body_at(self, size: int):
        """The body for working width ``size``: inline retries at widths
        ``<= inline_below``."""
        if 0 < size <= self.inline_below:
            return self._body_inline
        return self._body

    def _on_static(self, size: int) -> bool:
        """Does width ``size`` run on a static carry (graphed on a CUDA
        device)?  Every width does unless ``debug_level >= 3``."""
        return self._static_ok

    def _static_params(self, p):
        """Shared params: ``p`` copied into the one static copy every
        width's graph reads.  Per-lane params: ``p`` as it is; each width
        owns static params of its width (:meth:`_width`), into which
        :meth:`__call__` copies its working set's.  A change of their type,
        structure or shapes drops every captured width."""
        key = _params_key(p)
        if key != self._p_key:
            self._widths.clear()
            self._p_key, self._p_static = key, None
        if self.batch_params:
            return p
        if self._p_static is None:
            self._p_static = _params_map(torch.clone, p)
        else:
            _params_map(lambda d, v: d.copy_(v), self._p_static, p)
        return self._p_static

    def _width(self, size: int, N: int, like: _Carry, params) -> _WidthBody:
        """The width's body call, captured (or set up) at first use on a
        scratch copy of ``like`` and, per lane, of ``params`` (lanes-last
        leaves of this width)."""
        graph = (self.device.type == "cuda"
                 and not device_loop.loops_eager())
        w = self._widths.get((size, N))
        if w is None or (w.graph is not None) != graph:
            if graph and self._pool is None:
                # widths never replay concurrently and keep nothing in the
                # pool across calls: one pool serves them all, and one more
                # the bodies of their device loops
                self._pool = torch.cuda.graph_pool_handle()
                self._body_pool = device_loop.BodyPool(self.device)
            if self.batch_params:
                params = _params_map(torch.clone, params)
            w = _WidthBody(_masked(self._body_at(size), self.options.max_iter),
                           like, params, self.options.max_iter, graph,
                           self._pool, self._body_pool)
            self._widths[(size, N)] = w
        return w

    def _chunk_len(self, size: int, B0: int) -> int:
        """Iterations per chunk, scaled inversely with the working width
        (capped 16x), as in the JAX version; ``chunk`` with a mesh, where
        the ranks' widths differ and every chunk ends in one all-reduce."""
        if self.mesh is not None:
            return self.chunk
        return self.chunk * max(1, min(B0 // max(size, 1), 16))

    def _can_halve(self, size: int) -> bool:
        return size % 2 == 0 and size // 2 >= self.min_compact_batch

    def _halves(self, size: int, active: int, levels_left: int) -> bool:
        """Does a working set of ``size`` with ``active`` running lanes
        halve (again)?"""
        return (levels_left > 0 and self._can_halve(size)
                and active <= size // 2)

    def _compact_sizes(self, B: int) -> list:
        """Working widths a batch of ``B`` can shrink through, largest first
        (JAX: ``_compact_sizes``; :meth:`__call__` halves by the same
        rule)."""
        sizes, size = [B], B
        for _ in range(self.compact_levels):
            if not self._can_halve(size):
                break
            size //= 2
            sizes.append(size)
        return sizes

    def _compact(self, full: _Carry, small: _Carry, idx, new_size: int):
        """Scatter the working set back (when it was itself compacted),
        order lanes actives-first (stable) and gather the new working set."""
        o = self.options
        if idx is not None:
            full = _scatter(full, idx, small)
        retired = (full.done | (full.it >= o.max_iter)).to(torch.int32)
        order = torch.sort(retired, stable=True).indices
        new_idx = order[:new_size]
        return full, tree_map(lambda a: a[new_idx], full), new_idx

    def _span(self, name: str):
        """A host span of this call (``launches.span``)."""
        return launches.span(name, self._calls)

    def _read(self, t: Tensor):
        """One host read of a device value by the loop (counted)."""
        self._reads += 1
        with self._span("ddp.stepwise.read_wait"):
            return t.item()

    def _clear_counts(self) -> None:
        """Drop the pending counts (``_LaggedCounts.clear``)."""
        if self._counts.pending():
            with self._span("ddp.stepwise.read_wait"):
                self._counts.clear()

    def _enter(self, size: int, N: int, small: _Carry, p):
        """The static width ``size`` with the working set ``small`` (and
        per-lane params ``p``) copied into its static carry (and params):
        ``(width, its carry, its params)``."""
        w = self._width(size, N, small, p)
        if small is not w.carry:
            _copy_into(w.carry, small)
        if p is not w.params:  # per-lane params of a new width
            _params_map(lambda d, v: d.copy_(v), w.params, p)
        return w, w.carry, w.params

    def _static_chunk(self, w: _WidthBody, n: int):
        """Up to ``n`` body calls of a static width, queueing the active
        count after every ``chunk`` of them; ``(calls, active)``, with
        ``active`` the last count read (``pipeline_depth - 1`` chunks late;
        None if none was due)."""
        calls, active = 0, None
        while calls < n:
            k = min(self.chunk, n - calls)
            with self._span("ddp.stepwise.enqueue"):
                for _ in range(k):
                    w.run()
                self._counts.push(w.active)
            calls += k
            if self._counts.pending() >= self._counts.depth:
                with self._span("ddp.stepwise.read_wait"):
                    active = self._counts.pop()
                self._reads += 1
                if active == 0:
                    break
        return calls, active

    def __call__(self, x0s, u0s, params) -> Solution:
        """Solve a batch.  On the host, the call is the span
        ``ddp.stepwise.call`` and its steps its children
        (``launches.span``, while a profiler records): ``init`` (params,
        ``init_fn``), ``enqueue`` (a chunk's body calls and its count),
        ``read_wait`` (a count's host read), ``compact`` (the new working
        set, copied into its width's static carry) and ``finalize``."""
        self._calls += 1
        with self._span("ddp.stepwise.call"):
            return self._solve(x0s, u0s, params)

    def _solve(self, x0s, u0s, params) -> Solution:
        t_start = time.time()
        o = self.options
        with self._span("ddp.stepwise.init"):
            x0s, u0s, params = self._local(x0s, u0s, params)
            p_full = p = self._cast_params(params, len(u0s), _horizon(u0s))
            full = self._init(x0s, u0s, p)
            B, N = int(full.cost.shape[0]), int(full.us.shape[1])
            small, idx, size = full, None, B
            if self._static_ok:
                p = self._static_params(p)
                w, small, p = self._enter(size, N, small, p)
        levels_left = self.compact_levels
        self._reads, calls_total, replays, lane_steps = 0, 0, 0, 0
        graphed, eager, global_counts = [], [], []
        meshed = self.mesh is not None
        if meshed:
            from .parallel.mesh import all_reduce_count
        # a meshed rank's last count read, and whether it was 0
        last_local, idle = size, False
        # Lambda retries do not advance `it`: loop on the active count,
        # bounded by the body-call cap (see _n_lam_steps), plus the chunks
        # a late count lags.
        n_calls = max(1, -(-o.max_iter * (1 + _n_lam_steps(o))
                           // self.chunk)) + self._counts.depth
        exhausted = True
        for chunk_i in range(n_calls):
            n = self._chunk_len(size, B)
            if idle:
                # a meshed rank whose lanes are all done only joins the
                # all-reduce below
                calls, active = 0, 0
            elif self._on_static(size):
                calls, active = self._static_chunk(w, n)
                if w.graph is not None:
                    replays += calls
                (graphed if w.graph is not None else eager).append(size)
            else:
                # the eager route's body calls read the host anyway
                with self._span("ddp.stepwise.enqueue"):
                    small, calls = _masked_steps(self._body_at(size), small,
                                                 p, o.max_iter, n, self._read)
                active = self._read(_running(small, o.max_iter).sum())
                self._clear_counts()  # older than this exact count
                eager.append(size)
            calls_total += calls
            lane_steps += size * calls
            if meshed:
                if active is not None:
                    last_local, idle = active, active == 0
                glob = all_reduce_count(last_local, self.mesh, self.mesh_axis)
                global_counts.append(glob)
                if glob == 0:
                    exhausted = False
                    break
                if idle:
                    continue
            if active is None:  # no late count due yet
                continue
            if o.debug_level >= 1:
                self._print_status(chunk_i, small, active, size, t_start)
            if active == 0:
                exhausted = False
                break
            if not self._halves(size, active, levels_left):
                continue
            with self._span("ddp.stepwise.compact"):
                while self._halves(size, active, levels_left):
                    size //= 2
                    levels_left -= 1
                    if idx is None:
                        # first compaction: the working set IS the full carry
                        full, small, idx = self._compact(small, None, None,
                                                         size)
                    else:
                        full, small, idx = self._compact(full, small, idx,
                                                         size)
                    if self.batch_params:
                        with self._span("ddp.stepwise.lane_params"):
                            p = p_full.take(idx)
                if self._on_static(size):
                    w, small, p = self._enter(size, N, small, p)
        self._clear_counts()
        if exhausted and self._read(_running(small, o.max_iter).any()):
            raise RuntimeError(
                f"StepwiseSolver: lanes still active after {n_calls} chunk "
                "calls; this indicates a masking bug")
        launches.add_lane_steps(lane_steps)
        with self._span("ddp.stepwise.finalize"):
            if idx is not None:
                full = _scatter(full, idx, small)  # a new carry
            else:
                # the result must not alias a static carry: the next call
                # would overwrite the caller's Solution
                full = tree_map(torch.clone, small)
            self.last_stats = LoopStats(
                body_calls=calls_total, replays=replays,
                host_reads=self._reads,
                graphed=tuple(dict.fromkeys(graphed)),
                eager=tuple(dict.fromkeys(eager)), chunks=chunk_i + 1,
                allreduces=len(global_counts),
                global_counts=tuple(global_counts), lane_steps=lane_steps)
            return self._finalize(full)

    def _print_status(self, chunk_i, c: _Carry, active, size, t_start):
        act = _running(c, self.options.max_iter)
        n = max(active, 1)
        mean_cost = float(torch.where(act, c.cost, 0.0).sum()) / n
        mean_it = float(torch.where(act, c.it, 0).sum()) / n
        big = float("inf")
        lam_lo = float(torch.where(act, c.lam, big).min())
        lam_hi = float(torch.where(act, c.lam, -big).max())
        print(
            f"chunk {chunk_i + 1}: active {active}/{size}"
            f"  mean iter {mean_it:.1f}  mean cost {mean_cost:.6g}"
            f"  log10(lam) [{np.log10(max(lam_lo, 1e-300)):.1f},"
            f" {np.log10(max(lam_hi, 1e-300)):.1f}]"
            f"  t={time.time() - t_start:.1f}s",
            file=sys.stderr, flush=True,
        )


def _scatter(full: _Carry, idx: Tensor, small: _Carry) -> _Carry:
    def put(f, s):
        out = f.clone()
        out[idx] = s
        return out
    return tree_map(put, full, small)


def make_stepwise_solver(problem: Problem,
                         options: SolverOptions = SolverOptions(),
                         chunk: int = 10, batch_params: bool = False,
                         mesh=None, pipeline_depth: int = 1,
                         inline_below: int = 0,
                         *, device) -> StepwiseSolver:
    """:class:`StepwiseSolver` with the JAX package's positional order
    (``jax:solver.py:1338-1350``)."""
    return StepwiseSolver(problem, options, chunk=chunk,
                          batch_params=batch_params, mesh=mesh,
                          pipeline_depth=pipeline_depth,
                          inline_below=inline_below, device=device)
