"""The outer iLQG loop (``ddp_generator_tpu.solver``), batched, in PyTorch.

One body call is one masked outer iteration of every lane of the batch
(``iLQG.c:239-361``): derivative emission into the packed component-major
bundle (``ops/cm_derivs.py``), the backward pass (kernel B1), the
gradient-tolerance exit, the staged line search (kernel B2), then the
accept/reject updates.  The JAX package writes one lane and ``vmap``s it,
with ``custom_vmap`` rules that hand the batch to its kernels; here the
batch dimension is written out, every masked update is a ``torch.where``
per lane, and a lane whose loop condition is false keeps its carry.

Two loops share the body: :func:`make_batched_solver` loops until no lane
is active; :class:`StepwiseSolver` runs chunks of iterations with active-
lane compaction.  Per-lane results are identical between them and with
compaction on or off.
"""

from __future__ import annotations

import sys
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from . import solution as sol
from .al import Multipliers, init_multipliers, update_multipliers
from .convert import to_torch
from .ops.cm_derivs import cm_back_pass_from_bundle, cm_emit
from .ops.cuda_rollout import kernel_line_search, kernel_line_search_staged
from .ops.forward import cost_only, forward_pass
from .options import SolverOptions
from .problem import Problem
from .solution import Solution

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


def _tree_map(fn, *trees):
    """Map over the tensors of (nested) NamedTuples of tensors."""
    head = trees[0]
    if isinstance(head, tuple):
        return type(head)(*(_tree_map(fn, *ts) for ts in zip(*trees)))
    return fn(*trees)


def _lane_where(mask: Tensor, a, b):
    """Per-lane select over a carry-like tree; ``mask (B,)`` broadcast over
    each leaf's trailing axes."""
    def w(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
        return torch.where(m, x, y)
    return _tree_map(w, a, b)


def _check_ported(problem: Problem, o: SolverOptions) -> None:
    """Raise for options that validate but whose code is not ported yet,
    naming the ROADMAP item that ports it."""
    if o.backpass_method != "kernel":
        raise NotImplementedError(
            f"backpass_method={o.backpass_method!r} is not ported yet "
            "(ROADMAP.md queue A: the serial path backpass/boxqp/chol, "
            "parallel_riccati, fused_derivs_back_pass B3); use 'kernel'")
    if o.linesearch_method != "kernel":
        raise NotImplementedError(
            f"linesearch_method={o.linesearch_method!r} is not ported yet "
            "(ROADMAP.md queue A: the serial path); use 'kernel'")
    if o.lam_retry != "deferred":
        raise NotImplementedError(
            "lam_retry='inline' is not ported yet (ROADMAP.md queue A: "
            "inline retries and inline_below)")
    if o.derivs_emitter != "per-family":
        raise NotImplementedError(
            "derivs_emitter='shared' is not ported (the port emits per "
            "family only)")
    if o.dtype not in _DTYPES:
        raise ValueError(f"dtype must be float32|float64, got {o.dtype!r}")
    if problem.n_u > 3:
        raise ValueError("backpass_method='kernel' supports n_u <= 3")


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


def _make_parts(problem: Problem, options: SolverOptions, device):
    """Build ``(init_fn, body_fn, finalize_fn)`` on batched carries.

    * ``init_fn(x0s, u0s, params) -> _Carry``: initial open-loop rollout and
      multiplier recording (``iLQG_mex.c:113-116``, ``iLQG.c:237``);
    * ``body_fn(carry, params) -> _Carry``: one outer iteration of every
      lane (the caller keeps the carry of lanes whose loop is over);
    * ``finalize_fn(carry) -> Solution``.
    """
    o = options
    _check_ported(problem, o)
    dtype = _DTYPES[o.dtype]
    device = torch.device(device)
    alphas = tuple(float(a) for a in o.alpha)
    A = len(alphas)
    lambda_success_thresh = 1e-5  # iLQG.c:297
    n_log = max(o.max_iter, 1)
    has_al = (problem.n_hle + problem.n_hli + problem.n_hfe
              + problem.n_hfi) > 0
    i32 = torch.int32

    def full(B, v, dt=dtype):
        return torch.full((B,), v, dtype=dt, device=device)

    def init_fn(x0s, u0s, params) -> _Carry:
        _check_device(x0s, device, "x0s")
        _check_device(u0s, device, "u0s")
        x0 = torch.as_tensor(x0s, device=device).to(dtype)
        u0 = torch.as_tensor(u0s, device=device).to(dtype)
        B, N = u0.shape[0], u0.shape[1]
        mult0 = init_multipliers(problem, B, N, dtype, device)
        w_pen_l0, w_pen_f0 = full(B, o.w_pen_init_l), full(B, o.w_pen_init_f)
        # Initial open-loop rollout (iLQG_mex.c:113-116): alpha=0, u = u0.
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
        return _Carry(
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

    def set_log(log, it, alive, value):
        new = log.clone()
        rows = torch.arange(log.shape[0], device=device)
        new[rows, it.clamp(max=n_log - 1).long()] = value.to(log.dtype)
        return torch.where(alive[:, None], new, log)

    def body_fn(c: _Carry, params) -> _Carry:
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
        # ===== STEP 2: backward pass, one attempt per body call =====
        sd_cm, fcx, fcxx, us_cm, d_ok = cm_emit(
            problem, c.xs, c.us, c.mult.mu_le, c.mult.mu_li, c.mult.mu_fe,
            c.mult.mu_fi, w_pen_l_d, w_pen_f_d, params, o.full_ddp)
        bp = cm_back_pass_from_bundle(sd_cm, fcx, fcxx, us_cm, c.lam,
                                      problem.n_x, o.regType, o.full_ddp)
        del sd_cm
        derivs_failed = c.new_deriv & ~d_ok
        status = where(derivs_failed, sol.STATUS_DERIVS_FAILED, status)
        alive = ~derivs_failed
        # Deferred lambda retry (iLQG.c:261-284): a failed pass escalates
        # lambda; the lane retries on the next call WITHOUT advancing `it`.
        dlam_f = torch.clamp(c.dlam * lf, min=lf)
        lam_f = torch.clamp(c.lam * dlam_f, min=o.lambdaMin)
        bp_failed = alive & bp.failed
        gave_up = bp_failed & (lam_f > o.lambdaMax)
        retrying = bp_failed & ~gave_up
        lam = where(bp_failed, lam_f, c.lam)
        dlam = where(bp_failed, dlam_f, c.dlam)
        bp_retry_calls = c.bp_retry_calls + processed * (
            c.was_bp_retry & ~c.new_deriv).to(i32)
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
        ls_args = (problem, alphas, c.xs[:, 0], c.xs, c.us, bp.l, bp.L, bp.dV,
                   c.cost, o.zMin, params, c.mult.mu_le, c.mult.mu_li,
                   c.mult.mu_fe, c.mult.mu_fi, c.w_pen_l, c.w_pen_f)
        if o.linesearch_staged:
            ls = kernel_line_search_staged(*ls_args, alive=ls_alive)
        else:
            ls = kernel_line_search(*ls_args)
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
            mult = _lane_where(do_mult_update, upd.multipliers, c.mult)
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

        lammax_exit = rejected & (lam > o.lambdaMax)
        status = where(lammax_exit, sol.STATUS_EXIT_LAMBDA_MAX, status)
        done = status != sol.STATUS_RUNNING
        halt = done | retrying
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

    def cast_params(params):
        # All floating params in the solve dtype, on the solve device.
        _check_device(params, device, "params")
        return to_torch(dict(params), dtype, device)

    return init_fn, body_fn, finalize_fn, cast_params


def _running(c: _Carry, max_iter: int) -> Tensor:
    return (~c.done) & (c.it < max_iter)


def _masked_steps(body_fn, c: _Carry, params, max_iter: int, n: int):
    """Up to ``n`` body calls; each keeps the new carry only on lanes whose
    loop condition held (the per-lane while-loop of the JAX version)."""
    for _ in range(n):
        run = _running(c, max_iter)
        if not bool(run.any()):
            break
        c = _lane_where(run, body_fn(c, params), c)
    return c


def make_batched_solver(problem: Problem,
                        options: SolverOptions = SolverOptions(),
                        batch_params: bool = False, *, device):
    """Batched solver ``(x0s (B, n_x), u0s (B, N, n_u), params) -> Solution``
    looping until no lane is active (JAX: ``vmap`` of the whole solve).
    ``params`` are shared by all lanes.  ``device`` is where the solve runs;
    tensor inputs on another device raise."""
    if batch_params:
        raise NotImplementedError(
            "batch_params=True is not ported yet (ROADMAP.md queue A); the "
            "kernels take shared params")
    init_fn, body_fn, finalize_fn, cast_params = _make_parts(
        problem, options, device)

    def solve_fn(x0s, u0s, params) -> Solution:
        p = cast_params(params)
        c = init_fn(x0s, u0s, p)
        # each lane runs at most max_iter*(1+n_lam_steps) body calls
        c = _masked_steps(body_fn, c, p, options.max_iter,
                          _max_body_calls(options))
        if bool(_running(c, options.max_iter).any()):
            raise RuntimeError("batched solver: lanes still active after "
                               "the body-call bound; this is a masking bug")
        return finalize_fn(c)

    return solve_fn


def solve(problem: Problem, x0, u0, params: Any,
          options: SolverOptions = SolverOptions(), *, device) -> Solution:
    """One instance: the batched solver at ``B=1``."""
    x0, u0 = (v[None] if isinstance(v, Tensor)
              else torch.as_tensor(np.asarray(v))[None] for v in (x0, u0))
    out = make_batched_solver(problem, options, device=device)(x0, u0, params)
    return Solution(*(f[0] for f in out))


def _n_lam_steps(o: SolverOptions) -> int:
    # lambda multiplies by at least lambdaFactor per consecutive failure, so
    # it walks lambdaMin -> lambdaMax in at most this many attempts
    # (iLQG.c:261-275).
    lam_lo = max(o.lambdaMin, 1e-300)
    return 2 + int(np.ceil(np.log(max(o.lambdaMax / lam_lo, 2.0))
                           / np.log(o.lambdaFactor)))


def _max_body_calls(o: SolverOptions) -> int:
    return max(1, o.max_iter * (1 + _n_lam_steps(o)))


class StepwiseSolver:
    """Host-driven batched solver: chunks of iterations with active-lane
    compaction (``ddp_generator_tpu.solver.StepwiseSolver``).

    When the active count falls to half the working width, finished lanes
    are scattered back into the full carry and the active ones gathered
    into a half-width working set (at most ``compact_levels`` times, never
    below ``min_compact_batch``).  Per-lane results are bit-identical with
    compaction on or off: every lane sees the same iteration sequence.

    ``device`` is where the solve runs; tensor inputs on another device
    raise.  ``mesh``, ``pipeline_depth > 1``, ``inline_below`` and
    ``batch_params`` are not ported yet and raise ``NotImplementedError``.
    """

    def __init__(
        self,
        problem: Problem,
        options: SolverOptions = SolverOptions(),
        chunk: int = 10,
        batch_params: bool = False,
        compact_levels: int = 4,
        min_compact_batch: int = 128,
        mesh=None,
        pipeline_depth: int = 1,
        inline_below: int = 0,
        *,
        device,
    ):
        not_ported = [
            (mesh is not None, "mesh (ROADMAP.md queue A: mesh over "
             "torch.distributed)"),
            (pipeline_depth > 1, "pipeline_depth > 1 (ROADMAP.md queue A)"),
            (inline_below > 0, "inline_below (ROADMAP.md queue A: inline "
             "retries and inline_below)"),
            (batch_params, "batch_params=True (ROADMAP.md queue A)"),
        ]
        for cond, what in not_ported:
            if cond:
                raise NotImplementedError(f"StepwiseSolver: {what} is not "
                                          "ported yet")
        self.options = options
        self.chunk = chunk
        self.compact_levels = compact_levels
        self.min_compact_batch = min_compact_batch
        self.device = torch.device(device)
        (self._init, self._body, self._finalize,
         self._cast_params) = _make_parts(problem, options, self.device)

    def precompile(self, x0s, u0s, params, max_workers: int = 8) -> float:
        raise NotImplementedError(
            "precompile is not ported yet (ROADMAP.md queue A: aot with "
            "CUDA graphs); eager torch compiles nothing, the kernels build "
            "at first use")

    def _chunk_len(self, size: int, B0: int) -> int:
        """Iterations per chunk, scaled inversely with the working width
        (capped 16x), as in the JAX version."""
        return self.chunk * max(1, min(B0 // max(size, 1), 16))

    def _can_halve(self, size: int) -> bool:
        return size % 2 == 0 and size // 2 >= self.min_compact_batch

    def _compact(self, full: _Carry, small: _Carry, idx, new_size: int):
        """Scatter the working set back (when it was itself compacted),
        order lanes actives-first (stable) and gather the new working set."""
        o = self.options
        if idx is not None:
            full = _scatter(full, idx, small)
        retired = (full.done | (full.it >= o.max_iter)).to(torch.int32)
        order = torch.sort(retired, stable=True).indices
        new_idx = order[:new_size]
        return full, _tree_map(lambda a: a[new_idx], full), new_idx

    def __call__(self, x0s, u0s, params) -> Solution:
        t_start = time.time()
        o = self.options
        p = self._cast_params(params)
        full = self._init(x0s, u0s, p)
        B = int(full.cost.shape[0])
        small, idx, size = full, None, B
        levels_left = self.compact_levels
        # Lambda retries do not advance `it`: loop on the active count,
        # bounded by the body-call cap (see _n_lam_steps).  The count is read
        # at once: _masked_steps syncs on every body call anyway.
        n_calls = max(1, -(-o.max_iter * (1 + _n_lam_steps(o))
                           // self.chunk)) + 1
        exhausted = True
        for chunk_i in range(n_calls):
            small = _masked_steps(self._body, small, p, o.max_iter,
                                  self._chunk_len(size, B))
            active = int(_running(small, o.max_iter).sum())
            if o.debug_level >= 1:
                self._print_status(chunk_i, small, active, size, t_start)
            if active == 0:
                exhausted = False
                break
            while (levels_left > 0 and self._can_halve(size)
                   and active <= size // 2):
                size //= 2
                levels_left -= 1
                if idx is None:
                    # first compaction: the working set IS the full carry
                    full, small, idx = self._compact(small, None, None, size)
                else:
                    full, small, idx = self._compact(full, small, idx, size)
        if exhausted and bool(_running(small, o.max_iter).any()):
            raise RuntimeError(
                f"StepwiseSolver: lanes still active after {n_calls} chunk "
                "calls; this indicates a masking bug")
        full = _scatter(full, idx, small) if idx is not None else small
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
    return _tree_map(put, full, small)


def make_stepwise_solver(problem: Problem,
                         options: SolverOptions = SolverOptions(),
                         chunk: int = 10, batch_params: bool = False,
                         mesh=None, pipeline_depth: int = 1,
                         inline_below: int = 0,
                         *, device) -> StepwiseSolver:
    return StepwiseSolver(problem, options, chunk=chunk,
                          batch_params=batch_params, mesh=mesh,
                          pipeline_depth=pipeline_depth,
                          inline_below=inline_below, device=device)
