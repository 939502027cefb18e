"""Box-constrained QP: Tassa's projected-Newton boxQP and the exact
active-set enumeration (``ddp_generator_tpu.ops.boxqp``), batched.

Every function takes a leading batch: ``H (..., n, n)``, ``g``, ``lower``,
``upper``, ``x0 (..., n)``; each lane's result depends on that lane alone.
The reference's active-set index compaction (``boxQP.c:129-146``) is a
masked factorization (clamped rows/cols replaced by identity), and the
seven data-dependent exits are a result code per lane:

*  1: maxIter reached            (``boxQP.c:237``)
*  2: minStep reached in Armijo  (``boxQP.c:223-224``)
*  4: relative improvement below tol (``boxQP.c:85-86``)
*  5: gradient norm below tol    (``boxQP.c:149-150``)
*  6: all dimensions clamped     (``boxQP.c:125-126``)
* -1: Cholesky failed (non-PD free-set Hessian) (``boxQP.c:141-143``)
* -2: non-descent search direction (``boxQP.c:193-196``)

``res < 1`` makes the backward pass fail and the outer loop raise lambda
(``back_pass.c:168-171``, ``iLQG.c:272-275``).

The small products and sums run in index order (``ops/small.py``), so
the card and the CPU compute the same numbers.  This is the serial path of
the JAX package (``lax.while_loop`` outside any Pallas call), so plain
PyTorch is its port.
"""

from __future__ import annotations

import functools
import itertools
from typing import NamedTuple

import torch

from . import device_loop
from .chol import mod_chol_perturb
from .small import dot, mv, total

Tensor = torch.Tensor


class BoxQPHyper(NamedTuple):
    max_iter: int = 100
    min_grad: float = 1e-8
    min_rel_improve: float = 1e-8
    step_dec: float = 0.6
    min_step: float = 1e-22
    armijo: float = 0.1
    # "newton": the projected-Newton iteration (boxQP.c).
    # "enumerate": exact active-set enumeration.
    # "auto": enumerate for n <= 3, newton otherwise.
    method: str = "auto"
    # MOD_CHOL (boxQP.c:69-72, off by default like the reference):
    # precondition an indefinite H by the Schnabel-Eskow perturbation.
    use_mod_chol: bool = False


class BoxQPResult(NamedTuple):
    x: Tensor  # (..., n) solution
    res: Tensor  # (...) int32 result code
    clamped: Tensor  # (..., n) int32: 0 free, 1 at lower, 2 at upper
    free: Tensor  # (..., n) bool
    inv_h_free: Tensor  # (..., n, n) masked inverse of H[free, free]
    n_free: Tensor  # (...) int32


def _quad_value(H: Tensor, g: Tensor, x: Tensor) -> Tensor:
    return dot(x, g + 0.5 * mv(H, x))


def _all(mask: Tensor) -> Tensor:
    return mask.all(-1)


def _finite(x: Tensor) -> Tensor:
    """``isfinite`` in two operations: ``x - x`` is 0 unless x is inf/NaN."""
    return (x - x) == 0.0


@functools.lru_cache(maxsize=None)
def _pattern_masks(n: int, device: torch.device):
    """The clamp patterns ``(P, n)`` int32 and their at-lower, at-upper,
    free masks, built once per (n, device): by a body call's first eager
    run, never inside a CUDA graph capture (a copy from host memory)."""
    pat = torch.tensor(_patterns(n), dtype=torch.int32, device=device)
    return pat, pat == 1, pat == 2, pat == 0


def _masked_chol_inverse(H: Tensor, free: Tensor):
    """Inverse of the free-set submatrix without index compaction.

    Clamped rows/cols of ``H`` are replaced by identity, so the dense
    factorization equals the compacted one on the free block; the inverse
    is then zero outside the free block.  ``free (..., n)`` broadcasts
    against ``H (..., n, n)``.  For n <= 3 the inverse and the positive-
    definiteness test are closed forms (Sylvester's criterion, on the
    upper triangle as in the JAX version); above that
    ``torch.linalg.cholesky_ex`` of the symmetrized matrix (as
    ``jnp.linalg.cholesky`` symmetrizes), with the same finiteness and
    positive-diagonal test.  Returns ``(inv, ok)``."""
    n = H.shape[-1]
    fmask = free[..., :, None] & free[..., None, :]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    Hm = torch.where(fmask, H, eye)
    if n == 1:
        h = Hm[..., 0, 0]
        ok = (h > 0.0) & _finite(h)
        inv = torch.where(ok, 1.0 / h, 1.0)[..., None, None]
        return torch.where(fmask, inv, 0.0), ok
    finite = _finite(Hm).flatten(-2).all(-1)
    if n == 2:
        a, b, d = Hm[..., 0, 0], Hm[..., 0, 1], Hm[..., 1, 1]
        det = a * d - b * b
        ok = (a > 0.0) & (det > 0.0) & finite
        safe = torch.where(ok, det, 1.0)[..., None, None]
        inv = torch.stack([torch.stack([d, -b], -1),
                           torch.stack([-b, a], -1)], -2) / safe
    elif n == 3:
        a, b, c = Hm[..., 0, 0], Hm[..., 0, 1], Hm[..., 0, 2]
        d, e, f = Hm[..., 1, 1], Hm[..., 1, 2], Hm[..., 2, 2]
        m2 = a * d - b * b
        det = a * (d * f - e * e) - b * (b * f - c * e) + c * (b * e - c * d)
        ok = (a > 0.0) & (m2 > 0.0) & (det > 0.0) & finite
        safe = torch.where(ok, det, 1.0)[..., None, None]
        r0 = torch.stack([d * f - e * e, c * e - b * f, b * e - c * d], -1)
        r1 = torch.stack([c * e - b * f, a * f - c * c, b * c - a * e], -1)
        r2 = torch.stack([b * e - c * d, b * c - a * e, a * d - b * b], -1)
        inv = torch.stack([r0, r1, r2], -2) / safe
    else:
        chol, info = torch.linalg.cholesky_ex(0.5 * (Hm + Hm.mT))
        diag = torch.diagonal(chol, dim1=-2, dim2=-1)
        ok = ((info == 0) & _finite(chol).flatten(-2).all(-1)
              & (diag > 0.0).all(-1))
        safe = torch.where(ok[..., None, None], chol, eye)
        inv = torch.cholesky_solve(eye.expand(safe.shape), safe)
    return torch.where(fmask, inv, 0.0), ok


def _patterns(n: int):
    """Clamp patterns (0 free, 1 at lower, 2 at upper): all-free first, then
    by increasing number of clamps, product order within."""
    return sorted(itertools.product((0, 1, 2), repeat=n),
                  key=lambda pat: sum(1 for v in pat if v))


def boxqp_enumerate(H: Tensor, g: Tensor, lower: Tensor, upper: Tensor,
                    hyper: BoxQPHyper = BoxQPHyper()) -> BoxQPResult:
    """Exact box-QP by active-set enumeration.

    For a convex QP the optimum is the one clamp pattern of the 3^n
    (free / at lower / at upper per input) that satisfies KKT.  The patterns
    are one tensor axis ``P``: every pattern is solved in closed form at
    once, and the first valid one in pattern order wins (all-free first,
    then by increasing number of clamps, so degenerate ties resolve to the
    least-clamped pattern, as the Newton iteration's clamp test does,
    ``boxQP.c:105-114``).  The all-clamped winner returns 6
    (``boxQP.c:125-126``); no valid pattern, or an indefinite full ``H``,
    returns -1 like a Cholesky failure (``boxQP.c:141-143``)."""
    n = H.shape[-1]
    pat, at_lo, at_up, free = _pattern_masks(n, H.device)  # (P, n)
    Hp, gp = H[..., None, :, :], g[..., None, :]
    lo, up = lower[..., None, :], upper[..., None, :]
    fin_lo, fin_up = _finite(lo), _finite(up)
    # Clamping at an infinite bound is meaningless: such patterns are
    # invalid, and their clamped values are 0.
    use_lo, use_up = at_lo & fin_lo, at_up & fin_up
    bound_ok = _all(use_lo | use_up | free)
    xc = torch.where(use_lo, lo, torch.where(use_up, up, 0.0))
    inv, pd_ok = _masked_chol_inverse(Hp, free)  # (..., P, n, n), (..., P)
    # H_FF x_F = -(g_F + H_FC x_C)
    x = torch.where(free, mv(inv, -(gp + mv(Hp, xc))), xc)
    grad = gp + mv(Hp, x)
    # KKT: free inputs inside the box, gradient >= 0 at a lower bound and
    # <= 0 at an upper one
    kkt = _all(torch.where(free, (x >= lo) & (x <= up),
                           torch.where(at_lo, grad >= 0.0, grad <= 0.0)))
    valid = bound_ok & pd_ok & kkt & _all(_finite(x))  # (..., P)
    best_valid = valid.any(-1)
    first = valid.to(torch.int32).argmax(-1)  # first valid, or 0
    sel = first[..., None, None]
    best_x = x.gather(-2, sel.expand(first.shape + (1, n)))[..., 0, :]
    best_inv = inv.flatten(-2).gather(
        -2, sel.expand(first.shape + (1, n * n))).unflatten(-1, (n, n))
    bv = best_valid[..., None]
    best_x = torch.where(bv, best_x, 0.0)
    best_inv = torch.where(bv[..., None], best_inv[..., 0, :, :], 0.0)
    best_clamped = torch.where(bv, pat[first], 0)
    # the all-free pattern is the full H: its PD test is the reference's
    # first Cholesky (boxQP.c:129-143)
    res = torch.where(best_valid & pd_ok[..., 0],
                      torch.where(_all(best_clamped != 0), 6, 5), -1)
    free_out = best_clamped == 0
    return BoxQPResult(x=best_x, res=res.to(torch.int32),
                       clamped=best_clamped, free=free_out,
                       inv_h_free=best_inv,
                       n_free=free_out.sum(-1, dtype=torch.int32))


class _Armijo(NamedTuple):
    """The Armijo backtracking's per-lane state (``boxQP.c:198-227``)."""

    step: Tensor
    xc: Tensor  # the last trial point and its value
    vc: Tensor
    done: Tensor  # bool: accepted
    failed: Tensor  # bool: the step fell below min_step
    pending: Tensor  # bool: still backtracking


class _Carry(NamedTuple):
    x: Tensor
    value: Tensor
    oldvalue: Tensor
    clamped: Tensor  # int32 (..., n)
    inv_h: Tensor
    res: Tensor  # int32, 0 = still running
    it: Tensor  # int32


def _where(mask: Tensor, a: _Carry, b: _Carry) -> _Carry:
    """Per-lane select of a carry: ``mask (...)`` over trailing axes."""
    def w(x, y):
        return torch.where(mask.reshape(mask.shape + (1,) * (x.dim()
                                                             - mask.dim())),
                           x, y)
    return _Carry(*(w(x, y) for x, y in zip(a, b)))


def boxqp_newton(H: Tensor, g: Tensor, lower: Tensor, upper: Tensor,
                 x0: Tensor, hyper: BoxQPHyper = BoxQPHyper()) -> BoxQPResult:
    """The projected-Newton iteration (``boxQP.c:39-238``), batched.

    The loop runs while any lane has ``res == 0`` and ``it < max_iter``; a
    lane whose loop is over keeps its carry, every field of it.  The Armijo
    backtracking inside is masked the same way, so each lane's numbers are
    those of its own solve.  Both loops are :func:`.device_loop.while_loop`
    (``jax:ops/boxqp.py:340``, ``:366``): nested WHILE nodes inside a CUDA
    graph capture, host loops elsewhere; neither body reads the host."""
    i32 = torch.int32
    x_init = torch.minimum(torch.maximum(x0, lower), upper)
    batch = H.shape[:-2]
    zi = torch.zeros(batch, dtype=i32, device=H.device)
    c = _Carry(x=x_init, value=_quad_value(H, g, x_init),
               oldvalue=torch.zeros_like(x_init[..., 0]),
               clamped=torch.zeros_like(x_init, dtype=i32),
               inv_h=torch.zeros_like(H), res=zi, it=zi)

    def body(c: _Carry, run: Tensor) -> _Carry:
        # --- relative improvement check (boxQP.c:85-86), skipped at it 0 ---
        stop_rel = (c.it > 0) & ((c.oldvalue - c.value)
                                 < hyper.min_rel_improve * torch.abs(c.oldvalue))
        res = torch.where(stop_rel, 4, 0).to(i32)
        oldvalue = torch.where(stop_rel, c.oldvalue, c.value)
        live = res == 0

        # --- gradient and clamp detection (boxQP.c:95-117) ---
        grad = g + mv(H, c.x)
        at_lower = (c.x <= lower) & (grad > 0.0)
        at_upper = (c.x >= upper) & (grad < 0.0)
        clamped_new = torch.where(at_lower, 1,
                                  torch.where(at_upper, 2, 0)).to(i32)
        clamped = torch.where(live[..., None], clamped_new, c.clamped)
        free = clamped == 0
        all_clamped = ~free.any(-1)
        clamps_changed = ((clamped_new != 0) != (c.clamped != 0)).any(-1)
        gnorm2 = total(torch.where(free, grad * grad, 0.0))

        res = torch.where(live & all_clamped, 6, res).to(i32)
        live = res == 0

        # --- (re)factorize the free-set Hessian (boxQP.c:129-146) ---
        need_factor = (c.it == 0) | clamps_changed
        inv_new, chol_ok = _masked_chol_inverse(H, free)
        do_factor = live & need_factor
        inv_h = torch.where((do_factor & chol_ok)[..., None, None], inv_new,
                            c.inv_h)
        res = torch.where(do_factor & ~chol_ok, -1, res).to(i32)
        live = res == 0

        # --- gradient tolerance (boxQP.c:148-150) ---
        res = torch.where(live & (gnorm2 < hyper.min_grad * hyper.min_grad),
                          5, res).to(i32)
        live = res == 0

        # --- search direction (boxQP.c:153-177) ---
        grad_clamped = g + mv(H, torch.where(free, 0.0, c.x))
        search = torch.where(free, -mv(inv_h, grad_clamped) - c.x, 0.0)
        sdotg = dot(search, grad)
        res = torch.where(live & (sdotg >= 0.0), -2, res).to(i32)
        live = res == 0

        # --- Armijo backtracking (boxQP.c:198-227), masked per lane ---
        def a_cond(a: _Armijo) -> Tensor:
            return a.pending.any()

        def a_body(a: _Armijo) -> _Armijo:
            xn = torch.minimum(torch.maximum(c.x + a.step[..., None] * search,
                                             lower), upper)
            vn = _quad_value(H, g, xn)
            accept = (vn - oldvalue) / (a.step * sdotg) >= hyper.armijo
            next_step = a.step * hyper.step_dec
            failed = ~accept & (next_step < hyper.min_step)
            p = a.pending
            return _Armijo(
                step=torch.where(p & ~accept, next_step, a.step),
                xc=torch.where(p[..., None], xn, a.xc),
                vc=torch.where(p, vn, a.vc),
                done=torch.where(p, accept, a.done),
                failed=torch.where(p, failed, a.failed),
                pending=p & ~(accept | failed))

        a = device_loop.while_loop(a_cond, a_body, _Armijo(
            step=torch.ones_like(c.value), xc=c.x, vc=c.value,
            done=torch.zeros_like(live), failed=torch.zeros_like(live),
            pending=run & live))
        xc, vc, a_done, a_failed = a.xc, a.vc, a.done, a.failed
        res = torch.where(live & a_failed, 2, res).to(i32)
        accepted = live & a_done
        return _Carry(x=torch.where(accepted[..., None], xc, c.x),
                      value=torch.where(accepted, vc, c.value),
                      oldvalue=oldvalue, clamped=clamped, inv_h=inv_h,
                      res=res, it=c.it + 1)

    def running(c: _Carry) -> Tensor:
        return (c.res == 0) & (c.it < hyper.max_iter)

    def step(c: _Carry) -> _Carry:
        run = running(c)
        return _where(run, body(c, run), c)

    c = device_loop.while_loop(lambda c: running(c).any(), step, c)
    # Loop exhausted without another exit => maxIter (boxQP.c:237)
    res = torch.where(c.res == 0, 1, c.res).to(i32)
    free = c.clamped == 0
    return BoxQPResult(x=c.x, res=res, clamped=c.clamped, free=free,
                       inv_h_free=c.inv_h,
                       n_free=free.sum(-1, dtype=i32))


def enumerates(method: str, n: int) -> bool:
    """Does :func:`boxqp` take the enumeration for ``method`` on ``n``
    inputs, rather than the Newton iteration (two nested device loops)?"""
    return method == "enumerate" or (method == "auto" and n <= 3)


def boxqp(H: Tensor, g: Tensor, lower: Tensor, upper: Tensor, x0: Tensor,
          hyper: BoxQPHyper = BoxQPHyper()) -> BoxQPResult:
    """boxQP dispatcher: MOD_CHOL first when ``hyper.use_mod_chol``, then
    the enumeration (``"enumerate"``, or ``"auto"`` with n <= 3) or the
    Newton iteration.  ``x0`` is the warm start (``back_pass.c:163-166``)."""
    if hyper.use_mod_chol:
        # MOD_CHOL pre-regularization (boxQP.c:69-72): replace an indefinite
        # H by its Schnabel-Eskow PSD perturbation before solving.
        H, _ = mod_chol_perturb(H)
    if enumerates(hyper.method, H.shape[-1]):
        return boxqp_enumerate(H, g, lower, upper, hyper)
    return boxqp_newton(H, g, lower, upper, x0, hyper)
