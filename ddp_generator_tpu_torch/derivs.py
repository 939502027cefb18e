"""Derivative bundles via ``torch.func`` (``ddp_generator_tpu.derivs``).

Per running step ``k`` (names as in the reference ``trajEl_t``):
``fx (n_x,n_x)``, ``fu (n_x,n_u)``; ``fxx (n_x,n_x,n_x)``, ``fuu``, ``fxu``
when FULL_DDP; ``cx, cu, cxx, cuu, cxu`` of the AL-augmented running cost;
the input box bounds ``lower/upper/lower_hx/upper_hx/lower_sign/upper_sign``.
Final stage: ``cx``, ``cxx`` of the AL-augmented final cost.

:func:`calc_derivs` differentiates one instance with ``jacfwd``/``grad``
under ``vmap`` over the horizon; :func:`batched_calc_derivs` maps it over a
leading batch axis.  The solver's hot path does not use it: it emits the
packed component-major bundle of ``ops/cm_derivs.py`` instead.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.func import grad, jacfwd, vmap

from .al import augmented_F, augmented_L
from .problem import Problem, limits_u

Tensor = torch.Tensor


class StepDerivs(NamedTuple):
    """Per-step derivative data, stacked over the horizon (leading dim N)."""

    fx: Tensor
    fu: Tensor
    cx: Tensor
    cu: Tensor
    cxx: Tensor
    cuu: Tensor
    cxu: Tensor  # d2L/(dx du), (n_x, n_u) per step
    fxx: Tensor  # zero-size placeholder when full_ddp=False
    fuu: Tensor
    fxu: Tensor
    lower: Tensor
    upper: Tensor
    lower_hx: Tensor
    upper_hx: Tensor
    lower_sign: Tensor
    upper_sign: Tensor


class FinalDerivs(NamedTuple):
    cx: Tensor
    cxx: Tensor


class DerivBundle(NamedTuple):
    step: StepDerivs
    final: FinalDerivs
    ok: Tensor  # bool: all derivatives finite


def calc_derivs(
    problem: Problem,
    xs: Tensor,  # (N+1, n_x) nominal trajectory
    us: Tensor,  # (N, n_u)
    p: Any,
    mu_le: Tensor,  # (N, n_hle)
    mu_li: Tensor,
    mu_fe: Tensor,  # (n_hfe,)
    mu_fi: Tensor,
    w_pen_l: Tensor,
    w_pen_f: Tensor,
    full_ddp: bool,
) -> DerivBundle:
    """Differentiate dynamics and cost along one nominal trajectory
    (generated ``calc_derivs``, ``iLQG_func.tem:187-221``).  ``ok`` is the
    NaN/Inf guard (``genenerator_main.mac:193-198``)."""
    N = us.shape[0]
    n_x, n_u = problem.n_x, problem.n_u
    dtype, dev = us.dtype, us.device

    def L_aug(x, u, k, mle, mli):
        return augmented_L(problem, x, u, p, k, mle, mli, w_pen_l)

    def f_fn(x, u, k):
        return problem.f(x, u, p, k)

    def step(k, x, u, mle, mli):
        fx = jacfwd(f_fn, argnums=0)(x, u, k)
        fu = jacfwd(f_fn, argnums=1)(x, u, k)
        cx = grad(L_aug, argnums=0)(x, u, k, mle, mli)
        cu = grad(L_aug, argnums=1)(x, u, k, mle, mli)
        cxx = jacfwd(grad(L_aug, argnums=0), argnums=0)(x, u, k, mle, mli)
        cuu = jacfwd(grad(L_aug, argnums=1), argnums=1)(x, u, k, mle, mli)
        cxu = jacfwd(grad(L_aug, argnums=0), argnums=1)(x, u, k, mle, mli)
        if full_ddp:
            fxx = jacfwd(jacfwd(f_fn, argnums=0), argnums=0)(x, u, k)
            fuu = jacfwd(jacfwd(f_fn, argnums=1), argnums=1)(x, u, k)
            fxu = jacfwd(jacfwd(f_fn, argnums=0), argnums=1)(x, u, k)
        else:
            fxx = fuu = fxu = x.new_zeros((0, 0, 0))
        lo, up, lo_hx, up_hx, lo_s, up_s = limits_u(problem, x, u, p, k)
        return (fx, fu, cx, cu, cxx, cuu, cxu, fxx, fuu, fxu,
                lo, up, lo_hx, up_hx, lo_s, up_s)

    ks = torch.arange(N, device=dev)
    sd = StepDerivs(*vmap(step)(ks, xs[:N], us, mu_le, mu_li))
    if not full_ddp:
        z = torch.zeros((N, 0, 0, 0), dtype=dtype, device=dev)
        sd = sd._replace(fxx=z, fuu=z, fxu=z)

    def F_aug(x):
        return augmented_F(problem, x, p, N, mu_fe, mu_fi, w_pen_f)

    cx_f = grad(F_aug)(xs[N])
    cxx_f = jacfwd(grad(F_aug))(xs[N])
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for a in (sd.fx, sd.fu, sd.cx, sd.cu, sd.cxx, sd.cuu, sd.cxu,
              sd.fxx, sd.fuu, sd.fxu, cx_f, cxx_f):
        ok = ok & torch.isfinite(a).all()
    return DerivBundle(step=sd, final=FinalDerivs(cx=cx_f, cxx=cxx_f), ok=ok)


def batched_calc_derivs(problem, xs, us, p, mu_le, mu_li, mu_fe, mu_fi,
                        w_pen_l, w_pen_f, full_ddp) -> DerivBundle:
    """:func:`calc_derivs` over a leading batch axis (shared params)."""
    return vmap(
        lambda xs_, us_, mle, mli, mfe, mfi, wl, wf: calc_derivs(
            problem, xs_, us_, p, mle, mli, mfe, mfi, wl, wf, full_ddp)
    )(xs, us, mu_le, mu_li, mu_fe, mu_fi, w_pen_l, w_pen_f)
