"""Derivative bundles (``ddp_generator_tpu.derivs``).

Per running step ``k`` (names as in the reference ``trajEl_t``):
``fx (n_x,n_x)``, ``fu (n_x,n_u)``; ``fxx (n_x,n_x,n_x)``, ``fuu``, ``fxu``
when FULL_DDP; ``cx, cu, cxx, cuu, cxu`` of the AL-augmented running cost;
the input box bounds ``lower/upper/lower_hx/upper_hx/lower_sign/upper_sign``.
Final stage: ``cx``, ``cxx`` of the AL-augmented final cost.

:func:`batched_calc_derivs` gives the bundle of a batch, step-major with a
leading lane axis, as the serial backward pass (``ops/backpass.py``) reads
it: it unpacks the emission of ``ops/cm_derivs.py`` (autograd on the
whole ``(comp, N, B)`` plane, the second order forward-over-reverse), so
the serial and parallel routes share its rounding.  :func:`calc_derivs` is its one-instance
case.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .ops.cm_derivs import batched_calc_derivs_cm
from .ops.cuda_backpass import _unpack_sym, tri_size
from .problem import Problem

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
    w_pen_l,
    w_pen_f,
    full_ddp: bool,
) -> DerivBundle:
    """Differentiate dynamics and cost along one nominal trajectory
    (generated ``calc_derivs``, ``iLQG_func.tem:187-221``): the one-lane
    case of :func:`batched_calc_derivs`.  ``ok`` is the NaN/Inf guard
    (``genenerator_main.mac:193-198``)."""
    w = [torch.as_tensor(v, dtype=us.dtype, device=us.device).reshape(1)
         for v in (w_pen_l, w_pen_f)]
    d = batched_calc_derivs(problem, xs[None], us[None], p, mu_le[None],
                            mu_li[None], mu_fe[None], mu_fi[None], *w,
                            full_ddp)
    return DerivBundle(step=StepDerivs(*(f[0] for f in d.step)),
                       final=FinalDerivs(*(f[0] for f in d.final)),
                       ok=d.ok[0])


def batched_calc_derivs(problem, xs, us, p, mu_le, mu_li, mu_fe, mu_fi,
                        w_pen_l, w_pen_f, full_ddp) -> DerivBundle:
    """:func:`calc_derivs` of every lane (params shared, or per lane as
    :class:`.problem.LaneParams`), step-major:
    ``xs (B, N+1, n_x)``, ``us (B, N, n_u)``, ``mu_le (B, N, n_hle)``,
    ``mu_fe (B, n_hfe)``, ``w_pen_* (B,)``; every field gains a leading
    ``B``."""
    B, N = us.shape[0], us.shape[1]
    n_x, n_u = problem.n_x, problem.n_u
    sd_cm, fcx, fcxx, ok = batched_calc_derivs_cm(
        problem, xs, us, p, mu_le, mu_li, mu_fe, mu_fi, w_pen_l, w_pen_f,
        full_ddp)

    def lanes(a, *shape):  # (prod(shape), N, B) -> (B, N, *shape)
        a = a.reshape(shape + (N, B))
        return a.permute((len(shape) + 1, len(shape))
                         + tuple(range(len(shape))))

    def sym(a, n):  # packed upper triangle -> (B, N, n, n)
        return lanes(_unpack_sym(a, n).reshape(n * n, N, B), n, n)

    def tensor3(key, n):  # (n_x * tri(n), N, B) -> (B, N, n_x, n, n)
        rows = sd_cm[key].reshape(n_x, tri_size(n), N, B)
        return lanes(torch.stack([_unpack_sym(r, n) for r in rows]).reshape(
            n_x * n * n, N, B), n_x, n, n)

    if full_ddp:
        fxx, fuu = tensor3("fxx", n_x), tensor3("fuu", n_u)
        fxu = lanes(sd_cm["fxu"], n_x, n_x, n_u)
    else:
        fxx = fuu = fxu = us.new_zeros((B, N, 0, 0, 0))
    sd = StepDerivs(
        fx=lanes(sd_cm["fx"], n_x, n_x), fu=lanes(sd_cm["fu"], n_x, n_u),
        cx=lanes(sd_cm["cx"], n_x), cu=lanes(sd_cm["cu"], n_u),
        cxx=sym(sd_cm["cxx"], n_x), cuu=sym(sd_cm["cuu"], n_u),
        cxu=lanes(sd_cm["cxu"], n_x, n_u), fxx=fxx, fuu=fuu, fxu=fxu,
        lower=lanes(sd_cm["lower"], n_u), upper=lanes(sd_cm["upper"], n_u),
        lower_hx=lanes(sd_cm["lower_hx"], n_u, n_x),
        upper_hx=lanes(sd_cm["upper_hx"], n_u, n_x),
        lower_sign=lanes(sd_cm["lower_sign"], n_u),
        upper_sign=lanes(sd_cm["upper_sign"], n_u))
    final = FinalDerivs(cx=fcx.T, cxx=fcxx.T.reshape(B, n_x, n_x))
    return DerivBundle(step=sd, final=final, ok=ok)
