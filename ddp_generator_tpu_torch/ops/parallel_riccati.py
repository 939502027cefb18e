"""Parallel (associative-scan) Riccati backward pass
(``ddp_generator_tpu.ops.parallel_riccati``), batched over lanes.

The serial recursion of ``ops/backpass.py`` takes N dependent steps.  For
an unconstrained problem (no ``h``: boxQP clamping is a per-step
nonlinearity that breaks associativity) with ``full_ddp=False`` (the
FULL_DDP tensor terms tie the stage cost to the downstream ``Vx``), the LQ
subproblem of the backward pass is linear-quadratic, and each step
contributes a conditional value-function element ``(A, b, C, eta, J)``::

    V_{i->j}(x_i, x_j) = 1/2 x_i^T J x_i - eta^T x_i
                         + 1/2 (x_j - A x_i - b)^T C^+ (x_j - A x_i - b)

closed under the associative combination :func:`_combine`.  A reverse scan
gives the value function at every step in O(log N) depth; the gains, dV and
g_norm then come from one batched assembly over all steps, through the same
boxQP (infinite bounds) as the serial pass, so at ``lambda == 0`` both
passes give the same result.

Regularization: regType 1's ``Quu + lambda*I`` is folded into the stage
control cost (``cuu + lambda*I``), so the propagated value function uses
the regularized Quu; the reference propagates with the unregularized one
(``back_pass.c:217-241``).  For ``lambda > 0`` this pass is a (still
descent-producing) variant; regType 2 folds ``lambda fu^T fu`` the same
approximate way (the exact form also shifts Qxu).  At ``lambda == 0`` the
recursions are identical.

Torch has no ``associative_scan``: :func:`_suffix_scan` is a batched
doubling scan over the step axis (``ceil(log2(N+1))`` levels, each one
batched combination).  The small inverses use ``inv_ex`` without its
error check, so a singular lane gives non-finite values and
``failed`` (as ``jnp.linalg`` does) and the pass reads nothing from the
device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .backpass import BackPassResult
from .boxqp import BoxQPHyper, boxqp
from .small import mm, mv

Tensor = torch.Tensor


class _Element(NamedTuple):
    """Conditional value-function elements, every field ``(B, M, ...)``."""

    A: Tensor  # (..., n_x, n_x)
    b: Tensor  # (..., n_x)
    C: Tensor  # (..., n_x, n_x)
    eta: Tensor  # (..., n_x)
    J: Tensor  # (..., n_x, n_x)


# One sum launch per product: this pass is held to a tolerance, not bit
# for bit (ops/small.py).
_mm = functools.partial(mm, ordered=False)
_mv = functools.partial(mv, ordered=False)


def _sym(M: Tensor) -> Tensor:
    return 0.5 * (M + M.mT)


def _inv(M: Tensor) -> Tensor:
    return torch.linalg.inv_ex(M, check_errors=False)[0]


def _combine(e1: _Element, e2: _Element) -> _Element:
    """Associative composition: ``e1`` spans i->k (earlier), ``e2`` k->j.
    ``C`` and ``J`` are symmetric, so ``I + J2 C1`` is the transpose of
    ``I + C1 J2``: one inverse serves both of the JAX package's solves."""
    eye = torch.eye(e1.A.shape[-1], dtype=e1.A.dtype, device=e1.A.device)
    X = _inv(eye + _mm(e1.C, e2.J))
    M = _mm(e2.A, X)  # A2 (I + C1 J2)^-1
    Nt = _mm(e1.A.mT, X.mT)  # A1^T (I + J2 C1)^-1
    return _Element(
        A=_mm(M, e1.A),
        b=_mv(M, e1.b + _mv(e1.C, e2.eta)) + e2.b,
        C=_sym(_mm(_mm(M, e1.C), e2.A.mT) + e2.C),
        eta=_mv(Nt, e2.eta - _mv(e2.J, e1.b)) + e1.eta,
        J=_sym(_mm(_mm(Nt, e2.J), e1.A) + e1.J))


def _suffix_scan(e: _Element) -> _Element:
    """``out[:, k] = e_k . e_{k+1} . ... . e_{M-1}`` over the step axis 1,
    by doubling: after the level of stride ``d`` each element spans up to
    ``2d`` steps (the last ``d`` keep theirs: nothing lies after them)."""
    M = e.A.shape[1]
    d = 1
    while d < M:
        comb = _combine(_Element(*(a[:, :M - d] for a in e)),
                        _Element(*(a[:, d:] for a in e)))
        e = _Element(*(torch.cat([c, a[:, M - d:]], 1)
                       for c, a in zip(comb, e)))
        d *= 2
    return e


def _make_elements(sd, lam: Tensor, reg_type: int) -> _Element:
    """Per-step elements ``(B, N, ...)`` of the step-major bundle ``sd``."""
    fx, fu, cx, cu, cxx, cuu, cxu = (sd.fx, sd.fu, sd.cx, sd.cu, sd.cxx,
                                     sd.cuu, sd.cxu)
    lam4 = lam[:, None, None, None]
    if reg_type == 2:
        cuu_r = cuu + lam4 * _mm(fu.mT, fu)
    else:
        eye = torch.eye(cu.shape[-1], dtype=cu.dtype, device=cu.device)
        cuu_r = cuu + lam4 * eye
    cuu_inv = _inv(cuu_r)
    inv_cu = _mv(cuu_inv, cu)
    return _Element(
        A=fx - _mm(_mm(fu, cuu_inv), cxu.mT),
        b=-_mv(fu, inv_cu),
        C=_sym(_mm(_mm(fu, cuu_inv), fu.mT)),
        eta=-(cx - _mv(cxu, inv_cu)),
        J=_sym(cxx - _mm(_mm(cxu, cuu_inv), cxu.mT)))


def parallel_back_pass(derivs, us: Tensor, lam: Tensor, reg_type: int,
                       hyper: BoxQPHyper = BoxQPHyper()) -> BackPassResult:
    """O(log N)-depth backward pass of every lane of an unconstrained
    problem with ``full_ddp=False``: ``derivs`` a batched step-major
    ``DerivBundle`` (``(B, N, ...)``), ``us (B, N, n_u)``, ``lam (B,)``.
    Returns what :func:`.backpass.back_pass` returns; ``failed`` is per
    lane (a boxQP failure at any step, or a non-finite scan)."""
    sd = derivs.step
    B, N, n_u = us.shape
    n_x = sd.fx.shape[-1]
    dtype, dev = us.dtype, us.device

    elems = _make_elements(sd, lam, reg_type)
    zeros_xx = torch.zeros((B, 1, n_x, n_x), dtype=dtype, device=dev)
    final = _Element(
        A=zeros_xx, b=torch.zeros((B, 1, n_x), dtype=dtype, device=dev),
        C=zeros_xx, eta=-derivs.final.cx[:, None],
        J=derivs.final.cxx[:, None])
    suff = _suffix_scan(_Element(*(torch.cat([a, f], 1)
                                   for a, f in zip(elems, final))))
    Vx_all = -suff.eta  # (B, N+1, n_x); V_k(dx) = 1/2 dx^T J dx - eta^T dx
    Vxx_all = suff.J
    ok_scan = (torch.isfinite(Vx_all).flatten(1).all(1)
               & torch.isfinite(Vxx_all).flatten(1).all(1))

    # The gains of every step from V_{k+1}, assembled as in the serial pass
    # (unconstrained: boxQP with infinite bounds is the free solve).
    Vx1, Vxx1 = Vx_all[:, 1:], Vxx_all[:, 1:]
    fx, fu = sd.fx, sd.fu
    Qu = sd.cu + _mv(fu.mT, Vx1)
    Qxu = sd.cxu + _mm(_mm(fx.mT, Vxx1), fu)
    Quu = sd.cuu + _mm(_mm(fu.mT, Vxx1), fu)
    lam4 = lam[:, None, None, None]
    if reg_type == 2:
        QuuF = Quu + lam4 * _mm(fu.mT, fu)
        Qxu_reg = Qxu + lam4 * _mm(fx.mT, fu)
    else:
        QuuF = Quu + lam4 * torch.eye(n_u, dtype=dtype, device=dev)
        Qxu_reg = Qxu
    inf = torch.full((B, N, n_u), float("inf"), dtype=dtype, device=dev)
    qp = boxqp(QuuF, Qu, -inf, inf, torch.zeros_like(Qu), hyper)
    l = qp.x
    L = -_mm(qp.inv_h_free, Qxu_reg.mT)
    dV = torch.stack([(l * Qu).sum(-1), 0.5 * (l * _mv(Quu, l)).sum(-1)],
                     -1).sum(1)
    g = (l.abs() / (us.abs() + 1.0)).amax(-1)
    failed = (qp.res < 1).any(1) | ~ok_scan
    return BackPassResult(l=l, L=L, dV=dV, g_norm=g.sum(1) / float(N - 1),
                          failed=failed)
