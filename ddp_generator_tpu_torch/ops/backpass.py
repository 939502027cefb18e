"""Backward pass: the Riccati-like recursion with control-limited boxQP
gains (``ddp_generator_tpu.ops.backpass``), batched over lanes.

The serial path of ``backpass_method="serial"``: a reverse Python loop over
the N steps of the step-major bundle of :func:`..derivs.batched_calc_derivs`
(every field ``(B, N, ...)``), each step on all lanes at once.  Per step k
(``back_pass.c:80-241``)::

    Qu  = cu + fu^T Vx
    Qx  = cx + fx^T Vx
    Qxu = cxu + fx^T Vxx fu   (+ Vx . fxu   with FULL_DDP)
    Quu = cuu + fu^T Vxx fu   (+ Vx . fuu)
    Qxx = cxx + fx^T Vxx fx   (+ Vx . fxx)

regularization (``back_pass.c:133-159``)::

    regType 1: QuuF = Quu + lambda*I
    regType 2: QuuF = Quu + lambda*fu^T fu ; Qxu_reg = Qxu + lambda*fx^T fu

the feedforward ``l`` from boxQP on ``(QuuF, Qu)`` warm-started from step
k+1 (zero at the last step, ``back_pass.c:163-171``), and the feedback with
clamped rows following the state-dependent bound (``back_pass.c:175-201``)::

    L = -invH_free (Qxu_reg^T - QuuF D) - D,   D[j] = sign_j hx_j if clamped

The value update uses the UNregularized Quu/Qxu (``back_pass.c:217-241``),
``dV += [l^T Qu, 0.5 l^T Quu l]`` and ``g_norm = g_sum / (N-1)``
(``back_pass.c:244-254``).  A lane whose boxQP fails (res < 1) at a step
fails the whole pass: from that step on its outputs are zero and its carry
freezes.  The small products and sums run in index order
(``ops/small.py``): the card computes the CPU's numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .boxqp import BoxQPHyper, BoxQPResult, boxqp
from .small import dot, mm, mv, tv

Tensor = torch.Tensor


class BackPassResult(NamedTuple):
    l: Tensor  # (B, N, n_u) feedforward
    L: Tensor  # (B, N, n_u, n_x) feedback
    dV: Tensor  # (B, 2) expected-reduction coefficients
    g_norm: Tensor  # (B,)
    failed: Tensor  # (B,) bool (any boxQP res < 1)


class StepTerms(NamedTuple):
    """Every intermediate of one step of the recursion, batched over lanes
    (the reference's ``DEBUG_BACKPASS`` dump, ``back_pass.c:26-36``)."""

    Qx: Tensor  # (B, n_x)
    Qu: Tensor  # (B, n_u)
    Qxx: Tensor  # (B, n_x, n_x)
    Quu: Tensor  # (B, n_u, n_u)
    Qxu: Tensor  # (B, n_x, n_u)
    QuuF: Tensor  # (B, n_u, n_u) regularized
    Qxu_reg: Tensor
    qp: BoxQPResult
    l: Tensor  # (B, n_u)
    L: Tensor  # (B, n_u, n_x)
    acc: Tensor  # (B, 3): this step's dV[0], dV[1] and g terms
    Vx: Tensor  # (B, n_x) the value update, V_k
    Vxx: Tensor  # (B, n_x, n_x)


def backpass_step(sd, k: int, Vx: Tensor, Vxx: Tensor, l_init: Tensor,
                  lam: Tensor, u_k: Tensor, reg_type: int, full_ddp: bool,
                  hyper: BoxQPHyper, eye_u: Tensor) -> StepTerms:
    """Step ``k`` of every lane from ``V_{k+1}`` (``Vx``, ``Vxx``), with
    the boxQP warm-started at ``l_init`` (``back_pass.c:80-241``);
    ``eye_u`` is the ``(n_u, n_u)`` identity, made once per pass."""
    lam3 = lam[:, None, None]
    fx, fu = sd.fx[:, k], sd.fu[:, k]
    fxT, fuT = fx.mT, fu.mT
    Qu = sd.cu[:, k] + mv(fuT, Vx)
    Qx = sd.cx[:, k] + mv(fxT, Vx)
    fxT_V = mm(fxT, Vxx)
    fuT_V = mm(fuT, Vxx)
    Qxu = sd.cxu[:, k] + mm(fxT_V, fu)
    Quu = sd.cuu[:, k] + mm(fuT_V, fu)
    Qxx = sd.cxx[:, k] + mm(fxT_V, fx)
    if full_ddp:
        # Vx . f**: contract over the dynamics output (back_pass.c:95-131)
        Qxu = Qxu + tv(Vx, sd.fxu[:, k])
        Quu = Quu + tv(Vx, sd.fuu[:, k])
        Qxx = Qxx + tv(Vx, sd.fxx[:, k])
    if reg_type == 2:
        QuuF = Quu + mm(lam3 * fuT, fu)
        Qxu_reg = Qxu + mm(lam3 * fxT, fu)
    else:
        QuuF = Quu + lam3 * eye_u
        Qxu_reg = Qxu

    qp = boxqp(QuuF, Qu, sd.lower[:, k], sd.upper[:, k], l_init, hyper)

    # Clamped-input constraint-boundary direction D (back_pass.c:193-199)
    cl = qp.clamped[..., None]
    D = torch.where(
        cl == 1, sd.lower_sign[:, k, :, None] * sd.lower_hx[:, k],
        torch.where(cl == 2, sd.upper_sign[:, k, :, None]
                    * sd.upper_hx[:, k], 0.0))
    L_k = mm(-qp.inv_h_free, Qxu_reg.mT - mm(QuuF, D)) - D
    l_k = qp.x
    Quu_l = mv(Quu, l_k)
    g_k = (torch.abs(l_k) / (torch.abs(u_k) + 1.0)).amax(-1)
    acc_k = torch.stack([dot(l_k, Qu), dot(0.5 * l_k, Quu_l), g_k], -1)

    # Value-function update with the unregularized Quu/Qxu
    # (back_pass.c:217-241)
    LT = L_k.mT
    Vx_new = Qx + mv(LT, Quu_l) + mv(LT, Qu) + mv(Qxu, l_k)
    Vxx_new = (Qxx + mm(mm(LT, Quu), L_k) + mm(LT, Qxu.mT)
               + mm(Qxu, L_k))
    Vxx_new = 0.5 * (Vxx_new + Vxx_new.mT)
    return StepTerms(Qx=Qx, Qu=Qu, Qxx=Qxx, Quu=Quu, Qxu=Qxu, QuuF=QuuF,
                     Qxu_reg=Qxu_reg, qp=qp, l=l_k, L=L_k, acc=acc_k,
                     Vx=Vx_new, Vxx=Vxx_new)


def back_pass(derivs, us: Tensor, lam: Tensor, reg_type: int,
              full_ddp: bool, hyper: BoxQPHyper = BoxQPHyper()
              ) -> BackPassResult:
    """One backward-pass attempt of every lane: ``derivs`` a batched
    ``DerivBundle`` (``(B, N, ...)`` step fields, ``(B, ...)`` final
    fields), ``us (B, N, n_u)`` and ``lam (B,)``."""
    sd = derivs.step
    B, N, n_u = us.shape
    dtype, dev = us.dtype, us.device
    eye_u = torch.eye(n_u, dtype=dtype, device=dev)

    Vx, Vxx = derivs.final.cx, derivs.final.cxx
    l_next = torch.zeros((B, n_u), dtype=dtype, device=dev)
    acc = torch.zeros((B, 3), dtype=dtype, device=dev)  # dV[0], dV[1], g
    failed = torch.zeros((B,), dtype=torch.bool, device=dev)
    ls, Ls, dead_at = [], [], []
    for k in range(N - 1, -1, -1):
        # boxQP warm start: zero at the last step, else l from step k+1
        # (back_pass.c:163-166)
        l_init = torch.zeros_like(l_next) if k == N - 1 else l_next
        st = backpass_step(sd, k, Vx, Vxx, l_init, lam, us[:, k], reg_type,
                           full_ddp, hyper, eye_u)
        # After a failure (boxQP res < 1) the lane's state freezes (its
        # results are discarded by the caller; this keeps NaNs out of the
        # recursion).
        failed = failed | (st.qp.res < 1)
        d1 = failed[:, None]
        Vx = torch.where(d1, Vx, st.Vx)
        Vxx = torch.where(d1[..., None], Vxx, st.Vxx)
        l_next = torch.where(d1, l_next, st.l)
        acc = torch.where(d1, acc, acc + st.acc)
        ls.append(st.l)
        Ls.append(st.L)
        dead_at.append(failed)
    dead = torch.stack(dead_at[::-1], 1)  # (B, N)
    l_out = torch.where(dead[..., None], 0.0, torch.stack(ls[::-1], 1))
    L_out = torch.where(dead[..., None, None], 0.0, torch.stack(Ls[::-1], 1))
    return BackPassResult(l=l_out, L=L_out, dV=acc[:, :2],
                          g_norm=acc[:, 2] / float(N - 1), failed=failed)
