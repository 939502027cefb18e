"""Per-step numeric inspection of the backward pass
(``ddp_generator_tpu.debugging``).

The reference's ``DEBUG_BACKPASS`` / ``DEBUG_BOXQP`` compile flags
(``back_pass.c:26-36``, ``boxQP.c:25-35``) printf every intermediate (Qx,
Qu, Qxx, Quu, Qxu, the regularized QuuF, the QP result, gains, Vx, Vxx) at
every step.  Here :func:`backpass_trace` reruns one lane's backward pass
outside the solver loop and returns every intermediate stacked over the
steps, and :func:`format_backpass_step` prints one step the reference's
way.  The steps are those of the serial pass (``ops/backpass.py:
backpass_step``, the same boxQP and index-order sums), so ``l`` and ``L``
equal :func:`~.ops.backpass.back_pass`'s on that lane, up to a failed
boxQP: the serial pass freezes a lane from its first failed step on, the
trace runs on.

Typical post-mortem for a failing lane ``b`` of a batched solve::

    tr = backpass_trace(problem, options, sol.xs[b], sol.us[b], sol.lam[b],
                        params, device="cpu")
    print(format_backpass_step(tr, k))
    bad = (tr.res < 1).nonzero()        # steps whose boxQP failed
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .al import Multipliers, init_multipliers
from .convert import to_torch
from .derivs import batched_calc_derivs
from .ops.backpass import backpass_step
from .options import SolverOptions
from .problem import Problem
from .solver import _DTYPES, _boxqp_hyper
from .utils.debug import format_mat, format_vec

Tensor = torch.Tensor


class BackPassTrace(NamedTuple):
    """All per-step intermediates of one backward pass, stacked over k
    (leading dim N; the recursion runs k = N-1 .. 0)."""

    Qx: Tensor    # (N, n_x)
    Qu: Tensor    # (N, n_u)
    Qxx: Tensor   # (N, n_x, n_x)
    Quu: Tensor   # (N, n_u, n_u)
    Qxu: Tensor   # (N, n_x, n_u)
    QuuF: Tensor  # (N, n_u, n_u) regularized (back_pass.c:133-159)
    Qxu_reg: Tensor
    lower: Tensor  # (N, n_u) boxQP bounds (relative to nominal u)
    upper: Tensor
    l: Tensor     # (N, n_u) feedforward
    L: Tensor     # (N, n_u, n_x) feedback
    res: Tensor   # (N,) boxQP result code (boxQP.c result taxonomy)
    clamped: Tensor  # (N, n_u) 0 free / 1 at lower / 2 at upper
    Vx: Tensor    # (N, n_x) cost-to-go gradient ENTERING step k (V_{k+1})
    Vxx: Tensor   # (N, n_x, n_x)
    dV: Tensor    # (N, 2) per-step expected-reduction contributions
    g: Tensor     # (N,) per-step gradient-norm contributions


def backpass_trace(problem: Problem, options: SolverOptions, xs, us, lam,
                   params: Any, mult: Multipliers | None = None,
                   w_pen_l=None, w_pen_f=None, *, device) -> BackPassTrace:
    """Rerun one lane's backward pass at the nominal ``xs (N+1, n_x)``,
    ``us (N, n_u)`` with regularization ``lam``, returning every
    intermediate per step, on ``device`` in ``options.dtype``.  ``mult``
    (one lane's multipliers, ``mu_le (N, n_hle)`` ...) defaults to fresh
    ones and the penalty weights to the options' initial ones (their
    values do not matter for unconstrained problems)."""
    o = options
    dtype = _DTYPES[o.dtype]
    device = torch.device(device)

    def t(v):
        if not isinstance(v, Tensor):
            v = np.array(v)  # a copy: read-only arrays (JAX's) are fine
        return torch.as_tensor(v, dtype=dtype, device=device)

    xs, us = t(xs), t(us)
    N, n_u = us.shape
    p = to_torch(dict(params), dtype, device)
    if mult is None:
        mult = init_multipliers(problem, 1, N, dtype, device)
    else:
        mult = Multipliers(*(t(m)[None] for m in mult))
    w_l = t(o.w_pen_init_l if w_pen_l is None else w_pen_l).reshape(1)
    w_f = t(o.w_pen_init_f if w_pen_f is None else w_pen_f).reshape(1)
    d = batched_calc_derivs(problem, xs[None], us[None], p, mult.mu_le,
                            mult.mu_li, mult.mu_fe, mult.mu_fi, w_l, w_f,
                            o.full_ddp)
    sd, hyper, lam1 = d.step, _boxqp_hyper(o), t(lam).reshape(1)
    Vx, Vxx = d.final.cx, d.final.cxx
    l_next = torch.zeros((1, n_u), dtype=dtype, device=device)
    eye_u = torch.eye(n_u, dtype=dtype, device=device)
    steps = []
    for k in range(N - 1, -1, -1):
        st = backpass_step(sd, k, Vx, Vxx, l_next, lam1, us[None, k],
                           o.regType, o.full_ddp, hyper, eye_u)
        steps.append(BackPassTrace(
            Qx=st.Qx, Qu=st.Qu, Qxx=st.Qxx, Quu=st.Quu, Qxu=st.Qxu,
            QuuF=st.QuuF, Qxu_reg=st.Qxu_reg, lower=sd.lower[:, k],
            upper=sd.upper[:, k], l=st.l, L=st.L, res=st.qp.res,
            clamped=st.qp.clamped, Vx=Vx, Vxx=Vxx, dV=st.acc[:, :2],
            g=st.acc[:, 2]))
        Vx, Vxx, l_next = st.Vx, st.Vxx, st.l
    return BackPassTrace(*(torch.cat(f[::-1]) for f in zip(*steps)))


def format_backpass_step(tr: BackPassTrace, k: int) -> str:
    """DEBUG_BACKPASS-style dump of step k (``back_pass.c:26-36``)."""
    clamp_names = {0: "free", 1: "lower", 2: "upper"}
    clamped = [clamp_names[int(c)] for c in tr.clamped[k].tolist()]
    lines = [
        f"== back_pass step k={k} ==",
        format_vec(tr.Vx[k], "Vx(k+1)"),
        format_mat(tr.Vxx[k], "Vxx(k+1)"),
        format_vec(tr.Qx[k], "Qx"),
        format_vec(tr.Qu[k], "Qu"),
        format_mat(tr.Qxx[k], "Qxx"),
        format_mat(tr.Quu[k], "Quu"),
        format_mat(tr.Qxu[k], "Qxu"),
        format_mat(tr.QuuF[k], "QuuF (regularized)"),
        format_vec(tr.lower[k], "boxQP lower"),
        format_vec(tr.upper[k], "boxQP upper"),
        f"boxQP res= {int(tr.res[k])}  clamped= {clamped}",
        format_vec(tr.l[k], "l"),
        format_mat(tr.L[k], "L"),
        format_vec(tr.dV[k], "dV contribution"),
        f"g contribution= {float(tr.g[k]):.6g}",
    ]
    return "\n".join(lines)
