"""Model-inspection API: every symbolic quantity as a callable
(``ddp_generator_tpu.inspect_api``).

The counterpart of the reference's generated ``iLQG<P>MMex`` inspection
MEX (template ``iLQG_MMex.tem``): a per-problem table exposing f, L, F and
all twelve derivative objects individually, plus ``clampU``, through a
mode switch (``iLQG_MMex.tem:81-226``):

====  ==========  ====================================
mode  name        here
====  ==========  ====================================
0     f           ``ProblemInspector.f(x, u, p, k)``
1     L           ``.L(x, u, p, k)``
2     F           ``.F(x, p, k)``
3     Fx          ``.Fx(x, p, k)``
4     Fxx         ``.Fxx(x, p, k)``
5     Lx          ``.Lx(x, u, p, k)``
6     Lu          ``.Lu(x, u, p, k)``
7     Lxx         ``.Lxx(x, u, p, k)``
8     Luu         ``.Luu(x, u, p, k)``
9     Lxu         ``.Lxu(x, u, p, k)``
10    fx          ``.fx(x, u, p, k)``
11    fu          ``.fu(x, u, p, k)``
12    fxx         ``.fxx(x, u, p, k)``
13    fuu         ``.fuu(x, u, p, k)``
14    fxu         ``.fxu(x, u, p, k)``
15    y           (empty in reference; omitted)
16    clamped u   ``.clamp_u(x, u, p, k)``
====  ==========  ====================================

The derivatives come from ``torch.func`` (``jacfwd``, ``grad``) on the
problem's functions at one point: ``x (n_x,)``, ``u (n_u,)``, an integer
step ``k``.  The ``al_*`` variants expose the AL-augmented costs (what the
reference's MMex contains, since its generator folds the penalties into
L/F); the plain ``L``/``F`` are the user's.  Matrices are full, as in MMex
(``iLQG_MMex.tem:14``).  Each callable computes on the device and in the
dtype of its ``x`` (a tensor; other inputs become float64 tensors on the
CPU), with ``p`` (numbers, arrays or tensors) cast alike.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.func import grad, jacfwd

from . import problem as problem_mod
from .al import augmented_F, augmented_L
from .convert import to_torch
from .problem import Problem

_MODE_NAMES = {
    0: "f", 1: "L", 2: "F", 3: "Fx", 4: "Fxx", 5: "Lx", 6: "Lu", 7: "Lxx",
    8: "Luu", 9: "Lxu", 10: "fx", 11: "fu", 12: "fxx", 13: "fuu", 14: "fxu",
    16: "clamp_u",
}


def _point(fn, n_state: int):
    """``fn(*states, p, k, *rest)`` with the states and ``rest`` as tensors
    on the device and dtype of the first state, and ``p`` cast alike."""
    def call(*args):
        x = args[0]
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.array(x, dtype=np.float64))
        dtype, device = x.dtype, x.device

        def t(v):
            if not isinstance(v, torch.Tensor):
                v = np.array(v)
            return torch.as_tensor(v, dtype=dtype, device=device)

        states = [x] + [t(a) for a in args[1:n_state]]
        p = to_torch(dict(args[n_state]), dtype, device)
        k = args[n_state + 1]
        return fn(*states, p, k, *(t(a) for a in args[n_state + 2:]))
    return call


class ProblemInspector:
    """Inspection callables for one problem (MMex equivalent)."""

    def __init__(self, problem: Problem):
        self.problem = problem
        pf, pL, pF = problem.f, problem.L, problem.F

        def xu(fn):  # (x, u, p, k, ...) -> fn
            return _point(fn, 2)

        def xf(fn):  # (x, p, k, ...) -> fn
            return _point(fn, 1)

        self.f = xu(pf)
        self.L = xu(pL)
        self.F = xf(pF)
        self.fx = xu(jacfwd(pf, argnums=0))
        self.fu = xu(jacfwd(pf, argnums=1))
        self.fxx = xu(jacfwd(jacfwd(pf, argnums=0), argnums=0))
        self.fuu = xu(jacfwd(jacfwd(pf, argnums=1), argnums=1))
        self.fxu = xu(jacfwd(jacfwd(pf, argnums=0), argnums=1))
        self.Lx = xu(grad(pL, argnums=0))
        self.Lu = xu(grad(pL, argnums=1))
        self.Lxx = xu(jacfwd(grad(pL, argnums=0), argnums=0))
        self.Luu = xu(jacfwd(grad(pL, argnums=1), argnums=1))
        self.Lxu = xu(jacfwd(grad(pL, argnums=0), argnums=1))
        self.Fx = xf(grad(pF, argnums=0))
        self.Fxx = xf(jacfwd(grad(pF, argnums=0), argnums=0))
        self.clamp_u = xu(functools.partial(problem_mod.clamp_u, problem))
        self.limits_u = xu(functools.partial(problem_mod.limits_u, problem))

        # AL-augmented costs: (x, u, p, k, mu_le, mu_li, w_pen_l) and
        # (x, p, k, mu_fe, mu_fi, w_pen_f), as in the JAX package
        aL = functools.partial(augmented_L, problem)
        aF = functools.partial(augmented_F, problem)
        self.al_L = xu(aL)
        self.al_F = xf(aF)
        self.al_Lx = xu(grad(aL, argnums=0))
        self.al_Lu = xu(grad(aL, argnums=1))
        self.al_Fx = xf(grad(aF, argnums=0))

    def by_mode(self, mode: int):
        """Callable for an MMex mode number (``iLQG_MMex.tem:81-226``)."""
        try:
            return getattr(self, _MODE_NAMES[mode])
        except KeyError:
            raise ValueError(f"unsupported MMex mode {mode}") from None


def inspect(problem: Problem) -> ProblemInspector:
    return ProblemInspector(problem)
