"""Problem specification (``ddp_generator_tpu.problem``).

A problem is a frozen dataclass of torch functions:

* ``f(x, u, p, k) -> x_next``       (dynamics)
* ``L(x, u, p, k) -> scalar``       (running cost)
* ``F(x, p, k) -> scalar``          (final cost, ``k = N``)
* ``h``: input-box constraints ``h_i(x, u, p, k) < 0``
* ``hle/hli``: running equality / inequality constraints
* ``hfe/hfi``: final equality / inequality constraints ``(x, p, k)``

Every function is **component-first**: ``x`` has shape ``(n_x, *batch)``
and ``u`` ``(n_u, *batch)``, so ``x[0]`` is a lane tensor of shape
``batch`` and ``f`` returns ``torch.stack([...])`` of shape
``(n_x, *batch)``.  The same function then serves one point
(``batch == ()``, under ``torch.func.vmap``), a lane vector and the
``(N, B)`` plane of a whole batched trajectory.  ``p`` is a dict of tensors
(:func:`convert.params_from_jax`).

A problem may name the hand-written CUDA model that mirrors its functions
(:class:`CudaModel`): the rollout kernel cannot trace Python, so on a CUDA
device it runs the model's ``__device__`` functions instead.

The input-box analysis takes the declared ``box_meta`` ``(u_index, sign)``
per ``h`` constraint; the numeric +-1 probing of the JAX package is not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch

Tensor = torch.Tensor


class ProblemValidationError(ValueError):
    """Raised when a problem definition violates the reference's rules
    (``genenerator_main.mac:1-27,385-395``)."""


@dataclasses.dataclass(frozen=True)
class BoxConstraint:
    """Analyzed input constraint ``h_i = sign * u[u_index] + rest(x, p, k) < 0``:
    an upper bound on ``u[u_index]`` when ``sign > 0``, a lower bound when
    ``sign < 0`` (``genenerator_main.mac:385-437``)."""

    fn: Callable
    u_index: int
    sign: float  # +1.0 => upper bound on u[u_index]; -1.0 => lower bound


@dataclasses.dataclass(frozen=True)
class CudaModel:
    """The CUDA model a problem binds to (``csrc/models/<name>.cuh``).

    ``param_order`` lists ``(params key, length)`` in the order of the flat
    parameter array the model's ``__device__`` functions read."""

    name: str
    param_order: tuple[tuple[str, int], ...]

    @property
    def n_params(self) -> int:
        return sum(n for _, n in self.param_order)

    def flat_params(self, p: dict, dtype: torch.dtype,
                    device: torch.device) -> Tensor:
        parts = []
        for key, n in self.param_order:
            v = torch.as_tensor(p[key], dtype=dtype, device=device).reshape(-1)
            if v.numel() != n:
                raise ProblemValidationError(
                    f"CUDA model {self.name}: param {key!r} has {v.numel()} "
                    f"entries, the model reads {n}"
                )
            parts.append(v)
        return torch.cat(parts).contiguous()


@dataclasses.dataclass(frozen=True)
class Problem:
    """An optimal-control problem in the reference's capability set."""

    n_x: int
    n_u: int
    f: Callable
    L: Callable
    F: Callable
    h: tuple = ()
    hle: tuple = ()
    hli: tuple = ()
    hfe: tuple = ()
    hfi: tuple = ()
    name: str = "problem"
    box_constraints: tuple[BoxConstraint, ...] = ()
    cuda_model: Optional[CudaModel] = None

    @property
    def n_h(self) -> int:
        return len(self.h)

    @property
    def n_hle(self) -> int:
        return len(self.hle)

    @property
    def n_hli(self) -> int:
        return len(self.hli)

    @property
    def n_hfe(self) -> int:
        return len(self.hfe)

    @property
    def n_hfi(self) -> int:
        return len(self.hfi)


def _validate_shapes(problem: Problem, params: Any) -> None:
    """Evaluate every function once at a point (``genenerator_main.mac:1-27``)."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(problem.n_x, generator=gen, dtype=torch.float64)
    u = torch.randn(problem.n_u, generator=gen, dtype=torch.float64)
    p = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in params.items()}
    k = torch.zeros((), dtype=torch.int64)
    fx = problem.f(x, u, p, k)
    if tuple(fx.shape) != (problem.n_x,):
        raise ProblemValidationError(
            f"f must map to {problem.n_x} states; got shape {tuple(fx.shape)}"
        )
    checks = [("L", problem.L, (x, u, p, k)), ("F", problem.F, (x, p, k))]
    for family in ("h", "hle", "hli"):
        checks += [(f"{family}[{i}]", fn, (x, u, p, k))
                   for i, fn in enumerate(getattr(problem, family))]
    for family in ("hfe", "hfi"):
        checks += [(f"{family}[{i}]", fn, (x, p, k))
                   for i, fn in enumerate(getattr(problem, family))]
    for nm, fn, args in checks:
        s = torch.as_tensor(fn(*args)).shape
        if tuple(s) != ():
            raise ProblemValidationError(
                f"{nm} must be a scalar; got shape {tuple(s)}"
            )


def make_problem(
    n_x: int,
    n_u: int,
    f: Callable,
    L: Callable,
    F: Callable,
    h: Sequence[Callable] = (),
    hle: Sequence[Callable] = (),
    hli: Sequence[Callable] = (),
    hfe: Sequence[Callable] = (),
    hfi: Sequence[Callable] = (),
    name: str = "problem",
    example_params: Any = None,
    validate: bool = True,
    box_meta: Optional[Sequence[tuple[int, float]]] = None,
    cuda_model: Optional[CudaModel] = None,
) -> Problem:
    """Build and validate a :class:`Problem`.

    ``box_meta`` declares ``(u_index, sign)`` per ``h`` constraint (what the
    reference generator proves symbolically, ``genenerator_main.mac:385-395``)
    and is required whenever ``h`` is not empty."""
    problem = Problem(
        n_x=n_x, n_u=n_u, f=f, L=L, F=F, h=tuple(h), hle=tuple(hle),
        hli=tuple(hli), hfe=tuple(hfe), hfi=tuple(hfi), name=name,
        cuda_model=cuda_model,
    )
    if validate and example_params is not None:
        _validate_shapes(problem, example_params)
    if box_meta is None:
        if problem.h:
            raise NotImplementedError(
                "the numeric +-1 box analysis is not ported yet: declare "
                "box_meta=[(u_index, sign), ...] for every h constraint"
            )
        box_meta = ()
    if len(box_meta) != len(problem.h):
        raise ProblemValidationError(
            f"box_meta has {len(box_meta)} entries for {len(problem.h)} "
            "h constraints"
        )
    for idx, sign in box_meta:
        if not 0 <= int(idx) < n_u or abs(float(sign)) != 1.0:
            raise ProblemValidationError(
                f"box_meta entry {(idx, sign)}: u_index must be in "
                f"[0, {n_u}) and sign +-1 (genenerator_main.mac:390-394)"
            )
    box = tuple(
        BoxConstraint(fn=fn, u_index=int(idx), sign=float(sign))
        for fn, (idx, sign) in zip(problem.h, box_meta)
    )
    return dataclasses.replace(problem, box_constraints=box)


def constraint_limit(bc: BoxConstraint, x: Tensor, u: Tensor, p: Any,
                     k) -> Tensor:
    """State-dependent bound value ``-sign * (h - sign*u[idx])``
    (``genenerator_main.mac:399-437``); independent of ``u[idx]``."""
    hval = bc.fn(x, u, p, k)
    rest = hval - bc.sign * u[bc.u_index]
    return -bc.sign * rest


def clamp_u(problem: Problem, x: Tensor, u: Tensor, p: Any, k) -> Tensor:
    """Generated ``clampU`` (``iLQG_func.tem:68-73``): each constraint in
    ascending order clamps its input against its limit.  Component-first:
    ``x (n_x, *batch)``, ``u (n_u, *batch)``."""
    rows = list(u.unbind(0))
    for bc in problem.box_constraints:
        lim = constraint_limit(bc, x, u, p, k)
        cur = rows[bc.u_index]
        rows[bc.u_index] = (torch.minimum(cur, lim) if bc.sign > 0
                            else torch.maximum(cur, lim))
        u = torch.stack(rows)
    return u


def basis(n: int, j: int, like: Tensor) -> Tensor:
    """One-hot along the component axis of a component-first ``like``."""
    return torch.stack([
        torch.ones_like(like[0]) if a == j else torch.zeros_like(like[0])
        for a in range(n)
    ])


def limits_u(problem: Problem, x: Tensor, u: Tensor, p: Any, k):
    """Generated ``limitsU`` (``iLQG_func.tem:75-119``), component-first.

    Returns ``(lower, upper, lower_hx, upper_hx, lower_sign, upper_sign)``
    with shapes ``(n_u, *b)``, ``(n_u, *b)``, ``(n_u, n_x, *b)``,
    ``(n_u, n_x, *b)``, ``(n_u, *b)``, ``(n_u, *b)``; bounds are relative to
    ``u`` and +-inf where unconstrained; ``*_hx`` is ``dh/dx`` of the binding
    constraint and ``*_sign`` its +-1 input coefficient (0 if none)."""
    n_u, n_x = problem.n_u, problem.n_x
    batch = tuple(u.shape[1:])
    inf = torch.full(batch, float("inf"), dtype=u.dtype, device=u.device)
    zero = torch.zeros(batch, dtype=u.dtype, device=u.device)
    lower = [-inf for _ in range(n_u)]
    upper = [inf for _ in range(n_u)]
    lower_hx = [[zero] * n_x for _ in range(n_u)]
    upper_hx = [[zero] * n_x for _ in range(n_u)]
    lower_sign = [zero for _ in range(n_u)]
    upper_sign = [zero for _ in range(n_u)]
    for bc in problem.box_constraints:
        lim = constraint_limit(bc, x, u, p, k)
        hx = [
            torch.func.jvp(lambda xx: bc.fn(xx, u, p, k), (x,),
                           (basis(n_x, b, x),))[1].expand(batch)
            for b in range(n_x)
        ]
        j = bc.u_index
        sgn = torch.full(batch, bc.sign, dtype=u.dtype, device=u.device)
        if bc.sign > 0:
            tighter = lim < upper[j]
            upper[j] = torch.where(tighter, lim, upper[j])
            upper_sign[j] = torch.where(tighter, sgn, upper_sign[j])
            upper_hx[j] = [torch.where(tighter, hx[b], upper_hx[j][b])
                           for b in range(n_x)]
        else:
            tighter = lim > lower[j]
            lower[j] = torch.where(tighter, lim, lower[j])
            lower_sign[j] = torch.where(tighter, sgn, lower_sign[j])
            lower_hx[j] = [torch.where(tighter, hx[b], lower_hx[j][b])
                           for b in range(n_x)]
    # Bounds relative to the current u (iLQG_func.tem:91-94).
    lower = torch.stack(lower) - u
    upper = torch.stack(upper) - u
    return (lower, upper,
            torch.stack([torch.stack(r) for r in lower_hx]),
            torch.stack([torch.stack(r) for r in upper_hx]),
            torch.stack(lower_sign), torch.stack(upper_sign))
