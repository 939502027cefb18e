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

Per-lane parameters (``batch_params=True``) reach the functions as a
:class:`LaneParams` dict whose leaves are lanes-last, ``(*leaf_shape, B)``:
``p["cu"][0]`` is then a ``(B,)`` tensor that broadcasts against the lane
axis of ``x[0]`` exactly as the shared 0-d value does.  On the ``(N, B)``
plane the step ``k`` is an ``(N, 1)`` tensor in both layouts
(:func:`step_index`); indexing a per-lane leaf with it, ``p["ymin"][k]``,
gives ``(N, B)``, as the shared ``(N + 1,)`` leaf gives ``(N, 1)``.  The
kernels read per-lane params as one lane-major matrix, each row a lane's
flat parameter array (:meth:`CudaModel.flat_params`), which a solver makes
once and carries beside the leaves (:attr:`LaneParams.rows`).

A problem may name the hand-written CUDA model that mirrors its functions
(:class:`CudaModel`): the kernels cannot trace Python, so on a CUDA device
they run the model's ``__device__`` functions instead.  A problem that
names none gets a model generated from its functions (``codegen.py``); a
problem restored from an AOT artifact (``aot.py``) carries the generated
model it was exported with.

The input-box analysis (:func:`analyze_box_constraints`) probes each ``h``
constraint numerically, as the JAX package does, unless ``box_meta``
declares its ``(u_index, sign)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
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


class LaneParams(dict):
    """Per-lane parameters: every leaf lanes-last, ``(*leaf_shape, B)``
    (the solver casts the JAX convention's batch-major ``(B, *leaf_shape)``
    leaves once, :func:`lanes_last`).

    ``rows``: the same params as the kernels read them, the lane-major
    ``(B, P)`` matrix of the problem's CUDA model
    (:meth:`CudaModel.flat_params`), where a solver made it (None: a kernel
    launch makes it from the leaves).  Whoever changes the leaves in place
    changes ``rows`` with them; :meth:`take` and the solver's copies carry
    it along."""

    rows: Optional[Tensor] = None

    def take(self, idx: Tensor) -> "LaneParams":
        """The lanes ``idx`` of every leaf (a working set, or the alpha-major
        replication of the line search), and of ``rows``."""
        out = LaneParams({k: v[..., idx] for k, v in self.items()})
        if self.rows is not None:
            out.rows = self.rows[idx]
        return out


def lanes_last(params: dict, B: int) -> LaneParams:
    """Batch-major leaves ``(B, *leaf_shape)`` -> :class:`LaneParams`."""
    out = LaneParams()
    for key, v in params.items():
        if v.dim() == 0 or v.shape[0] != B:
            raise ValueError(
                f"batch_params=True: param {key!r} has shape "
                f"{tuple(v.shape)}; every leaf needs a leading lane axis of "
                f"{B}")
        out[key] = v.movedim(0, -1).contiguous()
    return out


class _StepIndex(Tensor):
    """``k`` on the ``(N, B)`` plane for :class:`LaneParams`: ``(N, 1)`` in
    arithmetic, but an index into a lanes-last leaf takes the step axis
    alone, so ``ymin[k]`` is ``(N, B)`` and not ``(N, 1, B)``."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is Tensor.__getitem__ and not isinstance(args[0], cls):
            leaf, idx = args
            idx = tuple(i.as_subclass(Tensor)[:, 0] if isinstance(i, cls)
                        else i
                        for i in (idx if isinstance(idx, tuple) else (idx,)))
            return leaf[idx]
        with torch._C.DisableTorchFunctionSubclass():
            return func(*args, **(kwargs or {}))


def step_index(p, N: int, device) -> Tensor:
    """The step ``k (N, 1)`` of the ``(N, B)`` plane for params ``p``."""
    k = torch.arange(N, device=device)[:, None]
    return k.as_subclass(_StepIndex) if isinstance(p, LaneParams) else k


#: Length of a ``[k]``-indexed parameter in :attr:`CudaModel.param_order`:
#: one entry per time step and the final one, ``N + 1``, known at call time.
PER_STEP = "N+1"


@dataclasses.dataclass(frozen=True)
class CudaModel:
    """The CUDA model a problem binds to (``csrc/models/<name>.cuh``).

    ``param_order`` lists ``(params key, length)`` in the order of the flat
    parameter array the model's ``__device__`` functions read.  The last
    entry may have length :data:`PER_STEP`: the model reads it at a fixed
    offset plus the step ``k``."""

    name: str
    param_order: tuple[tuple[str, int | str], ...]

    def __post_init__(self):
        lengths = [n for _, n in self.param_order]
        if PER_STEP in lengths[:-1]:
            raise ProblemValidationError(
                f"CUDA model {self.name}: only the last parameter may have "
                f"length {PER_STEP!r}")

    @property
    def n_params(self) -> int:
        """Entries before a :data:`PER_STEP` tail."""
        return sum(n for _, n in self.param_order if n != PER_STEP)

    def flat_params(self, p: dict, dtype: torch.dtype,
                    device: torch.device, N: Optional[int] = None) -> Tensor:
        """The flat parameter array for a horizon of ``N`` steps (``N`` is
        needed only by a :data:`PER_STEP` entry); for :class:`LaneParams`
        the lane-major ``(B, P)`` matrix whose row ``b`` is lane ``b``'s."""
        lanes = lane_count(p)
        parts = []
        for key, n in self.param_order:
            if n == PER_STEP and N is None:
                raise ValueError(f"CUDA model {self.name}: param {key!r} "
                                 "has one entry per step; pass N")
            want = N + 1 if n == PER_STEP else n
            v = torch.as_tensor(p[key], dtype=dtype, device=device)
            v = v.reshape(-1) if lanes is None else v.reshape(-1, lanes).T
            if v.shape[-1] != want:
                raise ProblemValidationError(
                    f"CUDA model {self.name}: param {key!r} has "
                    f"{v.shape[-1]} entries{'' if lanes is None else ' a lane'}"
                    f", the model reads {want}"
                )
            parts.append(v)
        return torch.cat(parts, -1).contiguous()


def lane_count(p) -> Optional[int]:
    """The lanes of per-lane params (:class:`LaneParams`), None for shared
    ones (or per-lane ones without a leaf)."""
    if not isinstance(p, LaneParams) or not p:
        return None
    return next(iter(p.values())).shape[-1]


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


def analyze_box_constraints(
    n_x: int,
    n_u: int,
    h: Sequence[Callable],
    params: Any,
    n_probe: int = 3,
    seed: int = 0,
) -> tuple[BoxConstraint, ...]:
    """Validate and classify the input constraints ``h``
    (``ddp_generator_tpu/problem.py:analyze_box_constraints``).

    Numerical counterpart of the symbolic checks at
    ``genenerator_main.mac:385-395``: for each ``h_i`` the gradient w.r.t.
    ``u`` must be one-hot with value +-1, constant in ``(x, u)``, probed at
    ``n_probe`` random points (the JAX package's draws, seed and
    tolerances), in float64 on the CPU with ``torch.func.grad`` under
    ``vmap``."""
    rng = np.random.default_rng(seed)
    p = {} if params is None else {
        key: torch.as_tensor(np.asarray(
            v.detach().cpu() if isinstance(v, Tensor) else v),
            dtype=torch.float64) for key, v in params.items()}
    k = torch.zeros((), dtype=torch.int64)
    out = []
    for ci, fn in enumerate(h):
        xs = torch.as_tensor(rng.normal(size=(n_probe, n_x)))
        us = torch.as_tensor(rng.normal(size=(n_probe, n_u)))

        def gu_fn(x, u, fn=fn):
            return torch.func.grad(lambda u_: fn(x, u_, p, k))(u)

        try:
            gus = torch.func.vmap(gu_fn)(xs, us).detach().numpy()
        except (KeyError, TypeError, IndexError) as err:  # params missing
            raise ProblemValidationError(
                f"constraint h[{ci}] could not be probed ({err!r}): pass "
                "example_params, or declare box_meta=[(u_index, sign), ...]"
            ) from err
        grads = list(gus.astype(np.float64))
        g0 = grads[0]
        for g in grads[1:]:
            if not np.allclose(g, g0, atol=1e-9, rtol=1e-9):
                raise ProblemValidationError(
                    f"constraint h[{ci}] must depend linearly on a single "
                    "input with constant coefficient (got varying "
                    f"du-gradient {g} vs {g0}); "
                    "cf. genenerator_main.mac:385-395"
                )
        nz = np.nonzero(np.abs(g0) > 1e-12)[0]
        if len(nz) != 1:
            raise ProblemValidationError(
                f"constraint h[{ci}] may depend on exactly one input, found "
                f"du-gradient {g0}; cf. genenerator_main.mac:390-391"
            )
        idx = int(nz[0])
        sign = float(g0[idx])
        if not np.isclose(abs(sign), 1.0, atol=1e-9):
            raise ProblemValidationError(
                f"coefficient of input in constraint h[{ci}] must be +1 or "
                f"-1, found {sign}; cf. genenerator_main.mac:393-394"
            )
        out.append(BoxConstraint(fn=fn, u_index=idx,
                                 sign=float(np.sign(sign))))
    return tuple(out)


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
    reference generator proves symbolically, ``genenerator_main.mac:385-395``);
    when it is not given, :func:`analyze_box_constraints` probes ``h`` with
    ``example_params``, as the JAX package does."""
    problem = Problem(
        n_x=n_x, n_u=n_u, f=f, L=L, F=F, h=tuple(h), hle=tuple(hle),
        hli=tuple(hli), hfe=tuple(hfe), hfi=tuple(hfi), name=name,
        cuda_model=cuda_model,
    )
    if validate and example_params is not None:
        _validate_shapes(problem, example_params)
    if box_meta is None:
        box = analyze_box_constraints(n_x, n_u, problem.h, example_params)
        return dataclasses.replace(problem, box_constraints=box)
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
