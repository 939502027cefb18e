"""Generate a problem's CUDA model from its torch functions.

The JAX package runs any problem on its kernel paths by tracing the user's
Python functions into the Pallas kernel body
(``ddp_generator_tpu/ops/pallas_math.py:pallas_safe``).  CUDA cannot trace
Python, so the port turns the functions into C++ once, the way the
reference generator emits problem-specific C for a fixed solver core:
:func:`generate_cuda_model` traces each of ``f``, ``L``, ``F``, ``h``,
``hle``, ``hli``, ``hfe`` and ``hfi`` at one point (``batch == ()``,
float64) with ``make_fx`` into an aten graph and writes every aten node as
scalar statements, ``const T tN = ...;``, in the graph's order.  The header
holds one ``struct`` with the members of the hand-written models
(``csrc/models/car_parking.cuh``): the widths, ``box_index``/``box_sign``,
and ``f``, ``L``, ``F``, ``h``, ``hle``, ``hli``, ``hfe``, ``hfi``
templated on the state type ``T`` (plain, or a dual number of
``csrc/dual.cuh`` when kernel B3 differentiates) and the parameter type
``P``.  Kernels B2 (``csrc/rollout_launch.cuh``) and B3
(``csrc/fused_launch.cuh``) take it as their model, built at first use
(``_build.build_model``).

Each traced value is a small array of C expressions, so shape ops
(``select``, ``slice``, ``stack``, ``cat``, ``view``/``reshape``,
``unsqueeze``/``squeeze``, ``expand``, ``permute``) cost nothing, and
``sum`` (in index order), ``dot``/``mv``/``mm``, elementwise arithmetic,
``where``, ``minimum``/``maximum``/``clamp`` and comparisons become scalar
statements.  Constants are cast to ``P``.  Rounding follows the plain
PyTorch version on the card: ``pow`` by 2, 3, 0.5, -0.5, -1 and -2 takes
ATen's special forms (``x*x``, ``sqrt``, ...), and a division by a Python
number is a multiplication by its reciprocal, as ATen's CUDA ``div`` does.

Parameters: the fixed leaves come first, flat in key order, then the leaves
indexed by the step (``p["ymin"][k]``) step-major, ``p[NP + k*NTAIL + j]``,
so no offset depends on the horizon.  A tensor index ``leaf[k]`` is routed
through ``index_select`` while tracing (``make_fx`` cannot trace the
``item()`` that Python indexing with a 0-d tensor takes).

What the generator rejects raises ``NotImplementedError`` naming the
function and the op: an aten op outside :data:`SUPPORTED_OPS`, a
non-scalar ``L``/``F``/``h*``, and a function whose graph differs between
two traces at different points and steps (a Python branch on values).
Nothing falls back to the plain version on the card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import operator
from typing import Any, Callable, Optional

import numpy as np
import torch

from .problem import (LaneParams, Problem, ProblemValidationError,
                      lane_count)

Tensor = torch.Tensor
aten = torch.ops.aten

#: The hand-written CUDA models (``csrc/models/hand_written.cuh``), each
#: instantiated in the main library's B2, B3 and emission kernels.
KERNEL_MODELS = ("car_parking", "cartpole", "brachistochrone",
                 "brachistochrone_hli")

#: Families of scalar functions with their argument lists, in header order.
_FAMILIES = (("h", True), ("hle", True), ("hli", True), ("hfe", False),
             ("hfi", False))


class _S:
    """One scalar of a traced value: a C expression and its kind --
    ``T`` (depends on the state or input), ``P`` (a float of parameters and
    constants), ``I`` (an int: the step), ``B`` (a bool), or ``c`` (a
    Python number, ``value``)."""

    __slots__ = ("expr", "kind", "value")

    def __init__(self, expr: str, kind: str, value=None):
        self.expr, self.kind, self.value = expr, kind, value


def _const(v) -> _S:
    return _S("", "c", v)


def _lit(v) -> str:
    """A Python number as a ``P`` literal."""
    v = float(v)
    if math.isnan(v):
        return "P(NAN)"
    if math.isinf(v):
        return "P(INFINITY)" if v > 0 else "P(-INFINITY)"
    return f"P({v!r})"


def _common_kind(*ss: _S) -> str:
    """The type two operands of a select or comparison meet in."""
    kinds = {s.kind for s in ss}
    if "T" in kinds:
        return "T"
    if "P" in kinds or any(s.kind == "c" and isinstance(s.value, float)
                           for s in ss):
        return "P"
    if "I" in kinds or any(s.kind == "c" and not isinstance(s.value, bool)
                           for s in ss):
        return "I"
    return "B"


def _as_float(s: _S) -> str:
    """``s`` as an operand of float arithmetic (a plain ``P`` or ``T``)."""
    if s.kind == "c":
        return _lit(s.value)
    if s.kind == "I":
        return f"P({s.expr})"
    if s.kind == "B":
        return f"P({s.expr} ? 1 : 0)"
    return s.expr


def _cast(s: _S, kind: str) -> str:
    """``s`` converted to the C type of ``kind``."""
    if kind == "T":
        return f"T({_as_float(s)})"
    if kind == "P":
        return _as_float(s) if s.kind in ("c", "I", "B") else f"P({s.expr})"
    if kind == "I":
        return str(int(s.value)) if s.kind == "c" else s.expr
    return ("true" if s.value else "false") if s.kind == "c" else s.expr


class _Tail:
    """A parameter leaf indexed by the step: rows of ``width`` entries at
    ``p[NP + row*NTAIL + offset]``."""

    def __init__(self, key: str, shape: tuple, offset: int, n_fixed: int,
                 n_tail: int):
        self.key, self.shape = key, shape
        self.offset, self.n_fixed, self.n_tail = offset, n_fixed, n_tail

    def row(self, r: str) -> np.ndarray:
        rest = self.shape[1:]
        width = math.prod(rest)
        out = np.empty(width, dtype=object)
        for c in range(width):
            out[c] = _S(f"p[{self.n_fixed} + ({r}) * {self.n_tail} + "
                        f"{self.offset + c}]", "P")
        return out.reshape(rest)


class _Emitter:
    """The statements of one function."""

    def __init__(self, fname: str):
        self.fname = fname
        self.lines: list[str] = []
        self.n = 0

    def fail(self, what: str):
        raise NotImplementedError(
            f"CUDA model generator: {self.fname}: {what}")

    def new(self, expr: str, kind: str) -> _S:
        ctype = {"T": "T", "P": "P", "I": "int", "B": "bool"}[kind]
        name = f"t{self.n}"
        self.n += 1
        self.lines.append(f"const {ctype} {name} = {expr};")
        return _S(name, kind)

    # -- elementwise -------------------------------------------------------

    def unary(self, a: np.ndarray, fn: Callable[[str], str]) -> np.ndarray:
        out = np.empty(a.shape, dtype=object)
        for i, s in np.ndenumerate(a):
            out[i] = self.new(fn(_as_float(s)), "T" if s.kind == "T" else "P")
        return out

    def binary(self, a, b, fn: Callable[[_S, _S], tuple[str, str]]):
        a, b = np.broadcast_arrays(_arr(a), _arr(b))
        out = np.empty(a.shape, dtype=object)
        for i in np.ndindex(a.shape):
            expr, kind = fn(a[i], b[i])
            out[i] = _const(expr) if kind == "c" else self.new(expr, kind)
        return out

    def arith(self, a, b, op: str):
        """``a op b`` elementwise; ints stay ints for ``+ - *``."""

        def fn(x: _S, y: _S):
            if x.kind == "c" and y.kind == "c":
                return {"+": operator.add, "-": operator.sub,
                        "*": operator.mul, "/": operator.truediv}[op](
                            x.value, y.value), "c"
            ints = all(s.kind == "I" or (s.kind == "c" and isinstance(
                s.value, (int, bool))) for s in (x, y))
            if ints and op != "/":
                return f"{_cast(x, 'I')} {op} {_cast(y, 'I')}", "I"
            kind = "T" if "T" in (x.kind, y.kind) else "P"
            if op == "/" and y.kind == "c":
                # ATen's CUDA div multiplies by the reciprocal of a scalar
                return (f"{_as_float(x)} * (P(1.0) / {_lit(y.value)})",
                        kind)
            return f"{_as_float(x)} {op} {_as_float(y)}", kind

        return self.binary(a, b, fn)

    def compare(self, a, b, op: str):
        def fn(x: _S, y: _S):
            kind = _common_kind(x, y)
            kind = "I" if kind == "B" else kind
            return f"{_cast(x, kind)} {op} {_cast(y, kind)}", "B"

        return self.binary(a, b, fn)

    def select2(self, c, a, b, fn: str):
        """``where`` (fn ``"?"``) or the NaN-propagating ``nan_min`` /
        ``nan_max`` of two values, both cast to their common type."""
        if fn == "?":
            c, a, b = np.broadcast_arrays(_arr(c), _arr(a), _arr(b))
            out = np.empty(a.shape, dtype=object)
            for i in np.ndindex(a.shape):
                kind = _common_kind(a[i], b[i])
                out[i] = self.new(f"{_cast(c[i], 'B')} ? {_cast(a[i], kind)}"
                                  f" : {_cast(b[i], kind)}", kind)
            return out

        def fn2(x: _S, y: _S):
            kind = _common_kind(x, y)
            return f"{fn}({_cast(x, kind)}, {_cast(y, kind)})", kind

        return self.binary(a, b, fn2)

    def reduce(self, a: np.ndarray, axes, keepdim: bool) -> np.ndarray:
        """Sum over ``axes`` in index order."""
        axes = sorted(d % a.ndim for d in axes) if a.ndim else []
        keep = [d for d in range(a.ndim) if d not in axes]
        moved = np.transpose(a, keep + axes)
        outer = moved.shape[:len(keep)]
        flat = moved.reshape(outer + (-1,))
        out = np.empty(outer, dtype=object)
        for i in np.ndindex(outer):
            terms = list(flat[i])
            acc = terms[0] if terms else _const(0.0)
            for t in terms[1:]:
                acc = self.arith(np.array(acc, dtype=object),
                                 np.array(t, dtype=object), "+")[()]
            out[i] = acc
        if keepdim:
            shape = [1 if d in axes else n for d, n in enumerate(a.shape)]
            out = out.reshape(shape)
        return out

    def matmul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """``a @ b`` for 1-D/2-D operands, each entry summed in index
        order."""
        a2 = a if a.ndim == 2 else a.reshape(1, -1)
        b2 = b if b.ndim == 2 else b.reshape(-1, 1)
        out = np.empty((a2.shape[0], b2.shape[1]), dtype=object)
        for i in range(a2.shape[0]):
            for j in range(b2.shape[1]):
                prods = self.arith(a2[i], b2[:, j], "*")
                out[i, j] = self.reduce(prods, [0], False)[()]
        shape = ((a.shape[0],) if a.ndim == 2 else ()) + (
            (b.shape[1],) if b.ndim == 2 else ())
        return out.reshape(shape)


def _arr(v) -> np.ndarray:
    if isinstance(v, np.ndarray):
        return v
    if isinstance(v, _S):
        return np.array(v, dtype=object)
    if isinstance(v, (bool, int, float)):
        out = np.empty((), dtype=object)
        out[()] = _const(v)
        return out
    raise TypeError(f"not a traced value: {v!r}")


def _pow(e: _Emitter, a: np.ndarray, c) -> np.ndarray:
    """``a ** c`` with ATen's special exponents (the plain version's
    rounding)."""
    c = float(c)
    if c == 0.0:  # ATen fills ones
        out = np.empty(a.shape, dtype=object)
        for i in np.ndindex(a.shape):
            out[i] = _const(1.0)
        return out
    if c == 1.0:
        return a
    forms = {2.0: "{0} * {0}", 3.0: "{0} * {0} * {0}", 0.5: "sqrt({0})",
             -0.5: "rsqrt_of({0})", -1.0: "P(1.0) / {0}",
             -2.0: "P(1.0) / ({0} * {0})"}
    form = forms.get(c, "pow({0}, " + _lit(c) + ")")
    return e.unary(a, form.format)


def _arg(args, kwargs, i: int, name: str, default=None):
    """An aten node's argument ``name``, passed at position ``i`` or by
    keyword."""
    return args[i] if len(args) > i else kwargs.get(name, default)


def _scaled(e: _Emitter, other, alpha):
    """``alpha * other`` as ATen's add/sub take it (``other`` for 1)."""
    return other if alpha == 1 else e.arith(_arr(other), _arr(alpha), "*")


def _clamp(e: _Emitter, a, lo, hi):
    out = _arr(a)
    if lo is not None:
        out = e.select2(None, out, lo, "nan_max")
    if hi is not None:
        out = e.select2(None, out, hi, "nan_min")
    return out


def _fill(shape, v) -> np.ndarray:
    out = np.empty(tuple(shape), dtype=object)
    for i in np.ndindex(out.shape):
        out[i] = _const(float(v))
    return out


def _to_float(e: _Emitter, a, dtype) -> np.ndarray:
    if dtype is not None and not dtype.is_floating_point:
        e.fail(f"a cast to {dtype}: only casts to a float type are "
               "supported")
    a = _arr(a)
    out = np.empty(a.shape, dtype=object)
    for i, s in np.ndenumerate(a):
        out[i] = s if s.kind in ("T", "P") else _S(_as_float(s), "P")
    return out


def _squeeze(a, dims) -> np.ndarray:
    a = _arr(a)
    dims = tuple(d % a.ndim for d in (range(a.ndim) if dims is None
                                      else dims) if a.shape[d % a.ndim] == 1)
    return a.squeeze(dims) if dims else a


def _slice(a, dim=0, start=None, end=None, step=1) -> np.ndarray:
    a = _arr(a)
    sl = [slice(None)] * a.ndim
    sl[dim] = slice(start, end, step)
    return a[tuple(sl)]


def _expand(a, size) -> np.ndarray:
    a = _arr(a)
    lead = len(size) - a.ndim
    return np.broadcast_to(a, [a.shape[d - lead] if n == -1 else n
                               for d, n in enumerate(size)])


def _sum(e: _Emitter, a, dims=None, keepdim=False) -> np.ndarray:
    a = _arr(a)
    return e.reduce(a, dims or list(range(a.ndim)), keepdim)


def _logical(e: _Emitter, a, b, op: str) -> np.ndarray:
    return e.binary(_arr(a), _arr(b), lambda x, y: (
        f"{_cast(x, 'B')} {op} {_cast(y, 'B')}", "B"))


def _not(e: _Emitter, a) -> np.ndarray:
    a = _arr(a)
    out = np.empty(a.shape, dtype=object)
    for i, s in np.ndenumerate(a):
        out[i] = e.new(f"!{_cast(s, 'B')}", "B")
    return out


def _atan2(e: _Emitter, a, b) -> np.ndarray:
    def fn(y: _S, x: _S):
        kind = "T" if "T" in (x.kind, y.kind) else "P"
        return f"atan2({_cast(y, kind)}, {_cast(x, kind)})", kind

    return e.binary(_arr(a), _arr(b), fn)


def _handlers() -> dict:
    """Each aten op the generator writes, with its emitter
    ``fn(e, args, kwargs) -> traced value``."""
    h = {}
    for op, form in ((aten.neg.default, "-{0}"),
                     (aten.reciprocal.default, "P(1.0) / {0}"),
                     (aten.sqrt.default, "sqrt({0})"),
                     (aten.rsqrt.default, "rsqrt_of({0})"),
                     (aten.exp.default, "exp({0})"),
                     (aten.log.default, "log({0})"),
                     (aten.sin.default, "sin({0})"),
                     (aten.cos.default, "cos({0})"),
                     (aten.tanh.default, "tanh({0})"),
                     (aten.asin.default, "asin({0})"),
                     (aten.acos.default, "acos({0})"),
                     (aten.atan.default, "atan({0})"),
                     (aten.abs.default, "fabs({0})")):
        h[op] = lambda e, a, k, form=form: e.unary(_arr(a[0]), form.format)
    for name, op in (("add", "+"), ("sub", "-"), ("mul", "*"), ("div", "/")):
        for ov in ("Tensor", "Scalar"):
            h[getattr(getattr(aten, name), ov)] = (
                lambda e, a, k, op=op: e.arith(_arr(a[0]), _arr(_scaled(
                    e, a[1], _arg(a, k, 2, "alpha", 1))), op))
    for ov in ("Scalar", "Tensor"):
        h[getattr(aten.rsub, ov)] = lambda e, a, k: e.arith(_arr(_scaled(
            e, a[1], _arg(a, k, 2, "alpha", 1))), _arr(a[0]), "-")
    for name, op in (("gt", ">"), ("lt", "<"), ("ge", ">="), ("le", "<="),
                     ("eq", "=="), ("ne", "!=")):
        for ov in ("Tensor", "Scalar"):
            h[getattr(getattr(aten, name), ov)] = (
                lambda e, a, k, op=op: e.compare(_arr(a[0]), _arr(a[1]), op))
    for op in (aten.logical_and.default, aten.bitwise_and.Tensor):
        h[op] = lambda e, a, k: _logical(e, a[0], a[1], "&&")
    for op in (aten.logical_or.default, aten.bitwise_or.Tensor):
        h[op] = lambda e, a, k: _logical(e, a[0], a[1], "||")
    for op in (aten.logical_not.default, aten.bitwise_not.default):
        h[op] = lambda e, a, k: _not(e, a[0])
    for op in (aten.clone.default, aten.alias.default, aten.detach.default,
               aten.lift_fresh_copy.default):
        h[op] = lambda e, a, k: _arr(a[0])
    for op in (aten.view.default, aten._unsafe_view.default,
               aten.reshape.default):
        h[op] = lambda e, a, k: _arr(a[0]).reshape(a[1])
    for op, v in ((aten.zeros_like.default, 0.0),
                  (aten.ones_like.default, 1.0)):
        h[op] = lambda e, a, k, v=v: _fill(_arr(a[0]).shape, v)
    for op, v in ((aten.zeros.default, 0.0), (aten.ones.default, 1.0)):
        h[op] = lambda e, a, k, v=v: _fill(a[0], v)
    for op in (aten.dot.default, aten.mv.default, aten.mm.default):
        h[op] = lambda e, a, k: e.matmul(_arr(a[0]), _arr(a[1]))
    h.update({
        aten.pow.Tensor_Scalar: lambda e, a, k: _pow(e, _arr(a[0]), a[1]),
        aten.atan2.default: lambda e, a, k: _atan2(e, a[0], a[1]),
        aten.where.self: lambda e, a, k: e.select2(a[0], a[1], a[2], "?"),
        aten.minimum.default: lambda e, a, k: e.select2(
            None, a[0], a[1], "nan_min"),
        aten.maximum.default: lambda e, a, k: e.select2(
            None, a[0], a[1], "nan_max"),
        aten.clamp.default: lambda e, a, k: _clamp(
            e, a[0], _arg(a, k, 1, "min"), _arg(a, k, 2, "max")),
        aten.clamp_min.default: lambda e, a, k: _clamp(e, a[0], a[1], None),
        aten.clamp_max.default: lambda e, a, k: _clamp(e, a[0], None, a[1]),
        aten.select.int: lambda e, a, k: np.take(_arr(a[0]), a[2],
                                                  axis=a[1]),
        aten.slice.Tensor: lambda e, a, k: _slice(*a),
        aten.unsqueeze.default: lambda e, a, k: np.expand_dims(
            _arr(a[0]), a[1] % (_arr(a[0]).ndim + 1)),
        aten.squeeze.default: lambda e, a, k: _squeeze(a[0], None),
        aten.squeeze.dim: lambda e, a, k: _squeeze(a[0], [a[1]]),
        aten.squeeze.dims: lambda e, a, k: _squeeze(a[0], a[1]),
        aten.expand.default: lambda e, a, k: _expand(a[0], list(a[1])),
        aten.permute.default: lambda e, a, k: np.transpose(_arr(a[0]), a[1]),
        aten.t.default: lambda e, a, k: _arr(a[0]).T,
        aten.transpose.int: lambda e, a, k: np.swapaxes(_arr(a[0]), a[1],
                                                        a[2]),
        aten._to_copy.default: lambda e, a, k: _to_float(e, a[0],
                                                         k.get("dtype")),
        aten.stack.default: lambda e, a, k: np.stack(
            [_arr(t) for t in a[0]], axis=_arg(a, k, 1, "dim", 0)),
        aten.cat.default: lambda e, a, k: np.concatenate(
            [_arr(t) for t in a[0]], axis=_arg(a, k, 1, "dim", 0)),
        aten.sum.default: lambda e, a, k: _sum(e, a[0]),
        aten.sum.dim_IntList: lambda e, a, k: _sum(
            e, a[0], _arg(a, k, 1, "dim"), _arg(a, k, 2, "keepdim", False)),
        aten.full_like.default: lambda e, a, k: _fill(_arr(a[0]).shape,
                                                      a[1]),
        aten.full.default: lambda e, a, k: _fill(a[0], a[1]),
        aten.scalar_tensor.default: lambda e, a, k: _arr(float(a[0])),
    })
    return h


_HANDLERS = _handlers()


def _node_op_name(target) -> str:
    return str(target).replace("aten.", "")


def _emit_node(e: _Emitter, target, args, kwargs):
    """The traced value of one aten node."""
    handler = _HANDLERS.get(target)
    if handler is None:
        e.fail(f"aten op {_node_op_name(target)} is not supported by the "
               "CUDA model generator")
    return handler(e, args, kwargs)


def _const_array(t: Tensor) -> np.ndarray:
    vals = t.detach().cpu()
    out = np.empty(tuple(vals.shape), dtype=object)
    for i in np.ndindex(out.shape):
        out[i] = _const(vals[i].item())
    return out


#: The aten ops the generator writes as C++ (``NotImplementedError`` for
#: any other); ``index_select`` only as ``p[key][k]``.
SUPPORTED_OPS = tuple(sorted({_node_op_name(t) for t in _HANDLERS}
                             | {"index_select.default"}))


# ---- tracing ---------------------------------------------------------------


class _StepIndexMode(torch.overrides.TorchFunctionMode):
    """Routes ``leaf[k]`` with a 0-d integer tensor ``k`` through
    ``index_select``, which ``make_fx`` records instead of failing on the
    ``item()`` of Python indexing."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is Tensor.__getitem__:
            leaf, idx = args
            parts = idx if isinstance(idx, tuple) else (idx,)
            first = parts[0] if parts else None
            if (isinstance(first, Tensor) and first.dim() == 0
                    and not first.is_floating_point()
                    and first.dtype != torch.bool):
                out = torch.index_select(leaf, 0, first.reshape(1))
                out = out.squeeze(0)
                rest = parts[1:]
                return out[rest] if rest else out
        return func(*args, **kwargs)


def _trace(fname: str, fn: Callable, has_u: bool, leaves: list[Tensor],
           keys: list[str]):
    """``fn`` traced at ``leaves`` = ``[x, (u,) *params, k]``."""
    from torch.fx.experimental.proxy_tensor import make_fx

    n_p = len(keys)

    def flat_fn(*vals):
        x = vals[0]
        u = vals[1] if has_u else None
        off = 2 if has_u else 1
        p = dict(zip(keys, vals[off:off + n_p]))
        k = vals[-1]
        out = fn(x, u, p, k) if has_u else fn(x, p, k)
        return out if isinstance(out, Tensor) else torch.as_tensor(
            out, dtype=torch.float64)

    try:
        with _StepIndexMode():
            return make_fx(flat_fn)(*leaves)
    except NotImplementedError:
        raise
    except Exception as err:  # noqa: BLE001 -- reported with its function
        msg = str(err).splitlines()[0] if str(err) else type(err).__name__
        if "_local_scalar_dense" in str(err):
            msg = ("a Python branch or host read on a traced value "
                   "(aten._local_scalar_dense)")
        raise NotImplementedError(
            f"CUDA model generator: {fname} cannot be traced: {msg}"
        ) from err


def _graph_key(gm) -> tuple:
    consts = []
    for name in sorted(n.target for n in gm.graph.nodes
                       if n.op == "get_attr"):
        v = getattr(gm, name)
        consts.append((name, v.tolist() if isinstance(v, Tensor) else v))
    return gm.code, tuple(map(repr, consts))


@dataclasses.dataclass(frozen=True)
class _Layout:
    fixed: tuple  # (key, shape, offset)
    tail: tuple  # (key, shape, offset within a step)
    n_fixed: int
    n_tail: int


# ---- the model -------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GeneratedModel:
    """A problem's generated CUDA model: the header, its name (from the
    header's hash) and the flat parameter layout (fixed leaves in key
    order, then the step-indexed leaves step-major)."""

    name: str
    struct: str
    header: str
    fixed: tuple  # ((key, shape), ...)
    tail: tuple  # ((key, shape of one step), ...)
    n_params: int  # NP: fixed entries
    n_tail: int  # NTAIL: entries per step

    def flat_params(self, p: dict, dtype: torch.dtype, device,
                    N: Optional[int] = None) -> Tensor:
        """The flat parameter array the model reads: fixed leaves, then one
        row of every step-indexed leaf per step (``N + 1`` rows are
        needed); for :class:`~.problem.LaneParams` the lane-major ``(B,
        P)`` matrix whose row ``b`` is lane ``b``'s."""
        lanes = lane_count(p)
        n_lanes = 1 if lanes is None else lanes

        def leaf(key):  # (lanes, *shape of the shared leaf)
            v = torch.as_tensor(p[key], dtype=dtype, device=device)
            return v[None] if lanes is None else v.movedim(-1, 0)

        parts = []
        for key, shape in self.fixed:
            v = leaf(key)
            if tuple(v.shape[1:]) != tuple(shape):
                raise ProblemValidationError(
                    f"CUDA model {self.name}: param {key!r} has shape "
                    f"{tuple(v.shape[1:])}, the model reads {tuple(shape)}")
            parts.append(v.reshape(n_lanes, -1))
        if self.tail:
            if N is None:
                raise ValueError(f"CUDA model {self.name}: params indexed by "
                                 "the step need N")
            rows = []
            for key, shape in self.tail:
                v = leaf(key)
                if v.dim() < 2 or tuple(v.shape[2:]) != tuple(shape) or (
                        v.shape[1] < N + 1):
                    raise ProblemValidationError(
                        f"CUDA model {self.name}: param {key!r} has shape "
                        f"{tuple(v.shape[1:])}; the model reads [k] for k "
                        f"<= N = {N}, rows of shape {tuple(shape)}")
                rows.append(v[:, :N + 1].reshape(n_lanes, N + 1, -1))
            parts.append(torch.cat(rows, 2).reshape(n_lanes, -1))
        out = (torch.cat(parts, 1) if parts else
               torch.zeros((n_lanes, 1), dtype=dtype, device=device))
        return (out[0] if lanes is None else out).contiguous()

    def library(self):
        """The kernel library of B2, B3 and emission on this model, built
        at first use (``_build.build_model``) and loaded."""
        from . import _build

        return _build.load_model_library(self)


def _param_leaves(params: Any) -> dict:
    if not isinstance(params, dict):
        raise NotImplementedError(
            "CUDA model generator: params must be a flat dict of arrays")
    out = {}
    for key in sorted(params):
        v = params[key]
        if isinstance(v, dict):
            raise NotImplementedError(
                f"CUDA model generator: param {key!r} is nested; the "
                "generated model reads a flat dict of arrays")
        out[key] = torch.as_tensor(np.asarray(
            v.detach().cpu() if isinstance(v, Tensor) else v,
            dtype=np.float64))
    return out


def _functions(problem: Problem):
    """``[(name, fn, has_u)]`` in header order."""
    out = [("f", problem.f, True), ("L", problem.L, True),
           ("F", problem.F, False)]
    for fam, has_u in _FAMILIES:
        out += [(f"{fam}[{i}]", fn, has_u)
                for i, fn in enumerate(getattr(problem, fam))]
    return out


def _point(problem: Problem, leaves: dict, rng, k: int):
    x = torch.as_tensor(rng.standard_normal(problem.n_x))
    u = torch.as_tensor(rng.standard_normal(problem.n_u))
    return x, u, [leaves[key] for key in leaves], torch.tensor(k)


def _traces(problem: Problem, leaves: dict) -> tuple[dict, "_Layout"]:
    """Every function traced twice, at different points and steps, and the
    parameter layout; raises where the two graphs of a function differ."""
    keys = list(leaves)

    def trace_all(seed: int, k: int) -> dict:
        rng = np.random.default_rng(seed)
        x, u, ps, kt = _point(problem, leaves, rng, k)
        return {name: _trace(name, fn, has_u, [x] + ([u] if has_u else [])
                             + ps + [kt], keys)
                for name, fn, has_u in _functions(problem)}

    first = trace_all(0, 0)
    lay = _layout(first, leaves, keys)
    # a second step inside every step-indexed leaf
    rows = [leaves[key].shape[0] for key, _, _ in lay.tail]
    second = trace_all(1, max(0, min(rows, default=2) - 1))
    for name in first:
        if _graph_key(first[name]) != _graph_key(second[name]):
            raise NotImplementedError(
                f"CUDA model generator: {name}: its graph differs between "
                "two traces at different points and steps (a Python branch "
                "on values); write it with torch.where")
    return first, lay


def _layout(traces: dict, leaves: dict, keys: list[str]) -> _Layout:
    used, tail = set(), set()
    for name, gm in traces.items():
        ph = [n for n in gm.graph.nodes if n.op == "placeholder"]
        has_u = not name.startswith(("F", "hfe", "hfi"))
        p_nodes = ph[(2 if has_u else 1):-1]
        for key, node in zip(keys, p_nodes):
            if node.users:
                used.add(key)
            for user in node.users:
                if user.target is aten.index_select.default:
                    tail.add(key)
    fixed, off = [], 0
    for key in keys:
        if key in used and key not in tail:
            fixed.append((key, tuple(leaves[key].shape), off))
            off += leaves[key].numel()
    tails, toff = [], 0
    for key in keys:
        if key in tail:
            shape = tuple(leaves[key].shape[1:])
            tails.append((key, shape, toff))
            toff += math.prod(shape)
    return _Layout(tuple(fixed), tuple(tails), off, toff)


def _emit_function(name: str, gm, has_u: bool, n_x: int, n_u: int,
                   keys: list[str], lay: _Layout, want_vector: bool):
    """The statements of one traced function and its result(s)."""
    e = _Emitter(name)
    env: dict = {}
    ph = [n for n in gm.graph.nodes if n.op == "placeholder"]
    x = np.array([_S(f"x[{i}]", "T") for i in range(n_x)] or [],
                 dtype=object).reshape(n_x)
    u = np.array([_S(f"u[{i}]", "T") for i in range(n_u)] or [],
                 dtype=object).reshape(n_u)
    env[ph[0]] = x
    off = 1
    if has_u:
        env[ph[1]] = u
        off = 2
    fixed = {key: (shape, o) for key, shape, o in lay.fixed}
    tails = {key: _Tail(key, (None,) + shape, o, lay.n_fixed, lay.n_tail)
             for key, shape, o in lay.tail}
    for key, node in zip(keys, ph[off:-1]):
        if key in tails:
            env[node] = tails[key]
        elif key in fixed:
            shape, o = fixed[key]
            vals = np.empty(math.prod(shape), dtype=object)
            for i in range(vals.size):
                vals[i] = _S(f"p[{o + i}]", "P")
            env[node] = vals.reshape(shape)
    env[ph[-1]] = _arr(_S("k", "I"))
    result = None
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            continue
        if node.op == "get_attr":
            env[node] = _const_array(getattr(gm, node.target))
            continue
        if node.op == "output":
            result = node.args[0]
            break
        if node.op != "call_function":
            e.fail(f"graph node {node.op} {node.target} is not supported")
        args = torch.fx.node.map_arg(node.args, lambda n: env[n])
        kwargs = torch.fx.node.map_arg(node.kwargs, lambda n: env[n])
        target = node.target
        tail_args = [a for a in args if isinstance(a, _Tail)]
        if tail_args:
            t = tail_args[0]
            if target is aten.index_select.default and args[1] == 0:
                idx = _arr(args[2]).reshape(-1)
                if idx.size != 1:
                    e.fail(f"param {t.key!r} indexed by {idx.size} steps")
                s = idx[0]
                r = str(int(s.value)) if s.kind == "c" else s.expr
                if s.kind not in ("I", "c"):
                    e.fail(f"param {t.key!r} indexed by a float")
                env[node] = t.row(r)[None]
            elif target is aten.select.int and args[1] == 0:
                env[node] = t.row(str(int(args[2])))
            else:
                e.fail(f"param {t.key!r} is indexed by the step; it "
                       f"supports only [k] and [constant], not aten op "
                       f"{_node_op_name(target)}")
            continue
        if target is aten.index_select.default:
            e.fail("index_select is supported on a parameter leaf only "
                   "(p[key][k])")
        env[node] = _emit_node(e, target, args, kwargs)
    if isinstance(result, (list, tuple)):
        if len(result) != 1:
            e.fail("returns more than one value")
        result = result[0]
    out = env[result] if isinstance(result, torch.fx.Node) else _arr(result)
    out = _arr(out)
    if want_vector:
        if out.shape != (n_x,):
            e.fail(f"must return {n_x} states, got shape {out.shape}")
    elif out.shape != ():
        e.fail(f"must be a scalar, got shape {out.shape}")
    return e.lines, [_cast(s, "T") for s in out.reshape(-1)]


def _indent(lines, n):
    return [" " * n + ln for ln in lines]


def _family_body(members) -> list[str]:
    """A switch over a family's members (the hand-written headers' form);
    an empty family returns 0."""
    if not members:
        return ["return T(0);"]
    if len(members) == 1:
        lines, (ret,) = members[0]
        return lines + [f"return {ret};"]
    out = ["switch (i) {"]
    for i, (lines, (ret,)) in enumerate(members):
        label = "default:" if i == len(members) - 1 else f"case {i}:"
        out += [f"  {label} {{"] + _indent(lines, 4) + [
            f"    return {ret};", "  }"]
    return out + ["}"]


def _ternary(vals: list[int]) -> str:
    if not vals:
        return "0"
    expr = str(vals[-1])
    for i in range(len(vals) - 2, -1, -1):
        expr = f"i == {i} ? {vals[i]} : ({expr})"
    return expr


def _leaves(layout) -> str:
    """``key[shape]@offset, ...`` of a layout, for the header's comment."""
    return ", ".join(f"{k}{list(sh)}@{o}" for k, sh, o in layout) or "none"


def _render(problem: Problem, struct: str, emitted: dict,
            lay: _Layout) -> str:
    box = problem.box_constraints
    if len(box) != problem.n_h:
        raise ProblemValidationError(
            f"problem {problem.name!r}: {problem.n_h} h constraints but "
            f"{len(box)} analyzed box constraints")
    tail = lay.n_tail > 0
    n_fixed = lay.n_fixed
    sig_u = "const T* x, const T* u, const P* p, int k"
    sig_x = "const T* x, const P* p, int k"
    head = [
        "// Generated by ddp_generator_tpu_torch/codegen.py from the torch",
        f"// functions of problem {problem.name!r}: do not edit.",
        "#pragma once", "", '#include "dual.cuh"', "", "namespace ddp {", "",
        f"struct {struct} {{",
        f'  static constexpr const char* NAME = "{struct}";',
        f"  static constexpr int NX = {problem.n_x}, NU = {problem.n_u};",
        f"  static constexpr int NH = {problem.n_h};",
        f"  static constexpr int NHLE = {problem.n_hle}, "
        f"NHLI = {problem.n_hli}, NHFE = {problem.n_hfe}, "
        f"NHFI = {problem.n_hfi};",
        f"  // fixed params: {_leaves(lay.fixed)}",
        f"  // per-step params, p[NP + k*NTAIL + j]: {_leaves(lay.tail)}",
        f"  static constexpr int NP = {n_fixed}, NTAIL = {lay.n_tail};",
        # many fixed params are read where they lie, not copied to registers
        "  static constexpr bool TAIL = "
        f"{'true' if tail or n_fixed > 32 else 'false'};",
        "",
        "  __host__ __device__ static constexpr int box_index(int i) {",
        f"    return {_ternary([bc.u_index for bc in box])};", "  }",
        "  __host__ __device__ static constexpr int box_sign(int i) {",
        f"    return {_ternary([1 if bc.sign > 0 else -1 for bc in box])};",
        "  }", ""]
    body = []

    def fn(ret, name, sig, lines):
        body.extend(["  template <typename T, typename P>",
                     f"  __host__ __device__ static {ret} {name}({sig}) {{"]
                    + _indent(lines, 4) + ["  }", ""])

    lines, outs = emitted["f"]
    fn("void", "f", sig_u + ", T* xn",
       lines + [f"xn[{i}] = {o};" for i, o in enumerate(outs)])
    for name, sig in (("L", sig_u), ("F", sig_x)):
        lines, (o,) = emitted[name]
        fn("T", name, sig, lines + [f"return {o};"])
    for fam, has_u in _FAMILIES:
        members = [emitted[f"{fam}[{i}]"]
                   for i in range(len(getattr(problem, fam)))]
        fn("T", fam, "int i, " + (sig_u if has_u else sig_x),
           _family_body(members))
    return "\n".join(head + body + ["};", "", "}  // namespace ddp", ""])


def generate_cuda_model(problem: Problem, example_params: Any
                        ) -> GeneratedModel:
    """The CUDA model header of ``problem``'s torch functions, traced with
    ``example_params`` (their keys and shapes fix the layout; a leaf read
    as ``p[key][k]`` needs at least ``N + 1`` rows at solve time)."""
    leaves = _param_leaves(example_params)
    keys = list(leaves)
    traces, lay = _traces(problem, leaves)
    emitted = {}
    for name, fn, has_u in _functions(problem):
        emitted[name] = _emit_function(
            name, traces[name], has_u, problem.n_x, problem.n_u, keys, lay,
            want_vector=name == "f")
    text = _render(problem, "GENERATED_MODEL", emitted, lay)
    digest = hashlib.sha256(text.encode()).hexdigest()[:12]
    struct = f"gen_{digest}"
    return GeneratedModel(
        name=struct, struct=struct,
        header=text.replace("GENERATED_MODEL", struct),
        fixed=tuple((k, s) for k, s, _ in lay.fixed),
        tail=tuple((k, s) for k, s, _ in lay.tail),
        n_params=lay.n_fixed, n_tail=lay.n_tail)


def _structure(params: dict) -> tuple:
    """Keys and shapes of the params."""
    return tuple((k, tuple(v.shape) if isinstance(v, Tensor)
                  else np.shape(v)) for k, v in sorted(params.items()))


_CACHE: dict = {}
_BY_NAME: dict = {}


def model_for(problem: Problem, params: Any) -> GeneratedModel:
    """The generated model of ``problem`` for params of this structure,
    generated once per problem and structure."""
    key = (problem, _structure(params))
    gm = _CACHE.get(key)
    if gm is None:
        gm = generate_cuda_model(problem, params)
        _CACHE[key] = gm
        _BY_NAME[gm.name] = gm
    return gm


def by_name(name: str) -> Optional[GeneratedModel]:
    """A model generated in this process, by its name."""
    return _BY_NAME.get(name)


def kernel_model(problem: Problem, params: Any):
    """The CUDA model kernels B2, B3 and emission run for ``problem`` and
    the library that holds them: its hand-written model (one of
    :data:`KERNEL_MODELS`, in the main library), or, when it names none, the
    model generated from its functions (built at first use; per-lane params
    generate it from one lane's)."""
    from . import _build

    if isinstance(params, LaneParams):  # one lane's have the structure
        params = {k: v[..., 0] for k, v in params.items()}
    model = problem.cuda_model
    if isinstance(model, GeneratedModel):  # restored with an AOT artifact
        _BY_NAME.setdefault(model.name, model)
        return model, model.library()
    if model is None:
        gm = model_for(problem, params)
        return gm, gm.library()
    if model.name not in KERNEL_MODELS:
        raise NotImplementedError(
            f"problem {problem.name!r}: no CUDA model {model.name!r} among "
            f"the hand-written ones {KERNEL_MODELS}; leave cuda_model unset "
            "to generate one")
    return model, _build.load_library()


def library_of(name: str):
    """The kernel library that holds the model called ``name``."""
    from . import _build

    gm = by_name(name)
    return _build.load_library() if gm is None else gm.library()

