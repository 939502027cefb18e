"""The kernel path's derivative emission as one hand-written CUDA kernel.

On a card it replaces :func:`.cm_derivs.cm_emit`, forward-over-reverse
autograd on six copies of the lane axis (~1,586 kernels a call), by two
launches of ``csrc/emit.cu`` (``emit.cuh``, ``emit_launch.cuh``): the same
packed component-major bundle kernel B1 reads, from the problem's CUDA
model (hand-written, or generated from its torch functions,
:mod:`..codegen`).  The arithmetic is kernel B3's: the work items of
``csrc/derivs.cuh`` (one hyper-dual evaluation of ``f`` and ``L`` per
direction pair, the directions of ``f`` without FULL_DDP, the box limits)
and ``final_derivs``, forward mode, so a term rounds as B3's does and not as
autograd's.

The operands are read batch-major as the solver holds them (``xs (B,
N+1, n_x)``, ``us (B, N, n_u)``, ...); the outputs are those of
:func:`.cm_derivs.cm_emit`: every key of ``_BUNDLE_KEYS`` as ``(C, N, B)``,
``final_cx (n_x, B)``, the
mirrored ``final_cxx (n_x*n_x, B)``, ``us_cm (n_u, N, B)`` and ``ok (B,)``.
The bundle is one ``(NT, N, B)`` allocation (``staged.cuh``'s ``Terms``
order, ``u`` last) whose keys are views.

:func:`emit` takes :func:`.cm_derivs.cm_emit` (the plain version) for CPU
tensors and launches the kernel, or raises, for CUDA tensors.  Shared params
only: the model headers read one flat param vector, so per-lane params
(:class:`~..problem.LaneParams`) keep the torch emitter.
"""

from __future__ import annotations

import ctypes
from typing import Any

import torch

from .. import _build, codegen, launches
from ..problem import LaneParams, Problem
from .cm_derivs import cm_emit
from .cuda_backpass import _BUNDLE_KEYS, _bundle_shapes

Tensor = torch.Tensor

#: Points (step, lane) of a call from which a thread takes all of a point's
#: work items; below it, one item a thread.  Timed on an H100 (PERF.md's
#: thread-mapping table): the crossover lies between B=64 and B=128 at
#: N=500.
WHOLE_POINT_FROM = 1 << 15


def items_per_point(n_x: int, n_u: int, full_ddp: bool) -> int:
    """Work items of one (step, lane): the direction pairs, without FULL_DDP
    the directions of ``f``, then the box limits (``derivs.cuh``)."""
    d = n_x + n_u
    return d * (d + 1) // 2 + (0 if full_ddp else d) + 1


def items_per_thread(N: int, B: int, items: int) -> int:
    """Work items a thread takes at a call of ``N * B`` points: one where
    the points alone would leave the card idle, else all of a point's."""
    return items if N * B >= WHOLE_POINT_FROM else 1


def emit(problem: Problem, xs, us, mu_le, mu_li, mu_fe, mu_fi, w_pen_l,
         w_pen_f, params: Any, full_ddp: bool, shared: bool = False,
         when: Tensor | None = None, per: int | None = None):
    """Emit the packed CM bundle: ``(sd_cm, final_cx, final_cxx, us_cm,
    ok)``, the contract of :func:`.cm_derivs.cm_emit`.

    CPU tensors run :func:`.cm_derivs.cm_emit` (``shared`` picks its torch
    emitter there, and only there).  CUDA tensors launch the emission
    kernel on the problem's CUDA model and count it as B1's wrapper does
    (``when`` the same predicate); ``per`` overrides
    :func:`items_per_thread`.  Per-lane params, another device, a dtype
    other than float32/64 or operands of the wrong shape raise."""
    dev = us.device
    if dev.type == "cpu":
        return cm_emit(problem, xs, us, mu_le, mu_li, mu_fe, mu_fi, w_pen_l,
                       w_pen_f, params, full_ddp, shared)
    if dev.type != "cuda":
        raise ValueError(f"emit: unsupported device {dev}")
    if isinstance(params, LaneParams):
        raise ValueError("emit: per-lane params take cm_emit (the CUDA "
                         "models read one shared param vector)")
    dtype = us.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"emit: dtype {dtype} is not float32/64")
    n_x, n_u = problem.n_x, problem.n_u
    B, N = us.shape[0], us.shape[1]
    fam = (problem.n_hle, problem.n_hli, problem.n_hfe, problem.n_hfi)
    checks = [("xs", xs, (B, N + 1, n_x)), ("us", us, (B, N, n_u)),
              ("mu_le", mu_le, (B, N, fam[0])),
              ("mu_li", mu_li, (B, N, fam[1])),
              ("mu_fe", mu_fe, (B, fam[2])), ("mu_fi", mu_fi, (B, fam[3])),
              ("w_pen_l", w_pen_l, (B,)), ("w_pen_f", w_pen_f, (B,))]
    for name, t, shape in checks:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.dtype != dtype or t.device != dev:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, want {dtype} "
                            f"on {dev}")
    items = items_per_point(n_x, n_u, full_ddp)
    per = items_per_thread(N, B, items) if per is None else per
    if not 1 <= per <= items:
        raise ValueError(f"emit: per={per} is not in 1..{items}")

    model, lib = codegen.kernel_model(problem, params)
    shapes = _bundle_shapes(n_x, n_u, full_ddp)
    sizes = [shapes[k] for k in _BUNDLE_KEYS] + [n_u]  # Terms order, u
    bundle = torch.empty((sum(sizes), N, B), dtype=dtype, device=dev)
    final_cx = torch.empty((n_x, B), dtype=dtype, device=dev)
    final_cxx = torch.empty((n_x * n_x, B), dtype=dtype, device=dev)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    inputs = [xs.contiguous(), us.contiguous()] + [
        a.contiguous() if n else None
        for a, n in zip((mu_le, mu_li, mu_fe, mu_fi), fam)] + [
        w_pen_l.contiguous(), w_pen_f.contiguous(),
        model.flat_params(params, dtype, dev, N)]
    ptrs = _build.pointer_array(inputs + [bundle, final_cx, final_cxx, ok])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ddp_emit(0 if dtype == torch.float32 else 1,
                          model.name.encode(), int(full_ddp), per, N, B,
                          ptrs, stream)
    _build.check(lib, rc, "emit")
    launches.count("emit", dev, when)
    *parts, us_cm = bundle.split(sizes)
    return dict(zip(_BUNDLE_KEYS, parts)), final_cx, final_cxx, us_cm, ok


def kernel_info(model: str, full_ddp: bool, dtype: torch.dtype) -> dict:
    """Threads a block, work items a point, and the registers and local
    bytes a thread of the step kernel (``steps_*``) and of the final kernel
    (``final_*``) of one instantiation; ``model`` a name of
    :data:`..codegen.KERNEL_MODELS` or of a generated model.  Builds the
    library; needs a CUDA device."""
    lib = codegen.library_of(model)
    out = (ctypes.c_int * 6)()
    rc = lib.ddp_emit_info(0 if dtype == torch.float32 else 1,
                           model.encode(), int(full_ddp), out)
    _build.check(lib, rc, "emit info")
    return dict(zip(("threads", "items", "steps_registers", "steps_local",
                     "final_registers", "final_local"), list(out)))
