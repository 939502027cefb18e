"""Kernel B3: derivatives and backward pass fused into one CUDA kernel.

Replaces ``ddp_generator_tpu/ops/pallas_fused.py:fused_derivs_back_pass``
(line 587; the ``pl.pallas_call`` at line 715, body ``_make_fused_kernel``).
Sources: ``csrc/fused.cu`` (kernel and dispatch), ``csrc/fused.cuh`` (one
lane), ``csrc/derivs.cuh`` and ``csrc/dual.cuh`` (forward-mode derivatives
of the problem's CUDA model), ``csrc/riccati.cuh`` (the step it shares with
kernel B1).

The model is the problem's hand-written CUDA model, or the one generated
from its torch functions (:mod:`..codegen`).

Per lane, B1's reverse Riccati recursion (:mod:`.cuda_backpass`), with every
derivative computed inside the kernel: at each step the kernel reads only
the nominal ``(x_t, u_t)`` and the running AL multipliers, forms ``fx``,
``fu``, ``cx``, ``cu``, ``cxx``, ``cuu``, ``cxu`` (and with FULL_DDP the
second derivatives of ``f``) by one hyper-dual evaluation of the model per
direction pair, the box limits, and feeds the step.  The running cost
carries the ``hle``/``hli`` penalties with weight ``w_pen_l``; the final
``Fx``/``Fxx`` those of ``hfe``/``hfi`` with ``w_pen_f``.  The derivative
bundle of the emission path never exists in memory.  Besides B1's outputs
it returns ``derivs_ok``: every derivative object finite, at every step and
the final stage (the ``calc_derivs`` ok flag).

On the card (H100): B1's producer/consumer pipeline (``csrc/staged.cuh``)
with producers that compute instead of copy.  A block owns ``kLanes``
lanes; its consumer warp walks ``t = N-1 .. 0``, one thread per lane, with
the carry in registers, reading each step's operands from shared memory;
its producer warps fill the time tiles ahead of it, one work item per
(step, lane, direction pair), per direction of ``f`` without FULL_DDP and
per box-limit evaluation.  Only the FULL_DDP contraction ``Vx . f**``
depends on the carry, and the consumer forms it, so the derivative work
runs in parallel beside the one dependent chain (see the note in
``csrc/fused.cu``).  The tile shape is fixed in the source;
:func:`kernel_info` reports it.

:func:`fused_derivs_back_pass_plain` is the plain PyTorch version: the
emission (:func:`.cm_derivs.cm_emit`) followed by B1's plain version.
:func:`fused_derivs_back_pass` takes it for CPU tensors only and launches
the kernel (or raises) for CUDA tensors.  Shared params, ``n_u <= 3``; no
128-lane padding.
"""

from __future__ import annotations

import ctypes
from typing import Any

import torch

from .. import _build, codegen, launches
from ..problem import Problem
from .cm_derivs import cm_emit
from .cuda_backpass import (
    BackPassResult,
    back_pass_cm_plain,
    result_from_cm,
)

Tensor = torch.Tensor


def fused_derivs_back_pass_plain(problem: Problem, xs, us, mu_le, mu_li,
                                 mu_fe, mu_fi, w_pen_l, w_pen_f, lam,
                                 params: Any, reg_type: int,
                                 full_ddp: bool
                                 ) -> tuple[BackPassResult, Tensor]:
    """Plain PyTorch version of kernel B3 on the same operands: emission of
    the packed bundle, then :func:`.cuda_backpass.back_pass_cm_plain`."""
    sd_cm, fcx, fcxx, us_cm, ok = cm_emit(
        problem, xs, us, mu_le, mu_li, mu_fe, mu_fi, w_pen_l, w_pen_f,
        params, full_ddp)
    out = back_pass_cm_plain(sd_cm, fcx, fcxx, us_cm, lam[None, :],
                             problem.n_x, reg_type, full_ddp)
    return result_from_cm(*out), ok


def fused_derivs_back_pass(problem: Problem, xs, us, mu_le, mu_li, mu_fe,
                           mu_fi, w_pen_l, w_pen_f, lam, params: Any,
                           reg_type: int, full_ddp: bool,
                           when: Tensor | None = None
                           ) -> tuple[BackPassResult, Tensor]:
    """Derivatives and backward pass of every lane in one call.

    Batch-major operands: ``xs (B, N+1, n_x)``, ``us (B, N, n_u)``,
    ``mu_le/mu_li (B, N, n_h)``, ``mu_fe/mu_fi (B, n_h)``, ``w_pen_l``,
    ``w_pen_f`` and ``lam (B,)``; ``params`` a dict of tensors shared by
    all lanes.  Returns ``(BackPassResult, derivs_ok (B,) bool)``.

    CPU tensors run :func:`fused_derivs_back_pass_plain`; CUDA tensors
    launch kernel B3 and count it as B1's wrapper does (``when`` the same
    predicate) on the problem's hand-written CUDA model of
    :data:`..codegen.KERNEL_MODELS`, or on the model generated from its
    functions when it names none (:mod:`..codegen`); anything else raises,
    as do ``n_u > 3`` and a dtype other than float32/64."""
    B, Np1, n_x = xs.shape
    N, n_u = Np1 - 1, us.shape[-1]
    dev = us.device
    if dev.type == "cpu":
        return fused_derivs_back_pass_plain(
            problem, xs, us, mu_le, mu_li, mu_fe, mu_fi, w_pen_l, w_pen_f,
            lam, params, reg_type, full_ddp)
    if dev.type != "cuda":
        raise ValueError(f"fused_derivs_back_pass: unsupported device {dev}")
    if n_u > 3:
        raise ValueError("backpass_method='fused' supports n_u <= 3")
    if reg_type not in (1, 2):
        raise ValueError(f"reg_type must be 1 or 2, got {reg_type}")
    dtype = us.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused_derivs_back_pass: dtype {dtype} is not "
                        "float32/64")
    if (n_x, n_u) != (problem.n_x, problem.n_u):
        raise ValueError("operand widths do not match the problem")
    fam = dict(le=problem.n_hle, li=problem.n_hli, fe=problem.n_hfe,
               fi=problem.n_hfi)
    checks = [("xs", xs, (B, N + 1, n_x)), ("us", us, (B, N, n_u)),
              ("mu_le", mu_le, (B, N, fam["le"])),
              ("mu_li", mu_li, (B, N, fam["li"])),
              ("mu_fe", mu_fe, (B, fam["fe"])),
              ("mu_fi", mu_fi, (B, fam["fi"])),
              ("w_pen_l", w_pen_l, (B,)), ("w_pen_f", w_pen_f, (B,)),
              ("lam", lam, (B,))]
    for name, t, shape in checks:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.dtype != dtype or t.device != dev:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, want {dtype} "
                            f"on {dev}")

    model, lib = codegen.kernel_model(problem, params)

    def cm(a, n):  # (B, N, n) -> (N, n, B), None for an empty family
        return a.permute(1, 2, 0).contiguous() if n else None

    def lanes(a, n):  # (B, n) -> (n, B)
        return a.T.contiguous() if n else None

    inputs = [cm(xs[:, :N], n_x), cm(us, n_u), cm(mu_le, fam["le"]),
              cm(mu_li, fam["li"]), lanes(xs[:, N], n_x),
              w_pen_l[None].contiguous(), w_pen_f[None].contiguous(),
              lam[None].contiguous(), lanes(mu_fe, fam["fe"]),
              lanes(mu_fi, fam["fi"]), model.flat_params(params, dtype, dev,
                                                         N)]
    l_out = torch.empty((N, n_u, B), dtype=dtype, device=dev)
    L_out = torch.empty((N, n_u * n_x, B), dtype=dtype, device=dev)
    dV = torch.empty((2, B), dtype=dtype, device=dev)
    g_norm = torch.empty((1, B), dtype=dtype, device=dev)
    failed = torch.empty((1, B), dtype=torch.bool, device=dev)
    derivs_ok = torch.empty((1, B), dtype=torch.bool, device=dev)
    ptrs = _build.pointer_array(
        inputs + [l_out, L_out, dV, g_norm, failed, derivs_ok])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ddp_fused(0 if dtype == torch.float32 else 1,
                           model.name.encode(), reg_type, int(full_ddp), N,
                           B, ptrs, stream)
    _build.check(lib, rc, "fused")
    launches.count("fused", dev, when)
    return result_from_cm(l_out, L_out, dV, g_norm, failed), derivs_ok[0]


def kernel_info(model: str, reg_type: int, full_ddp: bool,
                dtype: torch.dtype) -> dict:
    """Tile shape and resources of one instantiation of kernel B3, as
    :func:`.cuda_backpass.kernel_info`; ``model`` a name of
    :data:`..codegen.KERNEL_MODELS` or of a generated model.  Builds the
    library; needs a CUDA device."""
    lib = codegen.library_of(model)
    out = (ctypes.c_int * 6)()
    rc = lib.ddp_fused_info(0 if dtype == torch.float32 else 1,
                            model.encode(), reg_type, int(full_ddp), out)
    _build.check(lib, rc, "fused info")
    return _build.info_dict(out)
