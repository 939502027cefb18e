"""Kernel B1: the whole backward pass as one hand-written CUDA kernel.

Replaces ``ddp_generator_tpu/ops/pallas_backpass.py:pallas_back_pass_cm``
(the ``pl.pallas_call`` at line 682; math in ``riccati_step``,
``_sym_solve_small`` and ``_patterns``).  Source: ``csrc/backpass.cu``.

Per lane, the reverse Riccati recursion over the horizon: Q with the
FULL_DDP tensor terms, regType 1/2 regularization, the exact active-set
boxQP over the 3^n_u clamp patterns (sorted by the number of clamped
inputs, first KKT-valid pattern wins), the clamped gains through the
state-dependent bounds, dV accumulation, ``g_norm`` divided by ``N-1``,
the value update with the UNregularized Quu/Qxu and a symmetrized Vxx.
Once a step fails the lane's outputs are zero and its carry, dV and g
freeze (``back_pass.c:38-257``).

On the card (H100): a block owns ``kLanes`` lanes (``csrc/staged.cuh``).
Its consumer warp walks ``t = N-1 .. 0``, four threads a lane
(``csrc/backpass_coop.cuh``) -- the loop replaces the TPU's sequential
grid, which carried ``Vx``/``Vxx`` in VMEM scratch -- and reads each step's
operands from shared memory, where a producer warp has copied the time tile
with ``cp.async`` (each bundle value read once, coalesced) while the
consumers ran the tile before.  A lane's four threads form the rows of Q's
dot products and of the value update; the first runs the boxQP and the
gains.  Each step depends on the previous step's value function, so the
kernel is bound by a step's latency times N, not by the ~0.2 ms its bytes
take.  The tile shape is fixed in the source; :func:`kernel_info` reports
it.

Layouts as in JAX: inputs component-outer ``(C, N, B)`` (``cxx``, ``cuu``
and the last two axes of ``fxx``/``fuu`` packed upper triangles), outputs
``l (N, n_u, B)``, ``L (N, n_u*n_x, B)``, ``dV (2, B)``, ``g_norm (1, B)``,
``failed (1, B)`` bool.

:func:`back_pass_cm_plain` is the plain PyTorch version of the same
function; :func:`back_pass_cm` takes it for CPU tensors only and launches
the kernel (or raises) for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, launches
from .backpass import BackPassResult
from .boxqp import _patterns

Tensor = torch.Tensor

# (n_x, n_u) pairs instantiated in csrc/backpass.cu: CarParking, Cartpole,
# Brachistochrone.  Any other with n_u <= 3 is built at first use
# (_build.build_backpass_shape).
KERNEL_SHAPES = ((4, 2), (4, 1), (1, 1))


def library(n_x: int, n_u: int):
    """The kernel library that holds B1 at ``(n_x, n_u)``: the main one for
    :data:`KERNEL_SHAPES`, else one built for that shape.  ``n_u > 3``
    raises, as in the JAX package."""
    if n_u > 3:
        raise ValueError("the backward-pass kernel supports n_u <= 3")
    if (n_x, n_u) in KERNEL_SHAPES:
        return _build.load_library()
    return _build.load_backpass_shape(n_x, n_u)


def tri_size(n: int) -> int:
    """Packed upper-triangle length for a symmetric (n, n) matrix."""
    return n * (n + 1) // 2


def tri_index(a: int, b: int, n: int) -> int:
    """Row-major upper-triangle index of (a, b), a <= b, in an (n, n)
    matrix: the packing of ``cxx``, ``cuu`` and the last two axes of
    ``fxx``/``fuu`` in the bundle."""
    assert a <= b
    return a * n - a * (a - 1) // 2 + (b - a)


@functools.lru_cache(maxsize=None)
def _sym_index(n: int, device: torch.device) -> Tensor:
    """The packed index of every entry of a full ``(n, n)`` matrix, made
    once per (n, device): a body call's first eager run builds it, never a
    CUDA graph capture (a copy from host memory)."""
    return torch.tensor([tri_index(min(a, b), max(a, b), n)
                         for a in range(n) for b in range(n)], device=device)


def _unpack_sym(packed: Tensor, n: int) -> Tensor:
    """``(tri, ...)`` packed upper triangle -> full ``(n, n, ...)``."""
    return packed[_sym_index(n, packed.device)].reshape(
        (n, n) + tuple(packed.shape[1:]))


def _mm(A: Tensor, Bm: Tensor) -> Tensor:
    """``(n, k, B) @ (k, m, B) -> (n, m, B)``, summed in index order."""
    out = A[:, 0, None] * Bm[None, 0]
    for i in range(1, A.shape[1]):
        out = out + A[:, i, None] * Bm[None, i]
    return out


def _mv(A: Tensor, v: Tensor) -> Tensor:
    """``(n, k, B) @ (k, B) -> (n, B)``, summed in index order."""
    out = A[:, 0] * v[0]
    for i in range(1, A.shape[1]):
        out = out + A[:, i] * v[i]
    return out


def _tv(v: Tensor, T: Tensor) -> Tensor:
    """``sum_i v[i] * T[i]`` for ``v (k, B)``, ``T (k, ..., B)``."""
    out = v[0] * T[0]
    for i in range(1, T.shape[0]):
        out = out + v[i] * T[i]
    return out


def _sym_solve_small(H, rhs, free, n):
    """Closed-form solve on the free block of ``H``; ``H[(i, j)]`` (i <= j)
    and ``rhs[i]`` are ``(B,)`` lane tensors, ``free`` static bools.
    Returns ``(x list, pd_ok (B,), iv(i, j))`` with PD gates ``a>0``,
    ``det>0``, ``m2>0`` per free-set size (``pallas_backpass.py:81-145``)."""
    idxs = [i for i in range(n) if free[i]]
    m = len(idxs)
    like = rhs[0]

    def h(i, j):
        return H[(min(idxs[i], idxs[j]), max(idxs[i], idxs[j]))]

    inv = {}
    if m == 0:
        ok = torch.ones_like(like, dtype=torch.bool)
    elif m == 1:
        a = h(0, 0)
        ok = a > 0.0
        inv = {(0, 0): 1.0 / torch.where(ok, a, 1.0)}
    elif m == 2:
        a, b, d = h(0, 0), h(0, 1), h(1, 1)
        det = a * d - b * b
        ok = (a > 0.0) & (det > 0.0)
        sdet = torch.where(ok, det, 1.0)
        inv = {(0, 0): d / sdet, (0, 1): -b / sdet, (1, 1): a / sdet}
    else:
        a, b, c = h(0, 0), h(0, 1), h(0, 2)
        d, e, f = h(1, 1), h(1, 2), h(2, 2)
        m2 = a * d - b * b
        det = a * (d * f - e * e) - b * (b * f - c * e) + c * (b * e - c * d)
        ok = (a > 0.0) & (m2 > 0.0) & (det > 0.0)
        sdet = torch.where(ok, det, 1.0)
        inv = {
            (0, 0): (d * f - e * e) / sdet,
            (0, 1): (c * e - b * f) / sdet,
            (0, 2): (b * e - c * d) / sdet,
            (1, 1): (a * f - c * c) / sdet,
            (1, 2): (b * c - a * e) / sdet,
            (2, 2): (a * d - b * b) / sdet,
        }
    pos = {gi: i for i, gi in enumerate(idxs)}
    zero = torch.zeros_like(like)

    def iv(i, j):
        if not (free[i] and free[j]):
            return zero
        a_, b_ = pos[i], pos[j]
        return inv[(min(a_, b_), max(a_, b_))]

    x = []
    for i in range(n):
        if free[i]:
            acc = iv(i, idxs[0]) * rhs[idxs[0]]
            for j in idxs[1:]:
                acc = acc + iv(i, j) * rhs[j]
            x.append(acc)
        else:
            x.append(zero)
    return x, ok, iv


def riccati_step_plain(NX, NU, reg_type, full_ddp, fx, fu, cx, cu, cxx, cuu,
                       cxu, fxx, fuu, fxu, lower, upper, lo_hx, up_hx, lo_s,
                       up_s, u_k, lam, Vx, Vxx):
    """One backward step on ``(..., B)`` lane tensors (port of
    ``pallas_backpass.riccati_step``).  Shapes: ``fx (NX, NX, B)``,
    ``fu (NX, NU, B)``, ``cxx`` full ``(NX, NX, B)``, ``fxx (NX, NX, NX, B)``
    indexed ``[i][a][b]``, ``lower (NU, B)``, ``lo_hx (NU, NX, B)``,
    ``Vx (NX, B)``, ``Vxx (NX, NX, B)``.

    Returns ``(l_k (NU, B), L_k (NU, NX, B), dv0, dv1, Vx_new, Vxx_new,
    g_k, step_failed (B,) 0/1 float)``."""
    fxT, fuT = fx.transpose(0, 1), fu.transpose(0, 1)
    vfx = _mm(Vxx, fx)
    vfu = _mm(Vxx, fu)
    Qu = cu + _mv(fuT, Vx)
    Qx = cx + _mv(fxT, Vx)
    Qxu = cxu + _mm(fxT, vfu)
    Quu = cuu + _mm(fuT, vfu)
    Qxx = cxx + _mm(fxT, vfx)
    if full_ddp:
        Qxu = Qxu + _tv(Vx, fxu)
        Quu = Quu + _tv(Vx, fuu)
        Qxx = Qxx + _tv(Vx, fxx)
    if reg_type == 2:
        QuuF = Quu + lam * _mm(fuT, fu)
        Qxu_reg = Qxu + lam * _mm(fxT, fu)
    else:
        QuuF = torch.stack([
            torch.stack([Quu[a, b] + lam if a == b else Quu[a, b]
                         for b in range(NU)]) for a in range(NU)])
        Qxu_reg = Qxu

    finite_lo = torch.isfinite(lower)
    finite_up = torch.isfinite(upper)
    Hd = {(a, b): QuuF[a, b] for a in range(NU) for b in range(a, NU)}
    H = lambda a, b: Hd[(min(a, b), max(a, b))]
    zero = torch.zeros_like(Qu[0])
    one = torch.ones_like(zero)
    all_free = tuple([True] * NU)
    x_free, pd_full, iv_full = _sym_solve_small(
        Hd, [-Qu[a] for a in range(NU)], all_free, NU)

    best_valid = zero
    best_x = [zero] * NU
    best_cl_lo = [zero] * NU
    best_cl_up = [zero] * NU
    best_inv = {(a, b): zero for a in range(NU) for b in range(NU)}
    for pat in _patterns(NU):
        free = tuple(v == 0 for v in pat)
        at_lo = tuple(v == 1 for v in pat)
        at_up = tuple(v == 2 for v in pat)
        bound_ok = None
        xc = []
        for a in range(NU):
            if at_lo[a]:
                ok_a = finite_lo[a]
                xc.append(torch.where(ok_a, lower[a], 0.0))
            elif at_up[a]:
                ok_a = finite_up[a]
                xc.append(torch.where(ok_a, upper[a], 0.0))
            else:
                ok_a = None
                xc.append(zero)
            if ok_a is not None:
                bound_ok = ok_a if bound_ok is None else (bound_ok & ok_a)
        if free == all_free:
            xf, pd_ok, iv = x_free, pd_full, iv_full
        else:
            clamped = [b for b in range(NU) if not free[b]]
            rhs = []
            for a in range(NU):
                if free[a]:
                    hx_c = H(a, clamped[0]) * xc[clamped[0]]
                    for b in clamped[1:]:
                        hx_c = hx_c + H(a, b) * xc[b]
                    rhs.append(-(Qu[a] + hx_c))
                else:
                    rhs.append(zero)
            xf, pd_ok, iv = _sym_solve_small(Hd, rhs, free, NU)
        x = [xf[a] if free[a] else xc[a] for a in range(NU)]
        kkt = pd_ok if bound_ok is None else (bound_ok & pd_ok)
        for a in range(NU):
            grad = H(a, 0) * x[0]
            for b in range(1, NU):
                grad = grad + H(a, b) * x[b]
            grad = Qu[a] + grad
            if free[a]:
                kkt = kkt & (x[a] >= lower[a]) & (x[a] <= upper[a])
            elif at_lo[a]:
                kkt = kkt & (grad >= 0.0)
            else:
                kkt = kkt & (grad <= 0.0)
        take = torch.where(kkt, 1.0 - best_valid, zero)
        for a in range(NU):
            best_x[a] = best_x[a] + take * (x[a] - best_x[a])
            if at_lo[a]:
                best_cl_lo[a] = best_cl_lo[a] + take * (one - best_cl_lo[a])
            if at_up[a]:
                best_cl_up[a] = best_cl_up[a] + take * (one - best_cl_up[a])
            for b in range(NU):
                best_inv[(a, b)] = best_inv[(a, b)] + take * (
                    iv(a, b) - best_inv[(a, b)])
        best_valid = best_valid + take

    step_failed = torch.where(pd_full, one - best_valid, one)
    l_k = torch.stack(best_x)
    cl_lo = torch.stack(best_cl_lo)[:, None]
    cl_up = torch.stack(best_cl_up)[:, None]
    D = cl_lo * lo_s[:, None] * lo_hx + cl_up * up_s[:, None] * up_hx
    inv = torch.stack([torch.stack([best_inv[(a, b)] for b in range(NU)])
                       for a in range(NU)])
    M = Qxu_reg.transpose(0, 1) - _mm(QuuF, D)
    L_k = -_mm(inv, M) - D

    dv0 = l_k[0] * Qu[0]
    for a in range(1, NU):
        dv0 = dv0 + l_k[a] * Qu[a]
    s = None
    for a in range(NU):
        for b in range(NU):
            t = l_k[a] * Quu[a, b] * l_k[b]
            s = t if s is None else s + t
    dv1 = 0.5 * s

    Quu_l = _mv(Quu, l_k)
    LT = L_k.transpose(0, 1)
    Vx_new = Qx + _mv(LT, Quu_l + Qu) + _mv(Qxu, l_k)
    Vxx_new = (Qxx + _mm(_mm(LT, Quu), L_k) + _mm(LT, Qxu.transpose(0, 1))
               + _mm(Qxu, L_k))
    Vxx_new = 0.5 * (Vxx_new + Vxx_new.transpose(0, 1))

    g_k = torch.abs(l_k[0]) / (torch.abs(u_k[0]) + 1.0)
    for a in range(1, NU):
        g_k = torch.maximum(g_k, torch.abs(l_k[a]) / (torch.abs(u_k[a]) + 1.0))
    return l_k, L_k, dv0, dv1, Vx_new, Vxx_new, g_k, step_failed


def back_pass_cm_plain(sd_cm: dict, final_cx, final_cxx, us_cm, lam, n_x: int,
                       reg_type: int, full_ddp: bool):
    """Plain PyTorch version of kernel B1: a Python loop over time of
    :func:`riccati_step_plain` on the whole batch."""
    n_u, N, B = us_cm.shape
    NX, NU = n_x, n_u
    fx = sd_cm["fx"].reshape(NX, NX, N, B)
    fu = sd_cm["fu"].reshape(NX, NU, N, B)
    cxx = _unpack_sym(sd_cm["cxx"], NX)
    cuu = _unpack_sym(sd_cm["cuu"], NU)
    cxu = sd_cm["cxu"].reshape(NX, NU, N, B)
    if full_ddp:
        fxx = torch.stack([_unpack_sym(v, NX) for v in
                           sd_cm["fxx"].reshape(NX, tri_size(NX), N, B)])
        fuu = torch.stack([_unpack_sym(v, NU) for v in
                           sd_cm["fuu"].reshape(NX, tri_size(NU), N, B)])
        fxu = sd_cm["fxu"].reshape(NX, NX, NU, N, B)
    lo_hx = sd_cm["lower_hx"].reshape(NU, NX, N, B)
    up_hx = sd_cm["upper_hx"].reshape(NU, NX, N, B)
    lam = lam[0]

    Vx = final_cx
    Vxx = final_cxx.reshape(NX, NX, B)
    zero = torch.zeros_like(lam)
    fail = zero
    dv0_acc, dv1_acc, g_acc = zero, zero, zero
    l_out = torch.empty((N, NU, B), dtype=lam.dtype, device=lam.device)
    L_out = torch.empty((N, NU * NX, B), dtype=lam.dtype, device=lam.device)
    for t in range(N - 1, -1, -1):
        (l_k, L_k, dv0, dv1, Vx_new, Vxx_new, g_k, step_failed) = (
            riccati_step_plain(
                NX, NU, reg_type, full_ddp, fx[..., t, :], fu[..., t, :],
                sd_cm["cx"][:, t], sd_cm["cu"][:, t], cxx[..., t, :],
                cuu[..., t, :], cxu[..., t, :],
                fxx[..., t, :] if full_ddp else None,
                fuu[..., t, :] if full_ddp else None,
                fxu[..., t, :] if full_ddp else None,
                sd_cm["lower"][:, t], sd_cm["upper"][:, t],
                lo_hx[..., t, :], up_hx[..., t, :],
                sd_cm["lower_sign"][:, t], sd_cm["upper_sign"][:, t],
                us_cm[:, t], lam, Vx, Vxx))
        # live = 1 until a step fails; then outputs are zero and the carry,
        # dV and g freeze.
        fail = torch.clamp(fail + step_failed, max=1.0)
        live = 1.0 - fail
        l_out[t] = live * l_k
        L_out[t] = (live * L_k).reshape(NU * NX, B)
        Vx = Vx + live * (Vx_new - Vx)
        Vxx = Vxx + live * (Vxx_new - Vxx)
        dv0_acc = dv0_acc + live * dv0
        dv1_acc = dv1_acc + live * dv1
        g_acc = g_acc + live * g_k
    dV = torch.stack([dv0_acc, dv1_acc])
    g_norm = (g_acc / float(N - 1))[None]
    return l_out, L_out, dV, g_norm, (fail > 0.0)[None]


def result_from_cm(l_cm, L_cm, dV, g_norm, failed) -> BackPassResult:
    """The kernel-layout outputs ``l (N, n_u, B)``, ``L (N, n_u*n_x, B)``,
    ``dV (2, B)``, ``g_norm (1, B)``, ``failed (1, B)`` as the batch-major
    :class:`BackPassResult`."""
    N, n_u, B = l_cm.shape
    return BackPassResult(
        l=l_cm.permute(2, 0, 1),
        L=L_cm.permute(2, 0, 1).reshape(B, N, n_u, L_cm.shape[1] // n_u),
        dV=dV.T,
        g_norm=g_norm[0],
        failed=failed[0],
    )


_BUNDLE_KEYS = ("fx", "fu", "cx", "cu", "cxx", "cuu", "cxu", "fxx", "fuu",
                "fxu", "lower", "upper", "lower_hx", "upper_hx", "lower_sign",
                "upper_sign")


def _bundle_shapes(n_x, n_u, full_ddp):
    tx, tu = tri_size(n_x), tri_size(n_u)
    c = {"fx": n_x * n_x, "fu": n_x * n_u, "cx": n_x, "cu": n_u, "cxx": tx,
         "cuu": tu, "cxu": n_x * n_u, "fxx": n_x * tx if full_ddp else 0,
         "fuu": n_x * tu if full_ddp else 0,
         "fxu": n_x * n_x * n_u if full_ddp else 0, "lower": n_u,
         "upper": n_u, "lower_hx": n_u * n_x, "upper_hx": n_u * n_x,
         "lower_sign": n_u, "upper_sign": n_u}
    return c


def back_pass_cm(sd_cm: dict, final_cx, final_cxx, us_cm, lam, n_x: int,
                 reg_type: int, full_ddp: bool, when: Tensor | None = None):
    """Backward pass on a packed component-outer bundle.

    ``sd_cm`` maps ``StepDerivs`` field names to ``(C, N, B)`` tensors;
    ``final_cx (n_x, B)``, ``final_cxx (n_x*n_x, B)``, ``us_cm (n_u, N, B)``,
    ``lam (1, B)``.  Returns ``(l (N, n_u, B), L (N, n_u*n_x, B),
    dV (2, B), g_norm (1, B), failed (1, B) bool)``.

    CPU tensors run :func:`back_pass_cm_plain`; CUDA tensors launch kernel
    B1 (``csrc/backpass.cu``, or built for the shape at first use) and
    count the launch (:func:`..launches.count`: on the host, or on the
    device inside a capture or with the predicate ``when``, which the
    solver sets to "some lane of this body call runs"); anything else
    raises."""
    n_u, N, B = us_cm.shape
    dev = us_cm.device
    if dev.type == "cpu":
        return back_pass_cm_plain(sd_cm, final_cx, final_cxx, us_cm, lam,
                                  n_x, reg_type, full_ddp)
    if dev.type != "cuda":
        raise ValueError(f"back_pass_cm: unsupported device {dev}")
    dtype = us_cm.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"back_pass_cm: dtype {dtype} is not float32/64")
    shapes = _bundle_shapes(n_x, n_u, full_ddp)
    inputs = []
    for key in _BUNDLE_KEYS:
        t = sd_cm[key]
        want = (shapes[key], N, B)
        if shapes[key] == 0:
            inputs.append(None)
            continue
        _check(t, want, dtype, dev, key)
        inputs.append(t)
    for name, t, want in (("us_cm", us_cm, (n_u, N, B)), ("lam", lam, (1, B)),
                          ("final_cx", final_cx, (n_x, B)),
                          ("final_cxx", final_cxx, (n_x * n_x, B))):
        _check(t, want, dtype, dev, name)
        inputs.append(t)
    l_out = torch.empty((N, n_u, B), dtype=dtype, device=dev)
    L_out = torch.empty((N, n_u * n_x, B), dtype=dtype, device=dev)
    dV = torch.empty((2, B), dtype=dtype, device=dev)
    g_norm = torch.empty((1, B), dtype=dtype, device=dev)
    failed = torch.empty((1, B), dtype=torch.bool, device=dev)
    lib = library(n_x, n_u)
    ptrs = _build.pointer_array(inputs + [l_out, L_out, dV, g_norm, failed])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ddp_backpass(
            0 if dtype == torch.float32 else 1, n_x, n_u, reg_type,
            int(full_ddp), N, B, ptrs, stream)
    _build.check(lib, rc, "backpass")
    launches.count("backpass", dev, when)
    return l_out, L_out, dV, g_norm, failed


def kernel_info(n_x: int, n_u: int, reg_type: int, full_ddp: bool,
                dtype: torch.dtype) -> dict:
    """Tile shape and resources of one instantiation of kernel B1: lanes
    per block ``G``, steps per tile ``S``, producer warps ``W`` (a launch
    narrower than a block takes one more), dynamic shared memory per block,
    registers and local memory (stack frame and spill) per thread, threads
    per lane ``P``.  Builds the library; needs a CUDA device."""
    lib = library(n_x, n_u)
    out = (ctypes.c_int * 7)()
    rc = lib.ddp_backpass_info(0 if dtype == torch.float32 else 1, n_x, n_u,
                               reg_type, int(full_ddp), out)
    _build.check(lib, rc, "backpass info")
    return _build.info_dict(out)


def _check(t: Tensor, shape, dtype, dev, name: str) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype != dtype or t.device != dev:
        raise TypeError(f"{name}: {t.dtype} on {t.device}, want {dtype} on "
                        f"{dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
