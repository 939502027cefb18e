"""Modified Cholesky (Schnabel-Eskow), the reference's MOD_CHOL option
(``ddp_generator_tpu.ops.chol``).

Re-derivation of ``cholesky.c:129-287``: the two-phase Schnabel-Eskow
modified Cholesky with diagonal pivoting, Gerschgorin-bound pivoting in phase
two and a closed-form 2x2 eigenvalue fix for the final block.  The solver
uses it only to precondition an indefinite ``Quu`` inside boxQP
(``boxQP.c:69-72``): when the perturbation is nonzero, ``H`` is rebuilt as
``H + P^T diag(E) P`` (``perm_tri_square``, ``cholesky.c:339-356``).  So
the observable output is the scattered diagonal perturbation.

Batched over leading axes: ``A`` is ``(..., n, n)`` for a small static
``n``.  The loop over columns is a Python loop; each lane's phase switch is
a mask, and every pivot is a per-lane permutation applied by ``gather``.
Pivot choices (first maximum), ``_EPS`` and every expression follow the JAX
version, so the two pick the same pivots; sums run in index order
(``ops/small.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .small import total

Tensor = torch.Tensor

_EPS = 2.22044604925031e-16  # matches the constant in cholesky.c:132-133


class ModCholResult(NamedTuple):
    e_scattered: Tensor  # (..., n) diagonal perturbation in ORIGINAL order
    perm: Tensor  # (..., n) int32: work index -> original index
    e_work: Tensor  # (..., n) perturbation in pivoted (work) order
    delta_prev: Tensor  # (...,): the reference's return value (last delta)


def _swap_index(n: int, i: int, j: Tensor) -> Tensor:
    """Per-lane permutation ``(..., n)`` that swaps entries ``i`` (static)
    and ``j (...)``."""
    idx = torch.arange(n, device=j.device)
    jj = j[..., None]
    return torch.where(idx == i, jj, torch.where(idx == jj, i, idx))


def _swap_rows_cols(A: Tensor, perm: Tensor) -> Tensor:
    rows = A.gather(-2, perm[..., :, None].expand(A.shape))
    return rows.gather(-1, perm[..., None, :].expand(A.shape))


def _m(mask: Tensor) -> Tensor:
    """A per-lane mask broadcast over the trailing (n, n) of a matrix."""
    return mask[..., None, None]


def _chol_step(A: Tensor, j: int) -> Tensor:
    """One factorization step on column j (``jthIteration``,
    ``cholesky.c:112-127``): trailing submatrix downdate.  Processed rows
    and columns keep stale values; they are never read again."""
    n = A.shape[-1]
    trail = torch.arange(n, device=A.device) > j
    # guard the sqrt/divide: by construction A[j,j] > 0 when this step runs
    d2 = torch.clamp(A[..., j, j], min=float(np.finfo(np.float32).tiny))
    row = torch.where(trail, A[..., j, :], 0.0)
    outer = row[..., :, None] * row[..., None, :]
    return A - outer / d2[..., None, None] * (trail[:, None] & trail[None, :])


def mod_chol(A: Tensor) -> ModCholResult:
    """Schnabel-Eskow perturbation of symmetric ``A (..., n, n)``."""
    n = A.shape[-1]
    dtype, dev = A.dtype, A.device
    batch = A.shape[:-2]
    tau = _EPS ** (1.0 / 3.0)
    taubar = _EPS ** (2.0 / 3.0)
    mu = 0.1
    idx = torch.arange(n, device=dev)
    P0 = idx.to(torch.int32).expand(batch + (n,))

    if n == 1:
        # cholesky.c:143-150
        a = A[..., 0, 0]
        delta = torch.clamp(taubar * torch.abs(a) - a, min=0.0)
        delta = torch.where(a == 0.0, taubar, delta)
        e = delta[..., None]
        return ModCholResult(e, P0, e, delta)

    diag0 = torch.diagonal(A, dim1=-2, dim2=-1)
    gamma = torch.abs(diag0).amax(-1)
    phase1 = (diag0 >= 0.0).all(-1)  # cholesky.c:156-160

    P = P0.to(torch.int64)
    E = torch.zeros(batch + (n,), dtype=dtype, device=dev)
    g = torch.zeros(batch + (n,), dtype=dtype, device=dev)
    deltaprev = torch.zeros(batch, dtype=dtype, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    NEG, POS = float("-inf"), float("inf")
    last = n - 1
    off_diag = ~torch.eye(n, dtype=torch.bool, device=dev)

    for j in range(n):
        act = idx >= j
        trail = idx > j
        diag = torch.diagonal(A, dim1=-2, dim2=-1)

        # ================= phase 1 attempt (cholesky.c:163-204) ===========
        p1_here = phase1 & ~done
        dm = torch.where(act, diag, NEG)
        tmp_max = dm.amax(-1)
        pivot_id = dm.argmax(-1)
        tmp_min = torch.where(act, diag, POS).amin(-1)
        switch_a = (tmp_max < taubar * gamma) | (tmp_min < -mu * tmp_max)

        perm = _swap_index(n, j, pivot_id)
        A_piv = _swap_rows_cols(A, perm)
        P_piv = P.gather(-1, perm)
        if j < n - 1:
            d_piv = torch.diagonal(A_piv, dim1=-2, dim2=-1)
            rj = A_piv[..., j, :]
            schur = torch.where(trail, d_piv - rj * rj / A_piv[..., j, j, None],
                                POS)
            tmp_min2 = torch.clamp(schur.amin(-1), max=0.0)  # C init 0.0
        else:
            tmp_min2 = torch.zeros(batch, dtype=dtype, device=dev)
        switch_b = (~switch_a) & (tmp_min2 < -mu * gamma)

        do_p1 = p1_here & ~switch_a & ~switch_b
        switch_now = p1_here & (switch_a | switch_b)
        # switch_a breaks BEFORE the pivot; switch_b after (cholesky.c:179-198)
        A_sw = torch.where(_m(switch_a), A, A_piv)
        P_sw = torch.where(switch_a[..., None], P, P_piv)

        A_p1 = _chol_step(A_piv, j)

        # Lane state AFTER a potential switch, entering phase 2 at this j:
        p2_here = (~phase1 | switch_now) & ~done
        A2 = torch.where(_m(switch_now), A_sw, A)
        P2 = torch.where(switch_now[..., None], P_sw, P)

        # Gerschgorin init when ENTERING phase 2 (cholesky.c:220-229): at a
        # switch, or -- for a negative initial diagonal -- at j == 0 where
        # phase 1 never ran (cholesky.c:159).
        enter_p2 = switch_now | ((~phase1 & ~done) if j == 0 else False)
        offabs = torch.where((act[:, None] & act[None, :]) & off_diag,
                             torch.abs(A2), 0.0)
        g_init = torch.where(
            act, torch.diagonal(A2, dim1=-2, dim2=-1) - total(offabs), 0.0)
        g2 = torch.where(enter_p2[..., None], g_init, g)

        if j <= n - 3:
            # ============ phase 2 regular step (cholesky.c:231-269) =======
            gid = torch.where(act, g2, NEG).argmax(-1)
            perm_g = _swap_index(n, j, gid)
            A_g = _swap_rows_cols(A2, perm_g)
            P_g = P2.gather(-1, perm_g)
            g_g = g2.gather(-1, perm_g)
            normj = total(torch.where(trail, torch.abs(A_g[..., j, :]), 0.0))
            delta2 = torch.clamp(torch.maximum(
                torch.maximum(normj, taubar * gamma) - A_g[..., j, j],
                deltaprev), min=0.0)
            add2 = torch.where(delta2 > 0.0, delta2, 0.0)
            A_g = A_g.clone()
            A_g[..., j, j] = A_g[..., j, j] + add2
            # Gerschgorin bound update (cholesky.c:260-266)
            ajj = A_g[..., j, j]
            upd = torch.where(ajj != normj, 1.0 - normj / ajj, 0.0)
            g_g = torch.where(trail, g_g + torch.abs(A_g[..., j, :])
                              * upd[..., None], g_g)
            A_g = _chol_step(A_g, j)

            A = torch.where(_m(p2_here), A_g, torch.where(_m(do_p1), A_p1, A))
            P = torch.where(p2_here[..., None], P_g,
                            torch.where(do_p1[..., None], P_piv, P))
            g = torch.where(p2_here[..., None], g_g, g2)
            E_add = E.clone()
            E_add[..., j] = E_add[..., j] + add2
            E = torch.where(p2_here[..., None], E_add, E)
            deltaprev = torch.where(p2_here & (delta2 > 0.0), delta2,
                                    deltaprev)
        elif j == n - 2:
            # ===== final 2x2 block via eigenvalues (cholesky.c:270-285) ===
            fix2 = p2_here  # phase 2 at j == n-2 (the 1x1 tail impossible)
            a00 = A2[..., j, j]
            a01 = A2[..., j, j + 1]
            a11 = A2[..., j + 1, j + 1]
            dd = a00 - a11
            disc = torch.sqrt(dd * dd + 4.0 * a01 * a01)
            lam_hi = 0.5 * ((a00 + a11) + disc)
            lam_lo = 0.5 * ((a00 + a11) - disc)
            delta3 = torch.maximum(
                torch.clamp(-lam_lo + torch.maximum(
                    tau * (lam_hi - lam_lo) / (1.0 - tau), taubar * gamma),
                    min=0.0),
                deltaprev)
            add3 = torch.where(delta3 > 0.0, delta3, 0.0)
            A_f = A2.clone()
            A_f[..., j, j] = A_f[..., j, j] + add3
            A_f[..., j + 1, j + 1] = A_f[..., j + 1, j + 1] + add3

            A = torch.where(_m(fix2), A_f, torch.where(_m(do_p1), A_p1, A))
            P = torch.where(fix2[..., None], P2,
                            torch.where(do_p1[..., None], P_piv, P))
            g = g2
            E_add = E.clone()
            E_add[..., j] = E_add[..., j] + add3
            E_add[..., j + 1] = E_add[..., j + 1] + add3
            E = torch.where(fix2[..., None], E_add, E)
            deltaprev = torch.where(fix2 & (delta3 > 0.0), delta3, deltaprev)
            done = done | fix2
        else:  # j == n-1: phase 2 entered exactly at the last index
            # (cholesky.c:207-214)
            tail1 = p2_here
            a_nn = A2[..., last, last]
            delta_last = -a_nn + torch.maximum(tau * a_nn / (tau - 1.0),
                                               taubar * gamma)
            A = torch.where(_m(do_p1), A_p1, A)
            P = torch.where(do_p1[..., None], P_piv, P)
            g = g2
            E_add = E.clone()
            E_add[..., last] = E_add[..., last] + delta_last
            E = torch.where(tail1[..., None], E_add, E)
            deltaprev = torch.where(tail1, delta_last, deltaprev)
            done = done | tail1

        phase1 = phase1 & ~switch_now

    e_scattered = torch.zeros_like(E).scatter_add(-1, P, E)
    return ModCholResult(e_scattered, P.to(torch.int32), E, deltaprev)


def mod_chol_perturb(H: Tensor) -> tuple[Tensor, Tensor]:
    """MOD_CHOL pre-regularization (``boxQP.c:69-72``).

    Returns ``(H_psd, changed)``: when the Schnabel-Eskow perturbation is
    nonzero, ``H_psd = H + P^T diag(E) P`` (the ``perm_tri_square``
    reconstruction, ``cholesky.c:339-356``); otherwise ``H`` unchanged."""
    r = mod_chol(0.5 * (H + H.mT))
    changed = r.delta_prev > 0.0
    H_psd = H + torch.diag_embed(r.e_scattered)
    return torch.where(_m(changed), H_psd, H), changed
