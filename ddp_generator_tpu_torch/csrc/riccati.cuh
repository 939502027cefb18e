// One step of the backward Riccati recursion, shared by kernel B1
// (backpass.cu, derivatives read from a packed bundle) and kernel B3
// (fused.cu, derivatives computed in the kernel): the CUDA form of
// ddp_generator_tpu/ops/pallas_backpass.py:riccati_step (line 148; patterns
// _patterns, solves _sym_solve_small).
//
// Semantics (back_pass.c:38-257):
//  * Q with the FULL_DDP tensor terms; regType 1 (Quu + lam*I) or 2
//    (Quu + lam*fu'fu, Qxu + lam*fx'fu);
//  * boxQP as exact active-set enumeration over the 3^n_u clamp patterns,
//    sorted by the number of clamped inputs; the first pattern passing the
//    KKT check wins; closed-form free-block inverses with the PD gates
//    a>0, det>0, m2>0; nothing stored for clamped rows/columns;
//  * the step fails if the full H is not PD or no pattern is valid;
//  * clamped gains through the state-dependent bounds, the value update
//    with the UNregularized Quu/Qxu, Vxx symmetrized, g = max_a |l_a| /
//    (|u_a| + 1).
// The FULL_DDP terms enter as their contraction with the carried Vx
// (vfxx[a][b] = sum_i Vx[i] fxx[i][a][b], likewise fxu and fuu): the caller
// sums them in index order i = 0..n_x-1 -- B1 from its bundle, B3 as each
// second-order derivative is formed -- so a step never holds the
// n_x-times-larger tensors.  Every other sum runs in the index order of the
// plain PyTorch version (ops/cuda_backpass.py: riccati_step_plain).
// riccati_step is riccati_q, riccati_gains, riccati_value and riccati_g in
// turn; B3 runs it on one thread a lane, B1's consumer (backpass_coop.cuh)
// runs the Q build and the value update's rows on four threads a lane and
// the rest on the first, with the same operations.
#pragma once

#include "common.cuh"

namespace ddp {

__host__ __device__ constexpr int tri(int a, int b, int n) {
  return a <= b ? a * n - a * (a - 1) / 2 + (b - a)
                : b * n - b * (b - 1) / 2 + (a - b);
}

__host__ __device__ constexpr int pow3(int e) {
  return e == 0 ? 1 : 3 * pow3(e - 1);
}

// Digit a (input a, most significant first) of a base-3 clamp code:
// 0 free, 1 at the lower bound, 2 at the upper bound.
__host__ __device__ constexpr int digit(int code, int n, int a) {
  return (code / pow3(n - 1 - a)) % 3;
}

__host__ __device__ constexpr int n_clamped(int code, int n) {
  int c = 0;
  for (int a = 0; a < n; ++a) c += digit(code, n, a) != 0;
  return c;
}

// The p-th pattern in enumeration order: sorted by the number of clamped
// inputs, itertools.product order within (pallas_backpass.py:_patterns).
__host__ __device__ constexpr int pattern_code(int n, int p) {
  for (int nc = 0; nc <= n; ++nc)
    for (int c = 0; c < pow3(n); ++c)
      if (n_clamped(c, n) == nc) {
        if (p == 0) return c;
        --p;
      }
  return -1;
}

// The digits of every pattern, in enumeration order, as a table built at
// compile time.  pattern_code and digit are loops over integer divisions,
// which the device compiler leaves in the code when they are called in the
// step (recomputing all 3^n_u patterns at every step); read from this
// table with unrolled indices they are constants, and so are the free sets
// and index lists of sym_solve.
template <int NU>
struct PatternTable {
  int dg[pow3(NU)][NU];
  __host__ __device__ constexpr PatternTable() : dg() {
    for (int p = 0; p < pow3(NU); ++p)
      for (int a = 0; a < NU; ++a) dg[p][a] = digit(pattern_code(NU, p), NU, a);
  }
};

// The quotients of the boxQP and of g: IEEE division (`div` of
// riccati_gains and riccati_g; kernel B1 passes its own,
// backpass_coop.cuh: FastDiv).
struct PlainDiv {
  template <typename T>
  __host__ __device__ __forceinline__ T operator()(T n, T d) const {
    return n / d;
  }
};

// Closed-form solve on the free block of H (upper triangle read), with the
// PD gates of pallas_backpass.py:_sym_solve_small.  inv receives the
// free-block inverse at global indices and zero elsewhere.
template <typename T, int NU, class Div = PlainDiv>
__host__ __device__ __forceinline__ void sym_solve(const T (&H)[NU][NU],
                                                   const T (&rhs)[NU],
                                                   const bool (&free_)[NU],
                                                   T (&x)[NU], bool& ok,
                                                   T (&inv)[NU][NU],
                                                   Div div = Div()) {
  int idx[3] = {0, 0, 0};
  int m = 0;
#pragma unroll
  for (int a = 0; a < NU; ++a)
    if (free_[a]) idx[m++] = a;
  auto h = [&](int i, int j) -> T {
    const int p = idx[i], q = idx[j];
    return p <= q ? H[p][q] : H[q][p];
  };
  T s[3][3] = {{T(0), T(0), T(0)}, {T(0), T(0), T(0)}, {T(0), T(0), T(0)}};
  if (m == 0) {
    ok = true;  // all clamped: nothing to solve
  } else if (m == 1) {
    const T a = h(0, 0);
    ok = a > T(0);
    s[0][0] = div(T(1), ok ? a : T(1));
  } else if (m == 2) {
    const T a = h(0, 0), b = h(0, 1), d = h(1, 1);
    const T det = a * d - b * b;
    ok = (a > T(0)) && (det > T(0));
    const T sdet = ok ? det : T(1);
    s[0][0] = div(d, sdet);
    s[0][1] = div(-b, sdet);
    s[1][1] = div(a, sdet);
  } else {
    const T a = h(0, 0), b = h(0, 1), c = h(0, 2);
    const T d = h(1, 1), e = h(1, 2), f = h(2, 2);
    const T m2 = a * d - b * b;
    const T det =
        a * (d * f - e * e) - b * (b * f - c * e) + c * (b * e - c * d);
    ok = (a > T(0)) && (m2 > T(0)) && (det > T(0));
    const T sdet = ok ? det : T(1);
    s[0][0] = div(d * f - e * e, sdet);
    s[0][1] = div(c * e - b * f, sdet);
    s[0][2] = div(b * e - c * d, sdet);
    s[1][1] = div(a * f - c * c, sdet);
    s[1][2] = div(b * c - a * e, sdet);
    s[2][2] = div(a * d - b * b, sdet);
  }
#pragma unroll
  for (int a = 0; a < NU; ++a)
#pragma unroll
    for (int c = 0; c < NU; ++c) inv[a][c] = T(0);
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < m; ++j)
      inv[idx[i]][idx[j]] = i <= j ? s[i][j] : s[j][i];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    if (free_[a]) {
      T acc = inv[a][idx[0]] * rhs[idx[0]];
      for (int j = 1; j < m; ++j) acc = acc + inv[a][idx[j]] * rhs[idx[j]];
      x[a] = acc;
    } else {
      x[a] = T(0);
    }
  }
}

// A step's derivatives, full (unpacked) matrices.  Box limits relative to
// u, +-inf where unconstrained; *_hx and *_s of the binding constraint.
template <typename T, int NX, int NU>
struct StepTerms {
  T fx[NX][NX], fu[NX][NU], cx[NX], cu[NU], cxx[NX][NX], cuu[NU][NU],
      cxu[NX][NU];
  T vfxx[NX][NX], vfxu[NX][NU], vfuu[NU][NU];  // Vx . f** (FULL_DDP only)
  T lower[NU], upper[NU], lo_hx[NU][NX], up_hx[NU][NX], lo_s[NU], up_s[NU];
};

// What a step returns: gains, dV terms, the new value function (Vxx
// symmetrized), the g_norm term and a 0/1 failure flag.
template <typename T, int NX, int NU>
struct StepOut {
  T l[NU], L[NU][NX], dv0, dv1, Vx[NX], Vxx[NX][NX], g, failed;
};

// The step's Q terms: Qu, Qx, Quu, Qxu, Qxx, and QuuF, Qxu_reg regularized.
template <typename T, int NX, int NU>
struct QTerms {
  T Qu[NU], Qx[NX], Quu[NU][NU], Qxu[NX][NU], Qxx[NX][NX], QuuF[NU][NU],
      Qxu_reg[NX][NU];
};

// The first half of riccati_step: Q and its regularization.
template <typename T, int NX, int NU, int REG, bool FULL>
__host__ __device__ __forceinline__ void riccati_q(
    const StepTerms<T, NX, NU>& d, T lam, const T (&Vx)[NX],
    const T (&Vxx)[NX][NX], QTerms<T, NX, NU>& q) {
  T (&Qu)[NU] = q.Qu;
  T (&Qx)[NX] = q.Qx;
  T (&Quu)[NU][NU] = q.Quu;
  T (&Qxu)[NX][NU] = q.Qxu;
  T (&Qxx)[NX][NX] = q.Qxx;
  T (&QuuF)[NU][NU] = q.QuuF;
  T (&Qxu_reg)[NX][NU] = q.Qxu_reg;

  // ---- Q build (back_pass.c:80-131) ----
  T vfx[NX][NX], vfu[NX][NU];
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      T s = Vxx[a][0] * d.fx[0][c];
#pragma unroll
      for (int i = 1; i < NX; ++i) s = s + Vxx[a][i] * d.fx[i][c];
      vfx[a][c] = s;
    }
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      T s = Vxx[a][0] * d.fu[0][c];
#pragma unroll
      for (int i = 1; i < NX; ++i) s = s + Vxx[a][i] * d.fu[i][c];
      vfu[a][c] = s;
    }
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    T s = d.fu[0][a] * Vx[0];
#pragma unroll
    for (int i = 1; i < NX; ++i) s = s + d.fu[i][a] * Vx[i];
    Qu[a] = d.cu[a] + s;
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      T q = d.fu[0][a] * vfu[0][c];
#pragma unroll
      for (int i = 1; i < NX; ++i) q = q + d.fu[i][a] * vfu[i][c];
      Quu[a][c] = d.cuu[a][c] + q;
    }
  }
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    T s = d.fx[0][a] * Vx[0];
#pragma unroll
    for (int i = 1; i < NX; ++i) s = s + d.fx[i][a] * Vx[i];
    Qx[a] = d.cx[a] + s;
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      T q = d.fx[0][a] * vfu[0][c];
#pragma unroll
      for (int i = 1; i < NX; ++i) q = q + d.fx[i][a] * vfu[i][c];
      Qxu[a][c] = d.cxu[a][c] + q;
    }
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      T q = d.fx[0][a] * vfx[0][c];
#pragma unroll
      for (int i = 1; i < NX; ++i) q = q + d.fx[i][a] * vfx[i][c];
      Qxx[a][c] = d.cxx[a][c] + q;
    }
  }
  if (FULL) {
    // + Vx . f**: contraction over the dynamics output index
#pragma unroll
    for (int a = 0; a < NX; ++a) {
#pragma unroll
      for (int c = 0; c < NU; ++c) Qxu[a][c] = Qxu[a][c] + d.vfxu[a][c];
#pragma unroll
      for (int c = 0; c < NX; ++c) Qxx[a][c] = Qxx[a][c] + d.vfxx[a][c];
    }
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int c = 0; c < NU; ++c) Quu[a][c] = Quu[a][c] + d.vfuu[a][c];
  }

  // ---- regularization (back_pass.c:133-159) ----
#pragma unroll
  for (int a = 0; a < NU; ++a)
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      if (REG == 2) {
        T s = d.fu[0][a] * d.fu[0][c];
#pragma unroll
        for (int i = 1; i < NX; ++i) s = s + d.fu[i][a] * d.fu[i][c];
        QuuF[a][c] = Quu[a][c] + lam * s;
      } else {
        QuuF[a][c] = a == c ? Quu[a][c] + lam : Quu[a][c];
      }
    }
#pragma unroll
  for (int a = 0; a < NX; ++a)
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      if (REG == 2) {
        T s = d.fx[0][a] * d.fu[0][c];
#pragma unroll
        for (int i = 1; i < NX; ++i) s = s + d.fx[i][a] * d.fu[i][c];
        Qxu_reg[a][c] = Qxu[a][c] + lam * s;
      } else {
        Qxu_reg[a][c] = Qxu[a][c];
      }
    }
}

// The second half, to the gains: boxQP, gains and dV from the Q terms and
// the box limits of `d` (lower, upper, lo_hx, up_hx, lo_s, up_s).
template <typename T, int NX, int NU, class Box, class Div = PlainDiv>
__host__ __device__ __forceinline__ void riccati_gains(
    const QTerms<T, NX, NU>& q, const Box& d, StepOut<T, NX, NU>& o,
    Div div = Div()) {
  constexpr int NP = pow3(NU);
  constexpr PatternTable<NU> patterns;
  const T (&Qu)[NU] = q.Qu;
  const T (&Quu)[NU][NU] = q.Quu;
  const T (&QuuF)[NU][NU] = q.QuuF;
  const T (&Qxu_reg)[NX][NU] = q.Qxu_reg;
  auto H = [&](int a, int c) -> T {
    return a <= c ? QuuF[a][c] : QuuF[c][a];
  };

  // ---- boxQP: exact active-set enumeration ----
  T x_free[NU], inv_full[NU][NU], neg_qu[NU];
  bool all_free[NU];
  bool pd_full;
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    neg_qu[a] = -Qu[a];
    all_free[a] = true;
  }
  sym_solve<T, NU>(QuuF, neg_qu, all_free, x_free, pd_full, inv_full, div);

  T best_valid = T(0), best_x[NU], best_cl_lo[NU], best_cl_up[NU],
    best_inv[NU][NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    best_x[a] = best_cl_lo[a] = best_cl_up[a] = T(0);
#pragma unroll
    for (int c = 0; c < NU; ++c) best_inv[a][c] = T(0);
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    bool fr[NU], at_lo[NU], at_up[NU];
    T xc[NU];
    bool bound_ok = true, any_free_clamped = false;
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      const int dg = patterns.dg[p][a];
      fr[a] = dg == 0;
      at_lo[a] = dg == 1;
      at_up[a] = dg == 2;
      if (at_lo[a]) {
        const bool ok_a = is_finite(d.lower[a]);
        xc[a] = ok_a ? d.lower[a] : T(0);
        bound_ok = bound_ok && ok_a;
      } else if (at_up[a]) {
        const bool ok_a = is_finite(d.upper[a]);
        xc[a] = ok_a ? d.upper[a] : T(0);
        bound_ok = bound_ok && ok_a;
      } else {
        xc[a] = T(0);
      }
      any_free_clamped = any_free_clamped || !fr[a];
    }
    T xf[NU], inv[NU][NU];
    bool pd_ok;
    if (!any_free_clamped) {  // the all-free pattern: reuse the full solve
      pd_ok = pd_full;
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        xf[a] = x_free[a];
#pragma unroll
        for (int c = 0; c < NU; ++c) inv[a][c] = inv_full[a][c];
      }
    } else {
      // rhs = -(Qu + H_FC xc) on the free block
      T rhs[NU];
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        if (fr[a]) {
          T hxc = T(0);
          bool first = true;
#pragma unroll
          for (int c = 0; c < NU; ++c) {
            if (fr[c]) continue;
            hxc = first ? H(a, c) * xc[c] : hxc + H(a, c) * xc[c];
            first = false;
          }
          rhs[a] = -(Qu[a] + hxc);
        } else {
          rhs[a] = T(0);
        }
      }
      sym_solve<T, NU>(QuuF, rhs, fr, xf, pd_ok, inv, div);
    }
    T xp[NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) xp[a] = fr[a] ? xf[a] : xc[a];
    bool kkt = bound_ok && pd_ok;
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      T g = H(a, 0) * xp[0];
#pragma unroll
      for (int c = 1; c < NU; ++c) g = g + H(a, c) * xp[c];
      g = Qu[a] + g;
      if (fr[a])
        kkt = kkt && (xp[a] >= d.lower[a]) && (xp[a] <= d.upper[a]);
      else if (at_lo[a])
        kkt = kkt && (g >= T(0));
      else
        kkt = kkt && (g <= T(0));
    }
    // blend with a 0/1 weight, exactly as the plain version does
    const T take = kkt ? T(1) - best_valid : T(0);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      best_x[a] = best_x[a] + take * (xp[a] - best_x[a]);
      if (at_lo[a]) best_cl_lo[a] = best_cl_lo[a] + take * (T(1) - best_cl_lo[a]);
      if (at_up[a]) best_cl_up[a] = best_cl_up[a] + take * (T(1) - best_cl_up[a]);
#pragma unroll
      for (int c = 0; c < NU; ++c)
        best_inv[a][c] = best_inv[a][c] + take * (inv[a][c] - best_inv[a][c]);
    }
    best_valid = best_valid + take;
  }
  o.failed = pd_full ? T(1) - best_valid : T(1);

  // ---- gains (back_pass.c:175-201): L = -invH (Qxu_reg' - QuuF D) - D
  T D[NU][NX], M[NU][NX];
#pragma unroll
  for (int a = 0; a < NU; ++a)
#pragma unroll
    for (int c = 0; c < NX; ++c)
      D[a][c] = best_cl_lo[a] * d.lo_s[a] * d.lo_hx[a][c] +
                best_cl_up[a] * d.up_s[a] * d.up_hx[a][c];
#pragma unroll
  for (int a = 0; a < NU; ++a)
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      T s = QuuF[a][0] * D[0][c];
#pragma unroll
      for (int e = 1; e < NU; ++e) s = s + QuuF[a][e] * D[e][c];
      M[a][c] = Qxu_reg[c][a] - s;
    }
#pragma unroll
  for (int a = 0; a < NU; ++a)
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      T s = best_inv[a][0] * M[0][c];
#pragma unroll
      for (int e = 1; e < NU; ++e) s = s + best_inv[a][e] * M[e][c];
      o.L[a][c] = -s - D[a][c];
    }
#pragma unroll
  for (int a = 0; a < NU; ++a) o.l[a] = best_x[a];

  // ---- dV (back_pass.c:204-215) ----
  T dv0 = best_x[0] * Qu[0];
#pragma unroll
  for (int a = 1; a < NU; ++a) dv0 = dv0 + best_x[a] * Qu[a];
  T dv1s = T(0);
#pragma unroll
  for (int a = 0; a < NU; ++a)
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      const T term = best_x[a] * Quu[a][c] * best_x[c];
      dv1s = (a == 0 && c == 0) ? term : dv1s + term;
    }
  o.dv0 = dv0;
  o.dv1 = T(0.5) * dv1s;
}

// The value update with the UNregularized Quu/Qxu (back_pass.c:217-241),
// Vxx symmetrized, from the Q terms and the gains o.l, o.L.
template <typename T, int NX, int NU>
__host__ __device__ __forceinline__ void riccati_value(
    const QTerms<T, NX, NU>& q, StepOut<T, NX, NU>& o) {
  const T (&Qu)[NU] = q.Qu;
  const T (&Qx)[NX] = q.Qx;
  const T (&Quu)[NU][NU] = q.Quu;
  const T (&Qxu)[NX][NU] = q.Qxu;
  const T (&Qxx)[NX][NX] = q.Qxx;
  const T (&best_x)[NU] = o.l;
  T Quu_l[NU], LQuu[NX][NU], Vxx_new[NX][NX];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    T s = Quu[a][0] * best_x[0];
#pragma unroll
    for (int c = 1; c < NU; ++c) s = s + Quu[a][c] * best_x[c];
    Quu_l[a] = s;
  }
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    T s1 = o.L[0][a] * (Quu_l[0] + Qu[0]);
#pragma unroll
    for (int c = 1; c < NU; ++c) s1 = s1 + o.L[c][a] * (Quu_l[c] + Qu[c]);
    T s2 = Qxu[a][0] * best_x[0];
#pragma unroll
    for (int c = 1; c < NU; ++c) s2 = s2 + Qxu[a][c] * best_x[c];
    o.Vx[a] = Qx[a] + s1 + s2;
#pragma unroll
    for (int e = 0; e < NU; ++e) {
      T s = o.L[0][a] * Quu[0][e];
#pragma unroll
      for (int c = 1; c < NU; ++c) s = s + o.L[c][a] * Quu[c][e];
      LQuu[a][e] = s;
    }
  }
#pragma unroll
  for (int a = 0; a < NX; ++a)
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      T s1 = LQuu[a][0] * o.L[0][c];
      T s2 = o.L[0][a] * Qxu[c][0];
      T s3 = Qxu[a][0] * o.L[0][c];
#pragma unroll
      for (int e = 1; e < NU; ++e) {
        s1 = s1 + LQuu[a][e] * o.L[e][c];
        s2 = s2 + o.L[e][a] * Qxu[c][e];
        s3 = s3 + Qxu[a][e] * o.L[e][c];
      }
      Vxx_new[a][c] = Qxx[a][c] + s1 + s2 + s3;
    }
#pragma unroll
  for (int a = 0; a < NX; ++a)
#pragma unroll
    for (int c = 0; c < NX; ++c)
      o.Vxx[a][c] = T(0.5) * (Vxx_new[a][c] + Vxx_new[c][a]);
}

// The g_norm contribution: max_a |l_a| / (|u_a| + 1).
template <typename T, int NX, int NU, class Div = PlainDiv>
__host__ __device__ __forceinline__ void riccati_g(const T (&u)[NU],
                                                   StepOut<T, NX, NU>& o,
                                                   Div div = Div()) {
  T g_k = div(fabs(o.l[0]), fabs(u[0]) + T(1));
#pragma unroll
  for (int a = 1; a < NU; ++a)
    g_k = nan_max(g_k, div(fabs(o.l[a]), fabs(u[a]) + T(1)));
  o.g = g_k;
}

template <typename T, int NX, int NU, class Box>
__host__ __device__ __forceinline__ void riccati_solve(
    const QTerms<T, NX, NU>& q, const Box& d, const T (&u)[NU],
    StepOut<T, NX, NU>& o) {
  riccati_gains<T, NX, NU>(q, d, o);
  riccati_value<T, NX, NU>(q, o);
  riccati_g<T, NX, NU>(u, o);
}

template <typename T, int NX, int NU, int REG, bool FULL>
__host__ __device__ __forceinline__ void riccati_step(
    const StepTerms<T, NX, NU>& d, const T (&u)[NU], T lam,
    const T (&Vx)[NX], const T (&Vxx)[NX][NX], StepOut<T, NX, NU>& o) {
  QTerms<T, NX, NU> q;
  riccati_q<T, NX, NU, REG, FULL>(d, lam, Vx, Vxx, q);
  riccati_solve<T, NX, NU>(q, d, u, o);
}

// The recursion's per-lane carry.
template <typename T, int NX>
struct Carry {
  T Vx[NX], Vxx[NX][NX], dv0, dv1, g, fail;
};

// Freeze after failure (back_pass.c:38-257 as pallas_backpass.py): once a
// step fails the lane's carry, dV and g stop moving.  Returns `live`, 1
// while no step has failed and 0 after; the caller writes live * l and
// live * L.
template <typename T, int NX, int NU>
__host__ __device__ __forceinline__ T advance(Carry<T, NX>& c,
                                              const StepOut<T, NX, NU>& o) {
  const T fsum = c.fail + o.failed;
  c.fail = nan_min(fsum, T(1));
  const T live = T(1) - c.fail;
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    c.Vx[a] = c.Vx[a] + live * (o.Vx[a] - c.Vx[a]);
#pragma unroll
    for (int e = 0; e < NX; ++e)
      c.Vxx[a][e] = c.Vxx[a][e] + live * (o.Vxx[a][e] - c.Vxx[a][e]);
  }
  c.dv0 = c.dv0 + live * o.dv0;
  c.dv1 = c.dv1 + live * o.dv1;
  c.g = c.g + live * o.g;
  return live;
}

}  // namespace ddp
