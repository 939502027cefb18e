// Kernel B1: the whole DDP backward pass, one thread per batch lane.
//
// Replaces ddp_generator_tpu/ops/pallas_backpass.py:pallas_back_pass_cm
// (pl.pallas_call at line 682; math in riccati_step, _sym_solve_small and
// _patterns).  The TPU kernel walked time as a sequential grid and carried
// Vx/Vxx in VMEM scratch; here each thread loops t = N-1 .. 0 and keeps
// Vx/Vxx, dV, g and the failure flag in registers.
//
// What bounds it on an H100: latency, not bandwidth.  Each step needs the
// previous step's value function, so a lane is one long dependent chain of
// ~2k flops per step, and B=2048 lanes are only 64 warps.  The bundle
// (~160 components per step) is read once, coalesced: component c of step
// t for lane b sits at c*N*B + t*B + b, so a warp reads 32 consecutive
// values.  Small blocks (32 threads, chosen by the wrapper) spread those
// warps over as many SMs as possible.
//
// Semantics (back_pass.c:38-257, as pallas_backpass.py):
//  * Q with the FULL_DDP tensor terms; regType 1 (Quu + lam*I) or 2
//    (Quu + lam*fu'fu, Qxu + lam*fx'fu);
//  * boxQP as exact active-set enumeration over the 3^n_u clamp patterns,
//    sorted by the number of clamped inputs; the first pattern passing the
//    KKT check wins; closed-form free-block inverses with the PD gates
//    a>0, det>0, m2>0; nothing stored for clamped rows/columns;
//  * the step fails if the full H is not PD or no pattern is valid; from
//    then on the lane writes zeros and its carry, dV and g freeze;
//  * clamped gains through the state-dependent bounds, the value update
//    with the UNregularized Quu/Qxu, Vxx symmetrized, g_norm / (N-1).
// Every sum runs in the index order of the plain PyTorch version.
#include "common.cuh"

namespace ddp {
namespace {

template <typename T>
struct BackpassArgs {
  // inputs, component-outer (C, N, B); cxx, cuu and the last two axes of
  // fxx/fuu packed as row-major upper triangles
  const T *fx, *fu, *cx, *cu, *cxx, *cuu, *cxu, *fxx, *fuu, *fxu;
  const T *lower, *upper, *lo_hx, *up_hx, *lo_s, *up_s;
  const T* us;         // (n_u, N, B)
  const T* lam;        // (1, B)
  const T* final_cx;   // (n_x, B)
  const T* final_cxx;  // (n_x*n_x, B)
  // outputs, (N, C, B)
  T* l;                // (N, n_u, B)
  T* L;                // (N, n_u*n_x, B)
  T* dV;               // (2, B)
  T* g_norm;           // (1, B)
  bool* failed;        // (1, B)
  int N, B;
};

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

// Closed-form solve on the free block of H (upper triangle read), with the
// PD gates of pallas_backpass.py:_sym_solve_small.  inv receives the
// free-block inverse at global indices and zero elsewhere.
template <typename T, int NU>
__host__ __device__ __forceinline__ void sym_solve(const T (&H)[NU][NU],
                                                   const T (&rhs)[NU],
                                                   const bool (&free_)[NU],
                                                   T (&x)[NU], bool& ok,
                                                   T (&inv)[NU][NU]) {
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
    s[0][0] = T(1) / (ok ? a : T(1));
  } else if (m == 2) {
    const T a = h(0, 0), b = h(0, 1), d = h(1, 1);
    const T det = a * d - b * b;
    ok = (a > T(0)) && (det > T(0));
    const T sdet = ok ? det : T(1);
    s[0][0] = d / sdet;
    s[0][1] = -b / sdet;
    s[1][1] = a / sdet;
  } else {
    const T a = h(0, 0), b = h(0, 1), c = h(0, 2);
    const T d = h(1, 1), e = h(1, 2), f = h(2, 2);
    const T m2 = a * d - b * b;
    const T det =
        a * (d * f - e * e) - b * (b * f - c * e) + c * (b * e - c * d);
    ok = (a > T(0)) && (m2 > T(0)) && (det > T(0));
    const T sdet = ok ? det : T(1);
    s[0][0] = (d * f - e * e) / sdet;
    s[0][1] = (c * e - b * f) / sdet;
    s[0][2] = (b * e - c * d) / sdet;
    s[1][1] = (a * f - c * c) / sdet;
    s[1][2] = (b * c - a * e) / sdet;
    s[2][2] = (a * d - b * b) / sdet;
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

template <typename T, int NX, int NU, int REG, bool FULL>
__host__ __device__ void backpass_lane(const BackpassArgs<T>& A, int b) {
  constexpr int TX = NX * (NX + 1) / 2, TU = NU * (NU + 1) / 2;
  constexpr int NP = pow3(NU);
  const int N = A.N, B = A.B;
  const size_t NB = static_cast<size_t>(N) * B;

  T Vx[NX], Vxx[NX][NX];
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    Vx[a] = A.final_cx[a * B + b];
#pragma unroll
    for (int c = 0; c < NX; ++c) Vxx[a][c] = A.final_cxx[(a * NX + c) * B + b];
  }
  T dv0_acc = T(0), dv1_acc = T(0), g_acc = T(0), fail = T(0);
  const T lam = A.lam[b];

  for (int t = N - 1; t >= 0; --t) {
    const size_t o = static_cast<size_t>(t) * B + b;
    auto ld = [&](const T* p, int comp) -> T {
      return p[static_cast<size_t>(comp) * NB + o];
    };
    // ---- loads (one coalesced read per component) ----
    T fx[NX][NX], fu[NX][NU], cx[NX], cu[NU], cxx[NX][NX], cuu[NU][NU],
        cxu[NX][NU];
#pragma unroll
    for (int a = 0; a < NX; ++a) {
      cx[a] = ld(A.cx, a);
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        fx[a][c] = ld(A.fx, a * NX + c);
        cxx[a][c] = ld(A.cxx, tri(a, c, NX));
      }
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        fu[a][c] = ld(A.fu, a * NU + c);
        cxu[a][c] = ld(A.cxu, a * NU + c);
      }
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      cu[a] = ld(A.cu, a);
#pragma unroll
      for (int c = 0; c < NU; ++c) cuu[a][c] = ld(A.cuu, tri(a, c, NU));
    }
    T lower[NU], upper[NU], lo_hx[NU][NX], up_hx[NU][NX], lo_s[NU], up_s[NU],
        u[NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      lower[a] = ld(A.lower, a);
      upper[a] = ld(A.upper, a);
      lo_s[a] = ld(A.lo_s, a);
      up_s[a] = ld(A.up_s, a);
      u[a] = ld(A.us, a);
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        lo_hx[a][c] = ld(A.lo_hx, a * NX + c);
        up_hx[a][c] = ld(A.up_hx, a * NX + c);
      }
    }

    // ---- Q build (back_pass.c:80-131) ----
    T vfx[NX][NX], vfu[NX][NU];
#pragma unroll
    for (int a = 0; a < NX; ++a) {
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        T s = Vxx[a][0] * fx[0][c];
#pragma unroll
        for (int i = 1; i < NX; ++i) s = s + Vxx[a][i] * fx[i][c];
        vfx[a][c] = s;
      }
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        T s = Vxx[a][0] * fu[0][c];
#pragma unroll
        for (int i = 1; i < NX; ++i) s = s + Vxx[a][i] * fu[i][c];
        vfu[a][c] = s;
      }
    }
    T Qu[NU], Qx[NX], Qxu[NX][NU], Quu[NU][NU], Qxx[NX][NX];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      T s = fu[0][a] * Vx[0];
#pragma unroll
      for (int i = 1; i < NX; ++i) s = s + fu[i][a] * Vx[i];
      Qu[a] = cu[a] + s;
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        T q = fu[0][a] * vfu[0][c];
#pragma unroll
        for (int i = 1; i < NX; ++i) q = q + fu[i][a] * vfu[i][c];
        Quu[a][c] = cuu[a][c] + q;
      }
    }
#pragma unroll
    for (int a = 0; a < NX; ++a) {
      T s = fx[0][a] * Vx[0];
#pragma unroll
      for (int i = 1; i < NX; ++i) s = s + fx[i][a] * Vx[i];
      Qx[a] = cx[a] + s;
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        T q = fx[0][a] * vfu[0][c];
#pragma unroll
        for (int i = 1; i < NX; ++i) q = q + fx[i][a] * vfu[i][c];
        Qxu[a][c] = cxu[a][c] + q;
      }
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        T q = fx[0][a] * vfx[0][c];
#pragma unroll
        for (int i = 1; i < NX; ++i) q = q + fx[i][a] * vfx[i][c];
        Qxx[a][c] = cxx[a][c] + q;
      }
    }
    if (FULL) {
      // + Vx . f**: contraction over the dynamics output index
#pragma unroll
      for (int a = 0; a < NX; ++a) {
#pragma unroll
        for (int c = 0; c < NU; ++c) {
          T s = Vx[0] * ld(A.fxu, (0 * NX + a) * NU + c);
#pragma unroll
          for (int i = 1; i < NX; ++i)
            s = s + Vx[i] * ld(A.fxu, (i * NX + a) * NU + c);
          Qxu[a][c] = Qxu[a][c] + s;
        }
#pragma unroll
        for (int c = 0; c < NX; ++c) {
          T s = Vx[0] * ld(A.fxx, 0 * TX + tri(a, c, NX));
#pragma unroll
          for (int i = 1; i < NX; ++i)
            s = s + Vx[i] * ld(A.fxx, i * TX + tri(a, c, NX));
          Qxx[a][c] = Qxx[a][c] + s;
        }
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
#pragma unroll
        for (int c = 0; c < NU; ++c) {
          T s = Vx[0] * ld(A.fuu, 0 * TU + tri(a, c, NU));
#pragma unroll
          for (int i = 1; i < NX; ++i)
            s = s + Vx[i] * ld(A.fuu, i * TU + tri(a, c, NU));
          Quu[a][c] = Quu[a][c] + s;
        }
      }
    }

    // ---- regularization (back_pass.c:133-159) ----
    T QuuF[NU][NU], Qxu_reg[NX][NU];
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        if (REG == 2) {
          T s = fu[0][a] * fu[0][c];
#pragma unroll
          for (int i = 1; i < NX; ++i) s = s + fu[i][a] * fu[i][c];
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
          T s = fx[0][a] * fu[0][c];
#pragma unroll
          for (int i = 1; i < NX; ++i) s = s + fx[i][a] * fu[i][c];
          Qxu_reg[a][c] = Qxu[a][c] + lam * s;
        } else {
          Qxu_reg[a][c] = Qxu[a][c];
        }
      }
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
    sym_solve<T, NU>(QuuF, neg_qu, all_free, x_free, pd_full, inv_full);

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
      const int code = pattern_code(NU, p);
      bool fr[NU], at_lo[NU], at_up[NU];
      T xc[NU];
      bool bound_ok = true, any_free_clamped = false;
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        const int d = digit(code, NU, a);
        fr[a] = d == 0;
        at_lo[a] = d == 1;
        at_up[a] = d == 2;
        if (at_lo[a]) {
          const bool ok_a = is_finite(lower[a]);
          xc[a] = ok_a ? lower[a] : T(0);
          bound_ok = bound_ok && ok_a;
        } else if (at_up[a]) {
          const bool ok_a = is_finite(upper[a]);
          xc[a] = ok_a ? upper[a] : T(0);
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
        sym_solve<T, NU>(QuuF, rhs, fr, xf, pd_ok, inv);
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
          kkt = kkt && (xp[a] >= lower[a]) && (xp[a] <= upper[a]);
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
    const T step_failed = pd_full ? T(1) - best_valid : T(1);

    // ---- gains (back_pass.c:175-201): L = -invH (Qxu_reg' - QuuF D) - D
    T D[NU][NX], M[NU][NX], Lk[NU][NX];
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int c = 0; c < NX; ++c)
        D[a][c] = best_cl_lo[a] * lo_s[a] * lo_hx[a][c] +
                  best_cl_up[a] * up_s[a] * up_hx[a][c];
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
        Lk[a][c] = -s - D[a][c];
      }

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
    const T dv1 = T(0.5) * dv1s;

    // ---- value update with the UNregularized Quu/Qxu (back_pass.c:217-241)
    T Quu_l[NU], Vx_new[NX], LQuu[NX][NU], Vxx_new[NX][NX];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      T s = Quu[a][0] * best_x[0];
#pragma unroll
      for (int c = 1; c < NU; ++c) s = s + Quu[a][c] * best_x[c];
      Quu_l[a] = s;
    }
#pragma unroll
    for (int a = 0; a < NX; ++a) {
      T s1 = Lk[0][a] * (Quu_l[0] + Qu[0]);
#pragma unroll
      for (int c = 1; c < NU; ++c) s1 = s1 + Lk[c][a] * (Quu_l[c] + Qu[c]);
      T s2 = Qxu[a][0] * best_x[0];
#pragma unroll
      for (int c = 1; c < NU; ++c) s2 = s2 + Qxu[a][c] * best_x[c];
      Vx_new[a] = Qx[a] + s1 + s2;
#pragma unroll
      for (int d = 0; d < NU; ++d) {
        T s = Lk[0][a] * Quu[0][d];
#pragma unroll
        for (int c = 1; c < NU; ++c) s = s + Lk[c][a] * Quu[c][d];
        LQuu[a][d] = s;
      }
    }
#pragma unroll
    for (int a = 0; a < NX; ++a)
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        T s1 = LQuu[a][0] * Lk[0][c];
        T s2 = Lk[0][a] * Qxu[c][0];
        T s3 = Qxu[a][0] * Lk[0][c];
#pragma unroll
        for (int e = 1; e < NU; ++e) {
          s1 = s1 + LQuu[a][e] * Lk[e][c];
          s2 = s2 + Lk[e][a] * Qxu[c][e];
          s3 = s3 + Qxu[a][e] * Lk[e][c];
        }
        Vxx_new[a][c] = Qxx[a][c] + s1 + s2 + s3;
      }

    // ---- g_norm contribution: max_a |l_a| / (|u_a| + 1) ----
    T g_k = fabs(best_x[0]) / (fabs(u[0]) + T(1));
#pragma unroll
    for (int a = 1; a < NU; ++a)
      g_k = nan_max(g_k, fabs(best_x[a]) / (fabs(u[a]) + T(1)));

    // ---- freeze after failure; outputs zero once failed ----
    const T fsum = fail + step_failed;
    fail = nan_min(fsum, T(1));
    const T live = T(1) - fail;
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      A.l[(static_cast<size_t>(t) * NU + a) * B + b] = live * best_x[a];
#pragma unroll
      for (int c = 0; c < NX; ++c)
        A.L[(static_cast<size_t>(t) * NU * NX + a * NX + c) * B + b] =
            live * Lk[a][c];
    }
#pragma unroll
    for (int a = 0; a < NX; ++a) {
      Vx[a] = Vx[a] + live * (Vx_new[a] - Vx[a]);
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        const T sym = T(0.5) * (Vxx_new[a][c] + Vxx_new[c][a]);
        Vxx[a][c] = Vxx[a][c] + live * (sym - Vxx[a][c]);
      }
    }
    dv0_acc = dv0_acc + live * dv0;
    dv1_acc = dv1_acc + live * dv1;
    g_acc = g_acc + live * g_k;
  }
  A.dV[b] = dv0_acc;
  A.dV[B + b] = dv1_acc;
  A.g_norm[b] = g_acc / static_cast<T>(N - 1);
  A.failed[b] = fail > T(0);
}

template <typename T, int NX, int NU, int REG, bool FULL>
__global__ void backpass_kernel(const BackpassArgs<T> args) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < args.B) backpass_lane<T, NX, NU, REG, FULL>(args, b);
}

template <typename T, int NX, int NU>
int launch_shape(int reg_type, bool full_ddp, const BackpassArgs<T>& args,
                 int block, cudaStream_t stream) {
  const unsigned grid = grid_for(args.B, block);
  if (reg_type == 1 && full_ddp)
    backpass_kernel<T, NX, NU, 1, true><<<grid, block, 0, stream>>>(args);
  else if (reg_type == 1)
    backpass_kernel<T, NX, NU, 1, false><<<grid, block, 0, stream>>>(args);
  else if (reg_type == 2 && full_ddp)
    backpass_kernel<T, NX, NU, 2, true><<<grid, block, 0, stream>>>(args);
  else if (reg_type == 2)
    backpass_kernel<T, NX, NU, 2, false><<<grid, block, 0, stream>>>(args);
  else
    return kBadVariant;
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int n_x, int n_u, int reg_type, bool full_ddp, int N, int B,
           int block, void* const* p, cudaStream_t stream) {
  BackpassArgs<T> a;
  auto in = [&](int i) { return static_cast<const T*>(p[i]); };
  auto out = [&](int i) { return static_cast<T*>(p[i]); };
  a.fx = in(0);  a.fu = in(1);  a.cx = in(2);  a.cu = in(3);
  a.cxx = in(4); a.cuu = in(5); a.cxu = in(6);
  a.fxx = in(7); a.fuu = in(8); a.fxu = in(9);
  a.lower = in(10); a.upper = in(11); a.lo_hx = in(12); a.up_hx = in(13);
  a.lo_s = in(14);  a.up_s = in(15);
  a.us = in(16); a.lam = in(17); a.final_cx = in(18); a.final_cxx = in(19);
  a.l = out(20); a.L = out(21); a.dV = out(22); a.g_norm = out(23);
  a.failed = static_cast<bool*>(p[24]);
  a.N = N;
  a.B = B;
  for (int i = 0; i < 25; ++i) {
    const bool full_only = i >= 7 && i <= 9;
    if (p[i] == nullptr && !(full_only && !full_ddp)) return kNullPointer;
  }
  if (n_x == 4 && n_u == 2)
    return launch_shape<T, 4, 2>(reg_type, full_ddp, a, block, stream);
  if (n_x == 4 && n_u == 1)
    return launch_shape<T, 4, 1>(reg_type, full_ddp, a, block, stream);
  if (n_x == 1 && n_u == 1)
    return launch_shape<T, 1, 1>(reg_type, full_ddp, a, block, stream);
  return kBadVariant;
}

}  // namespace
}  // namespace ddp

// ---- C interface ----
//
// ptrs: fx, fu, cx, cu, cxx, cuu, cxu, fxx, fuu, fxu, lower, upper,
// lower_hx, upper_hx, lower_sign, upper_sign, us, lam, final_cx, final_cxx,
// then the outputs l, L, dV, g_norm, failed (fxx/fuu/fxu NULL when
// full_ddp == 0).  dtype: 0 float32, 1 float64.  Launches on `stream`,
// does not synchronize, returns cudaGetLastError() or a negative ddp code.
extern "C" int ddp_backpass(int dtype, int n_x, int n_u, int reg_type,
                            int full_ddp, int N, int B, int block,
                            void* const* ptrs, void* stream) {
  if (N < 1 || B < 1 || block < 1 || block > 1024) return ddp::kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ddp::launch<float>(n_x, n_u, reg_type, full_ddp != 0, N, B, block,
                              ptrs, s);
  if (dtype == 1)
    return ddp::launch<double>(n_x, n_u, reg_type, full_ddp != 0, N, B, block,
                               ptrs, s);
  return ddp::kBadDtype;
}

extern "C" const char* ddp_error_string(int code) {
  switch (code) {
    case ddp::kBadShape: return "N, B or block size out of range";
    case ddp::kBadDtype: return "dtype code must be 0 (float32) or 1 (float64)";
    case ddp::kBadVariant: return "no kernel instantiated for these widths/options/model";
    case ddp::kNullPointer: return "a required operand pointer is NULL";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
