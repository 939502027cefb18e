// Per-lane derivatives of a CUDA model by forward mode: the work of
// ddp_generator_tpu/ops/pallas_fused.py:step_derivative_components (line
// 132), final_derivative_components (:416) and _box_limit_components (:82)
// inside kernel B3 (fused.cu).  __host__ __device__, so the host test
// tests/test_torch_dual_host.py runs this very code.
//
// Directions j = 0 .. n_x+n_u-1 are x_j, then u_{j-n_x}.  One Dual2
// evaluation per pair a <= b gives d2/da db, and on the diagonal d/da: 21
// pairs for CarParking, 3 for the (1, 1) Brachistochrone.  Symmetric
// entries are mirrored, as in JAX.  With FULL_DDP the second derivatives of
// f are folded into Vx . f** at once (riccati.cuh), after their finiteness
// is checked; without it f is evaluated once per direction on Dual.
#pragma once

#include "common.cuh"
#include "dual.cuh"
#include "riccati.cuh"

namespace ddp {

// Direction j's seed on component i of x (0 <= i < NX) or u (NX <= i).
template <typename T>
__host__ __device__ __forceinline__ T seed(int i, int j) {
  return i == j ? T(1) : T(0);
}

// limitsU (iLQG_func.tem:75-119) at (x, u): bounds relative to u, +-inf
// where no constraint binds, and dh/dx (on Dual) and the +-1 input sign of
// the binding constraint.  A bound is replaced where the new limit is
// tighter (a select, never a blend: the untightened bound is +-inf).
template <class M, typename T, typename P>
__host__ __device__ __forceinline__ void box_limits(
    const T* x, const T* u, const P* p, int k,
    StepTerms<T, M::NX, M::NU>& d) {
  constexpr int NX = M::NX, NU = M::NU;
  const T inf = T(INFINITY);
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    d.lower[a] = -inf;
    d.upper[a] = inf;
    d.lo_s[a] = d.up_s[a] = T(0);
#pragma unroll
    for (int c = 0; c < NX; ++c) d.lo_hx[a][c] = d.up_hx[a][c] = T(0);
  }
#pragma unroll
  for (int i = 0; i < M::NH; ++i) {
    const int j = M::box_index(i);
    const T s = static_cast<T>(M::box_sign(i));
    const T lim = -s * (M::h(i, x, u, p, k) - s * u[j]);
    T hx[NX];
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      Dual<T> xd[NX], ud[NU];
#pragma unroll
      for (int e = 0; e < NX; ++e) xd[e] = Dual<T>(x[e], seed<T>(e, c));
#pragma unroll
      for (int e = 0; e < NU; ++e) ud[e] = Dual<T>(u[e]);
      hx[c] = M::h(i, xd, ud, p, k).d;
    }
    if (M::box_sign(i) > 0) {
      if (lim < d.upper[j]) {
        d.upper[j] = lim;
        d.up_s[j] = s;
#pragma unroll
        for (int c = 0; c < NX; ++c) d.up_hx[j][c] = hx[c];
      }
    } else {
      if (lim > d.lower[j]) {
        d.lower[j] = lim;
        d.lo_s[j] = s;
#pragma unroll
        for (int c = 0; c < NX; ++c) d.lo_hx[j][c] = hx[c];
      }
    }
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    d.lower[a] = d.lower[a] - u[a];
    d.upper[a] = d.upper[a] - u[a];
  }
}

// Every derivative object of step k at (x, u): fx, fu, cx, cu, cxx, cuu,
// cxu, (FULL) Vx . f**, and the box limits.  L carries the hle/hli
// penalties with multipliers mu_le/mu_li and weight wpl.  Returns whether
// every object is finite (the calc_derivs ok flag over exactly the objects
// of pallas_fused.py:244-258; the box limits are not checked).
template <class M, bool FULL, typename T, typename P>
__host__ __device__ __forceinline__ bool step_derivs(
    const T* x, const T* u, const P* p, int k, const T* mu_le,
    const T* mu_li, T wpl, const T* Vx, StepTerms<T, M::NX, M::NU>& d) {
  constexpr int NX = M::NX, NU = M::NU, D = NX + NU;
  bool ok = true;
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int b = a; b < D; ++b) {
      Dual2<T> xd[NX], ud[NU];
#pragma unroll
      for (int e = 0; e < NX; ++e)
        xd[e] = Dual2<T>(x[e], seed<T>(e, a), seed<T>(e, b), T(0));
#pragma unroll
      for (int e = 0; e < NU; ++e)
        ud[e] = Dual2<T>(u[e], seed<T>(NX + e, a), seed<T>(NX + e, b), T(0));
      const Dual2<T> c = aug_L<M>(xd, ud, p, k, mu_le, mu_li, wpl);
      ok = ok && is_finite(c.d12);
      if (b < NX) {
        d.cxx[a][b] = d.cxx[b][a] = c.d12;
      } else if (a < NX) {
        d.cxu[a][b - NX] = c.d12;
      } else {
        d.cuu[a - NX][b - NX] = d.cuu[b - NX][a - NX] = c.d12;
      }
      if (a == b) {
        ok = ok && is_finite(c.d1);
        if (a < NX)
          d.cx[a] = c.d1;
        else
          d.cu[a - NX] = c.d1;
      }
      if (FULL) {
        Dual2<T> fn[NX];
        M::f(xd, ud, p, k, fn);
        T s = Vx[0] * fn[0].d12;
        ok = ok && is_finite(fn[0].d12);
#pragma unroll
        for (int i = 1; i < NX; ++i) {
          s = s + Vx[i] * fn[i].d12;
          ok = ok && is_finite(fn[i].d12);
        }
        if (b < NX) {
          d.vfxx[a][b] = d.vfxx[b][a] = s;
        } else if (a < NX) {
          d.vfxu[a][b - NX] = s;
        } else {
          d.vfuu[a - NX][b - NX] = d.vfuu[b - NX][a - NX] = s;
        }
        if (a == b) {
#pragma unroll
          for (int i = 0; i < NX; ++i) {
            ok = ok && is_finite(fn[i].d1);
            if (a < NX)
              d.fx[i][a] = fn[i].d1;
            else
              d.fu[i][a - NX] = fn[i].d1;
          }
        }
      }
    }
  }
  if (!FULL) {
#pragma unroll
    for (int a = 0; a < D; ++a) {
      Dual<T> xd[NX], ud[NU], fn[NX];
#pragma unroll
      for (int e = 0; e < NX; ++e) xd[e] = Dual<T>(x[e], seed<T>(e, a));
#pragma unroll
      for (int e = 0; e < NU; ++e) ud[e] = Dual<T>(u[e], seed<T>(NX + e, a));
      M::f(xd, ud, p, k, fn);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        ok = ok && is_finite(fn[i].d);
        if (a < NX)
          d.fx[i][a] = fn[i].d;
        else
          d.fu[i][a - NX] = fn[i].d;
      }
    }
  }
  box_limits<M>(x, u, p, k, d);
  return ok;
}

// Fx and Fxx of the AL-augmented final cost at xf (k = N), hfe/hfi with
// multipliers mu_fe/mu_fi and weight wpf.  Returns whether both are finite.
template <class M, typename T, typename P>
__host__ __device__ __forceinline__ bool final_derivs(
    const T* xf, const P* p, int N, const T* mu_fe, const T* mu_fi, T wpf,
    T (&Fx)[M::NX], T (&Fxx)[M::NX][M::NX]) {
  constexpr int NX = M::NX;
  bool ok = true;
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int b = a; b < NX; ++b) {
      Dual2<T> xd[NX];
#pragma unroll
      for (int e = 0; e < NX; ++e)
        xd[e] = Dual2<T>(xf[e], seed<T>(e, a), seed<T>(e, b), T(0));
      const Dual2<T> c = aug_F<M>(xd, p, N, mu_fe, mu_fi, wpf);
      Fxx[a][b] = Fxx[b][a] = c.d12;
      ok = ok && is_finite(c.d12);
      if (a == b) {
        Fx[a] = c.d1;
        ok = ok && is_finite(c.d1);
      }
    }
  }
  return ok;
}

}  // namespace ddp
