// Per-lane derivatives of a CUDA model by forward mode: the work of
// ddp_generator_tpu/ops/pallas_fused.py:step_derivative_components (line
// 132), final_derivative_components (:416) and _box_limit_components (:82)
// inside kernel B3 (fused.cu): step_derivs (all of a step, the reference)
// and the work items pair_item, dyn_item and box_item that B3's producer
// warps run.  __host__ __device__, so the host test
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
#include "staged.cuh"

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

// ---- step_derivs cut into the work items of B3's producers ----
//
// Each writes its own terms of step k into a column q (staged.cuh: Terms
// order; term j at q[j * ts]: a slot's column in B3, the packed bundle's
// in the emission kernel, emit.cuh) and returns whether those it checks
// are finite.  Same arithmetic as step_derivs, with the direction pair
// (a, b) or direction a a runtime value: the seeds are exactly 0 or 1
// either way, so every value is bit for bit step_derivs'.  Where
// step_derivs folds f** into Vx . f**, pair_item writes the raw components;
// the consumer contracts them with its carried Vx in the same order.

// Pair a <= b of the D = NX+NU directions: d2/da db of the augmented L
// (cxx, cxu or cuu), d/da on the diagonal (cx or cu); with FULL, the same
// of every output of f (f**, and fx or fu on the diagonal).
template <class M, bool FULL, typename T, typename P, typename I>
__host__ __device__ __forceinline__ bool pair_item(
    const T* x, const T* u, const P* p, int k, const T* mu_le,
    const T* mu_li, T wpl, int a, int b, T* q, I ts) {
  constexpr int NX = M::NX, NU = M::NU;
  using K = Terms<NX, NU, FULL>;
  Dual2<T> xd[NX], ud[NU];
#pragma unroll
  for (int e = 0; e < NX; ++e)
    xd[e] = Dual2<T>(x[e], seed<T>(e, a), seed<T>(e, b), T(0));
#pragma unroll
  for (int e = 0; e < NU; ++e)
    ud[e] = Dual2<T>(u[e], seed<T>(NX + e, a), seed<T>(NX + e, b), T(0));
  const Dual2<T> c = aug_L<M>(xd, ud, p, k, mu_le, mu_li, wpl);
  bool ok = is_finite(c.d12);
  const int cterm = b < NX ? K::CXX + tri(a, b, NX)
                           : (a < NX ? K::CXU + a * NU + (b - NX)
                                     : K::CUU + tri(a - NX, b - NX, NU));
  q[cterm * ts] = c.d12;
  if (a == b) {
    ok = ok && is_finite(c.d1);
    q[(a < NX ? K::CX + a : K::CU + a - NX) * ts] = c.d1;
  }
  if (FULL) {
    Dual2<T> fn[NX];
    M::f(xd, ud, p, k, fn);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      ok = ok && is_finite(fn[i].d12);
      const int term =
          b < NX ? K::FXX + i * K::TX + tri(a, b, NX)
                 : (a < NX ? K::FXU + (i * NX + a) * NU + (b - NX)
                           : K::FUU + i * K::TU + tri(a - NX, b - NX, NU));
      q[term * ts] = fn[i].d12;
      if (a == b) {
        ok = ok && is_finite(fn[i].d1);
        q[(a < NX ? K::FX + i * NX + a : K::FU + i * NU + a - NX) * ts] =
            fn[i].d1;
      }
    }
  }
  return ok;
}

// Without FULL: direction a of f on Dual, the column a of fx or fu.
template <class M, bool FULL, typename T, typename P, typename I>
__host__ __device__ __forceinline__ bool dyn_item(const T* x, const T* u,
                                                  const P* p, int k, int a,
                                                  T* q, I ts) {
  constexpr int NX = M::NX, NU = M::NU;
  using K = Terms<NX, NU, FULL>;
  Dual<T> xd[NX], ud[NU], fn[NX];
#pragma unroll
  for (int e = 0; e < NX; ++e) xd[e] = Dual<T>(x[e], seed<T>(e, a));
#pragma unroll
  for (int e = 0; e < NU; ++e) ud[e] = Dual<T>(u[e], seed<T>(NX + e, a));
  M::f(xd, ud, p, k, fn);
  bool ok = true;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    ok = ok && is_finite(fn[i].d);
    q[(a < NX ? K::FX + i * NX + a : K::FU + i * NU + a - NX) * ts] =
        fn[i].d;
  }
  return ok;
}

// The box limits of step k (not checked for finiteness, as in
// step_derivs), and u itself.
template <class M, bool FULL, typename T, typename P, typename I>
__host__ __device__ __forceinline__ void box_item(const T* x, const T* u,
                                                  const P* p, int k, T* q,
                                                  I ts) {
  constexpr int NX = M::NX, NU = M::NU;
  using K = Terms<NX, NU, FULL>;
  StepTerms<T, NX, NU> d;
  box_limits<M>(x, u, p, k, d);
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    q[(K::LOWER + a) * ts] = d.lower[a];
    q[(K::UPPER + a) * ts] = d.upper[a];
    q[(K::LO_S + a) * ts] = d.lo_s[a];
    q[(K::UP_S + a) * ts] = d.up_s[a];
    q[(K::U + a) * ts] = u[a];
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      q[(K::LO_HX + a * NX + c) * ts] = d.lo_hx[a][c];
      q[(K::UP_HX + a * NX + c) * ts] = d.up_hx[a][c];
    }
  }
}

// Work items of one (step, lane): the D(D+1)/2 direction pairs, without
// FULL the D directions of f, then the box limits.
template <class M, bool FULL>
__host__ __device__ constexpr int items_per_point() {
  constexpr int D = M::NX + M::NU;
  return D * (D + 1) / 2 + (FULL ? 0 : D) + 1;
}

// Work item `kind` of (step k, lane) at (x, u): pair tri(a, b, D) for kind
// < D(D+1)/2, then (without FULL) direction kind - D(D+1)/2 of f, then the
// box limits and u.  Returns whether the terms it checks are finite.
template <class M, bool FULL, typename T, typename P, typename I>
__host__ __device__ __forceinline__ bool point_item(
    const T* x, const T* u, const P* p, int k, const T* mu_le,
    const T* mu_li, T wpl, int kind, T* q, I ts) {
  constexpr int D = M::NX + M::NU, NPAIR = D * (D + 1) / 2;
  if (kind < NPAIR) {
    int a = 0, r = kind;  // kind = tri(a, a + r, D)
    while (r >= D - a) {
      r -= D - a;
      ++a;
    }
    return pair_item<M, FULL>(x, u, p, k, mu_le, mu_li, wpl, a, a + r, q,
                              ts);
  }
  if (!FULL && kind < NPAIR + D)
    return dyn_item<M, FULL>(x, u, p, k, kind - NPAIR, q, ts);
  box_item<M, FULL>(x, u, p, k, q, ts);
  return true;
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
