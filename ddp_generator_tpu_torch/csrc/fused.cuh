// Kernel B3's operands, its per-lane reference and its producers' tile
// work.  __host__ __device__, so tests/test_torch_dual_host.py runs them on
// the CPU: fused_lane is the one-thread-per-lane backward pass B3 ran
// before it was staged (kept as the reference the staged kernel must equal
// bit for bit), fused_fill the work items B3's producer warps share.
#pragma once

#include "common.cuh"
#include "derivs.cuh"
#include "riccati.cuh"
#include "staged.cuh"

namespace ddp {

template <typename T>
struct FusedArgs {
  const T* x;       // (N, NX, B)  nominal states x_0 .. x_{N-1}
  const T* u;       // (N, NU, B)
  const T* mu_le;   // (N, NHLE, B)
  const T* mu_li;   // (N, NHLI, B)
  const T* xf;      // (NX, B)     x_N
  const T* wpl;     // (1, B)      derivative-time penalty weights
  const T* wpf;     // (1, B)
  const T* lam;     // (1, B)
  const T* mu_fe;   // (NHFE, B)
  const T* mu_fi;   // (NHFI, B)
  const T* params;  // flat, model order (models/*.cuh)
  T* l;             // (N, NU, B)
  T* L;             // (N, NU*NX, B)
  T* dV;            // (2, B)
  T* g_norm;        // (1, B)
  bool* failed;     // (1, B)
  bool* derivs_ok;  // (1, B)
  int N, B;
};

// The carry at t = N: Fx/Fxx of the AL-augmented F at x_N (bp_derivsF
// role), accumulators 0.  Returns whether Fx and Fxx are finite.
template <class M, typename T>
__host__ __device__ __forceinline__ bool fused_lane_start(
    const FusedArgs<T>& A, const T* p, int b, Carry<T, M::NX>& c) {
  constexpr int NX = M::NX;
  const int B = A.B;
  T xf[NX], mu_fe[arr(M::NHFE)] = {}, mu_fi[arr(M::NHFI)] = {};
#pragma unroll
  for (int a = 0; a < NX; ++a) xf[a] = A.xf[a * B + b];
#pragma unroll
  for (int i = 0; i < M::NHFE; ++i) mu_fe[i] = A.mu_fe[i * B + b];
#pragma unroll
  for (int i = 0; i < M::NHFI; ++i) mu_fi[i] = A.mu_fi[i * B + b];
  const bool ok =
      final_derivs<M>(xf, p, A.N, mu_fe, mu_fi, A.wpf[b], c.Vx, c.Vxx);
  c.dv0 = c.dv1 = c.g = c.fail = T(0);
  return ok;
}

// The nominal point and running multipliers of (step k, lane b).
template <class M, typename T>
__host__ __device__ __forceinline__ void load_point(
    const FusedArgs<T>& A, int k, int b, T (&x)[M::NX], T (&u)[M::NU],
    T (&mu_le)[arr(M::NHLE)], T (&mu_li)[arr(M::NHLI)]) {
  const int B = A.B;
  const size_t kb = static_cast<size_t>(k);
#pragma unroll
  for (int a = 0; a < M::NX; ++a) x[a] = A.x[(kb * M::NX + a) * B + b];
#pragma unroll
  for (int a = 0; a < M::NU; ++a) u[a] = A.u[(kb * M::NU + a) * B + b];
#pragma unroll
  for (int i = 0; i < M::NHLE; ++i)
    mu_le[i] = A.mu_le[(kb * M::NHLE + i) * B + b];
#pragma unroll
  for (int i = 0; i < M::NHLI; ++i)
    mu_li[i] = A.mu_li[(kb * M::NHLI + i) * B + b];
}

// Lane b's whole backward pass on one thread, parameters at p.
template <class M, typename T, int REG, bool FULL>
__host__ __device__ __forceinline__ void fused_lane(const FusedArgs<T>& A,
                                                    const T* p, int b) {
  constexpr int NX = M::NX, NU = M::NU;
  const int N = A.N, B = A.B;
  const T wpl = A.wpl[b], lam = A.lam[b];
  Carry<T, NX> c;
  bool dok = fused_lane_start<M>(A, p, b, c);

  for (int t = N - 1; t >= 0; --t) {
    const size_t kb = static_cast<size_t>(t);
    T x[NX], u[NU], mu_le[arr(M::NHLE)] = {}, mu_li[arr(M::NHLI)] = {};
    load_point<M>(A, t, b, x, u, mu_le, mu_li);
    StepTerms<T, NX, NU> d;
    const bool ok_t =
        step_derivs<M, FULL>(x, u, p, t, mu_le, mu_li, wpl, c.Vx, d);
    dok = dok && ok_t;
    StepOut<T, NX, NU> so;
    riccati_step<T, NX, NU, REG, FULL>(d, u, lam, c.Vx, c.Vxx, so);
    const T live = advance(c, so);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      A.l[(kb * NU + a) * B + b] = live * so.l[a];
#pragma unroll
      for (int e = 0; e < NX; ++e)
        A.L[(kb * NU * NX + a * NX + e) * B + b] = live * so.L[a][e];
    }
  }
  finish_lane(c, N, B, b, A.dV, A.g_norm, A.failed);
  A.derivs_ok[b] = dok;
}

template <class M, typename T, int REG, bool FULL>
__host__ __device__ __forceinline__ void fused_lane(const FusedArgs<T>& A,
                                                    int b) {
  with_params<M>(A.params, [&](const T* p) {
    fused_lane<M, T, REG, FULL>(A, p, b);
  });
}

// Tile (t0, lanes b0 ..) of B3's terms into a slot (staged.cuh: Terms
// order, [term][step][lane]).  This caller runs items first, first +
// stride, ... of the tile's items_per_point() x S x kLanes, ordered item
// kind outermost so that a warp's 32 threads run one kind.  An item whose
// terms are not all finite clears ok[g] of its lane (an AND over every
// item, in any order).  Steps t < 0 and lanes >= B are skipped.
template <class M, bool FULL, int S, typename T>
__host__ __device__ __forceinline__ void fused_fill(const FusedArgs<T>& A,
                                                    const T* p, int t0,
                                                    int b0, T* slot, int* ok,
                                                    int first, int stride) {
  constexpr int NX = M::NX, NU = M::NU;
  // (step, lane) points of a tile, and the slot stride between terms
  constexpr int TS = S * kLanes;
  for (int i = first; i < items_per_point<M, FULL>() * TS; i += stride) {
    const int kind = i / TS, s = (i % TS) / kLanes, g = i % kLanes;
    const int t = t0 - s, b = b0 + g;
    if (t < 0 || b >= A.B) continue;
    T x[NX], u[NU], mu_le[arr(M::NHLE)] = {}, mu_li[arr(M::NHLI)] = {};
    load_point<M>(A, t, b, x, u, mu_le, mu_li);
    if (!point_item<M, FULL>(x, u, p, t, mu_le, mu_li, A.wpl[b], kind,
                             slot + s * kLanes + g, TS))
      ok[g] = 0;
  }
}

}  // namespace ddp
