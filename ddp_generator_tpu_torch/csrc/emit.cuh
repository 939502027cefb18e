// Derivative emission of the kernel path: the packed component-major bundle
// kernel B1 reads (ops/cuda_backpass.py: _BUNDLE_KEYS, then u), the final
// Fx/Fxx and the per-lane ok flag, from the problem's CUDA model.  The
// arithmetic is kernel B3's: every term comes from derivs.cuh's work items
// (point_item: pair_item, dyn_item, box_item) and final_derivs, here
// written to global memory instead of a shared-memory slot.
// __host__ __device__, so tests/test_torch_emit_host.py runs this very code.
//
// Layouts: operands batch-major as the solver holds them (xs (B, N+1, NX),
// us (B, N, NU), mu_le/mu_li (B, N, n), mu_fe/mu_fi (B, n), wpl/wpf (B,));
// the bundle (NT, N, B), Terms order (staged.cuh) with u last, batch
// contiguous: term j of point pt = t*B + b lies at j*N*B + pt, so threads
// that take consecutive points write consecutive addresses at any width.
#pragma once

#include <stddef.h>

#include "common.cuh"
#include "derivs.cuh"
#include "staged.cuh"

namespace ddp {

template <typename T>
struct EmitArgs {
  const T* xs;      // (B, N+1, NX)
  const T* us;      // (B, N, NU)
  const T* mu_le;   // (B, N, NHLE)
  const T* mu_li;   // (B, N, NHLI)
  const T* mu_fe;   // (B, NHFE)
  const T* mu_fi;   // (B, NHFI)
  const T* wpl;     // (B,)  derivative-time penalty weights
  const T* wpf;     // (B,)
  const T* params;  // flat, model order (models/*.cuh); per lane: (B, ld)
  T* bundle;        // (NT, N, B)
  T* final_cx;      // (NX, B)
  T* final_cxx;     // (NX*NX, B), both halves
  bool* ok;         // (B,)
  int N, B;
  long long params_ld;  // per-lane launches: a lane's row; unread otherwise
};

// Lane b's final terms: Fx and the mirrored Fxx of the AL-augmented final
// cost at x_N, and ok[b] their finiteness.  Runs before every step's items
// (emit_point only ever clears ok[b]).
template <class M, typename T>
__host__ __device__ __forceinline__ void emit_final(const EmitArgs<T>& A,
                                                    const T* p, int b) {
  constexpr int NX = M::NX;
  const size_t B = A.B, lane = b;
  T xf[NX], mu_fe[arr(M::NHFE)] = {}, mu_fi[arr(M::NHFI)] = {};
#pragma unroll
  for (int a = 0; a < NX; ++a)
    xf[a] = A.xs[(lane * (A.N + 1) + A.N) * NX + a];
#pragma unroll
  for (int i = 0; i < M::NHFE; ++i) mu_fe[i] = A.mu_fe[lane * M::NHFE + i];
#pragma unroll
  for (int i = 0; i < M::NHFI; ++i) mu_fi[i] = A.mu_fi[lane * M::NHFI + i];
  T Fx[NX], Fxx[NX][NX];
  const bool ok =
      final_derivs<M>(xf, p, A.N, mu_fe, mu_fi, A.wpf[b], Fx, Fxx);
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    A.final_cx[a * B + lane] = Fx[a];
#pragma unroll
    for (int c = 0; c < NX; ++c)
      A.final_cxx[(a * NX + c) * B + lane] = Fxx[a][c];
  }
  A.ok[b] = ok;
}

// Work items first .. last-1 (derivs.cuh: point_item) of point pt = t*B + b
// into the bundle; clears ok[b] where a checked term is not finite.
template <class M, bool FULL, typename T>
__host__ __device__ __forceinline__ void emit_point(const EmitArgs<T>& A,
                                                    const T* p, size_t pt,
                                                    int first, int last) {
  constexpr int NX = M::NX, NU = M::NU;
  const size_t lane = pt % A.B;
  const int t = static_cast<int>(pt / A.B);
  const size_t tb = lane * A.N + t;  // (b, t) of a (B, N, n) operand
  T x[NX], u[NU], mu_le[arr(M::NHLE)] = {}, mu_li[arr(M::NHLI)] = {};
#pragma unroll
  for (int a = 0; a < NX; ++a) x[a] = A.xs[(lane * (A.N + 1) + t) * NX + a];
#pragma unroll
  for (int a = 0; a < NU; ++a) u[a] = A.us[tb * NU + a];
#pragma unroll
  for (int i = 0; i < M::NHLE; ++i) mu_le[i] = A.mu_le[tb * M::NHLE + i];
#pragma unroll
  for (int i = 0; i < M::NHLI; ++i) mu_li[i] = A.mu_li[tb * M::NHLI + i];
  const T wpl = A.wpl[lane];
  const size_t ts = static_cast<size_t>(A.N) * A.B;
  bool ok = true;
#pragma unroll 1
  for (int kind = first; kind < last; ++kind)
    ok = point_item<M, FULL>(x, u, p, t, mu_le, mu_li, wpl, kind,
                             A.bundle + pt, ts) &&
         ok;
  if (!ok) A.ok[lane] = false;
}

}  // namespace ddp
