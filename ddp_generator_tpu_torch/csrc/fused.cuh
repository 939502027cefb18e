// One lane of kernel B3 (fused.cu): the backward pass with every derivative
// computed in place.  __host__ __device__, so the host test
// tests/test_torch_dual_host.py runs the whole lane on the CPU.
#pragma once

#include "common.cuh"
#include "derivs.cuh"
#include "riccati.cuh"

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

// Lane b, parameters at p (a register copy, or A.params for a model whose
// [k]-indexed tail stays in device memory).
template <class M, typename T, int REG, bool FULL>
__host__ __device__ __forceinline__ void fused_lane(const FusedArgs<T>& A,
                                                    const T* p, int b) {
  constexpr int NX = M::NX, NU = M::NU;
  const int N = A.N, B = A.B;
  const T wpl = A.wpl[b], wpf = A.wpf[b], lam = A.lam[b];

  // final stage: Fx/Fxx of the AL-augmented F (bp_derivsF role)
  Carry<T, NX> c;
  T xf[NX], mu_fe[arr(M::NHFE)] = {}, mu_fi[arr(M::NHFI)] = {};
#pragma unroll
  for (int a = 0; a < NX; ++a) xf[a] = A.xf[a * B + b];
#pragma unroll
  for (int i = 0; i < M::NHFE; ++i) mu_fe[i] = A.mu_fe[i * B + b];
#pragma unroll
  for (int i = 0; i < M::NHFI; ++i) mu_fi[i] = A.mu_fi[i * B + b];
  bool dok = final_derivs<M>(xf, p, N, mu_fe, mu_fi, wpf, c.Vx, c.Vxx);
  c.dv0 = c.dv1 = c.g = c.fail = T(0);

  for (int t = N - 1; t >= 0; --t) {
    const size_t kb = static_cast<size_t>(t);
    T x[NX], u[NU], mu_le[arr(M::NHLE)] = {}, mu_li[arr(M::NHLI)] = {};
#pragma unroll
    for (int a = 0; a < NX; ++a) x[a] = A.x[(kb * NX + a) * B + b];
#pragma unroll
    for (int a = 0; a < NU; ++a) u[a] = A.u[(kb * NU + a) * B + b];
#pragma unroll
    for (int i = 0; i < M::NHLE; ++i)
      mu_le[i] = A.mu_le[(kb * M::NHLE + i) * B + b];
#pragma unroll
    for (int i = 0; i < M::NHLI; ++i)
      mu_li[i] = A.mu_li[(kb * M::NHLI + i) * B + b];

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
  A.dV[b] = c.dv0;
  A.dV[B + b] = c.dv1;
  A.g_norm[b] = c.g / static_cast<T>(N - 1);
  A.failed[b] = c.fail > T(0);
  A.derivs_ok[b] = dok;
}

// fused_lane with the parameters a model reads: the fixed ones copied to
// registers, or (M::TAIL) all of them read where they lie.
template <class M, typename T, int REG, bool FULL>
__host__ __device__ __forceinline__ void fused_lane(const FusedArgs<T>& A,
                                                    int b) {
  if (M::TAIL) {
    fused_lane<M, T, REG, FULL>(A, A.params, b);
  } else {
    T p[arr(M::NP)];
#pragma unroll
    for (int i = 0; i < M::NP; ++i) p[i] = A.params[i];
    fused_lane<M, T, REG, FULL>(A, p, b);
  }
}

}  // namespace ddp
