// Kernel B3: derivatives and backward pass fused into one kernel: the
// kernel, its launch and its C entry points for the models a `Models`
// dispatcher instantiates (fused.cu: the hand-written models;
// generated/fused.cu: one generated model, codegen.py).
//
// Replaces ddp_generator_tpu/ops/pallas_fused.py:fused_derivs_back_pass
// (line 587; pl.pallas_call at line 715, body _make_fused_kernel at :456).
// Like kernel B1 (backpass.cu) a block owns kLanes lanes and its consumer
// warp walks t = N-1 .. 0 with Vx/Vxx, dV, g and the failure flag in
// registers, running the shared riccati.cuh step on operands read from
// shared memory (staged.cuh).  Here the producer warps compute those
// operands: from the nominal (x_t, u_t) and the running multipliers of each
// step, every derivative by forward mode on the problem's CUDA model
// (derivs.cuh, dual.cuh), one work item per (step, lane, direction pair),
// per (step, lane, direction) of f without FULL_DDP, and per (step, lane)
// for the box limits.  Before the loop the consumer forms Fx/Fxx of the
// AL-augmented final cost at x_N.  Outputs are B1's plus derivs_ok, the
// per-lane finiteness of every derivative object (fused.cuh).
//
// What bounds it on an H100: ~7.8k operations per (t, lane) for CarParking
// (21 hyper-dual evaluations of f and L, and the ~1.5k-operation Riccati
// step; scripts/count_ops.py); the operands are 6 values per (t, lane), so
// bytes do not bound it.  With one thread per lane all of it ran as one dependent chain
// on one warp per SM.  The derivative work does not depend on the carry
// (the FULL_DDP second derivatives of f reach the step only through their
// contraction with Vx, which the consumer forms), so the producer warps run
// it, tiles ahead, in parallel over pairs and lanes, and the consumer runs
// only B1's recursion.  At full width the producers still set the pace
// (registers cap the producer warps an SM holds; kProducerWarps was timed
// by scripts/tile_sweep.py).  What no longer exists: the packed derivative
// bundle of the emission path (ops/cm_derivs.py), ~650 MB in float32 per
// body call at B=2048, N=500, written and read back, and the ~4k eager
// launches that emitted it.
//
// The model is a template parameter dispatched by name, as in
// rollout_launch.cuh.
#pragma once

#include "common.cuh"
#include "fused.cuh"
#include "staged.cuh"

#include <string.h>

namespace ddp {
namespace {


constexpr int kProducerWarps = 5;
constexpr int kThreads = 32 * (1 + kProducerWarps);

template <class M, bool FULL>
using ModelTerms = Terms<M::NX, M::NU, FULL>;

template <class M, typename T, int REG, bool FULL>
__device__ __forceinline__ void fused_block(const FusedArgs<T>& A,
                                            const T* p) {
  constexpr int S = tile_steps<T, ModelTerms<M, FULL>::NT>();
  constexpr int SLOT = ModelTerms<M, FULL>::NT * S * kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  T* slots = reinterpret_cast<T*>(smem);
  int* ok = reinterpret_cast<int*>(slots + kSlots * SLOT);  // per lane
  const int b0 = blockIdx.x * kLanes;
  const int ntiles = num_tiles(A.N, S);
  const int g = threadIdx.x, b = b0 + g;
  const bool mine = g < kLanes && b < A.B;
  if (g < kLanes) ok[g] = 1;
  __syncthreads();
  Carry<T, M::NX> c;
  bool dok = true;
  if (threadIdx.x < 32) {
    T lam = T(0);
    if (mine) {
      dok = fused_lane_start<M>(A, p, b, c);
      lam = A.lam[b];
    }
    consumer_loop<kThreads>(ntiles, [&](int j, int r) {
      if (mine)
        consume_tile<T, M::NX, M::NU, REG, FULL, S>(
            slots + r * SLOT, tile_t0(A.N, S, j), g, b, A.B, lam, c, A.l,
            A.L);
    });
  } else {
    producer_loop<kThreads>(ntiles, [&](int j, int r) {
      fused_fill<M, FULL, S>(A, p, tile_t0(A.N, S, j), b0, slots + r * SLOT,
                             ok, threadIdx.x - 32, 32 * kProducerWarps);
    });
  }
  __syncthreads();  // every producer's ok[] is in
  if (mine) {
    finish_lane(c, A.N, A.B, b, A.dV, A.g_norm, A.failed);
    A.derivs_ok[b] = dok && ok[g] != 0;
  }
}

template <class M, typename T, int REG, bool FULL>
__global__ void __launch_bounds__(kThreads, 1)
    fused_kernel(const FusedArgs<T> A) {
  with_params<M>(A.params, [&](const T* p) {
    fused_block<M, T, REG, FULL>(A, p);
  });
}

// One instantiation: its launch and its attributes.
template <class M, typename T, int REG, bool FULL>
struct Variant {
  static constexpr int S = tile_steps<T, ModelTerms<M, FULL>::NT>();
  static constexpr int kSmem =
      kSlots * ModelTerms<M, FULL>::NT * S * kLanes * sizeof(T) +
      kLanes * sizeof(int);

  static int launch(const FusedArgs<T>& a, cudaStream_t stream) {
    const bool need_al = (M::NHLE && !a.mu_le) || (M::NHLI && !a.mu_li) ||
                         (M::NHFE && !a.mu_fe) || (M::NHFI && !a.mu_fi);
    if (need_al) return kNullPointer;
    const auto kernel = fused_kernel<M, T, REG, FULL>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid_for(a.B, kLanes), kThreads, kSmem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }

  static int info(int* out) {
    cudaFuncAttributes fa;
    const cudaError_t e =
        cudaFuncGetAttributes(&fa, fused_kernel<M, T, REG, FULL>);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int v[6] = {kLanes, S, kProducerWarps, kSmem, fa.numRegs,
                      static_cast<int>(fa.localSizeBytes)};
    for (int i = 0; i < 6; ++i) out[i] = v[i];
    return 0;
  }
};

// f(Variant<...>()) for model M with regType and FULL_DDP.
template <class M, typename T, class F>
int variants(int reg_type, bool full_ddp, F f) {
  if (reg_type == 1 && full_ddp) return f(Variant<M, T, 1, true>());
  if (reg_type == 1) return f(Variant<M, T, 1, false>());
  if (reg_type == 2 && full_ddp) return f(Variant<M, T, 2, true>());
  if (reg_type == 2) return f(Variant<M, T, 2, false>());
  return kBadVariant;
}

// f(Variant<...>()) for the instantiated model (Models::with, as in
// rollout_launch.cuh), regType and FULL_DDP.
template <typename T, class Models, class F>
int visit(const char* model, int reg_type, bool full_ddp, F f) {
  return Models::with(model, [&](auto m) -> int {
    return variants<decltype(m), T>(reg_type, full_ddp, f);
  });
}

template <typename T, class Models>
int launch(const char* model, int reg_type, bool full_ddp, int N, int B,
           void* const* p, cudaStream_t stream) {
  FusedArgs<T> a;
  auto in = [&](int i) { return static_cast<const T*>(p[i]); };
  auto out = [&](int i) { return static_cast<T*>(p[i]); };
  a.x = in(0); a.u = in(1); a.mu_le = in(2); a.mu_li = in(3);
  a.xf = in(4); a.wpl = in(5); a.wpf = in(6); a.lam = in(7);
  a.mu_fe = in(8); a.mu_fi = in(9); a.params = in(10);
  a.l = out(11); a.L = out(12); a.dV = out(13); a.g_norm = out(14);
  a.failed = static_cast<bool*>(p[15]);
  a.derivs_ok = static_cast<bool*>(p[16]);
  a.N = N;
  a.B = B;
  for (int i : {0, 1, 4, 5, 6, 7, 10, 11, 12, 13, 14, 15, 16})
    if (p[i] == nullptr) return kNullPointer;
  return visit<T, Models>(model, reg_type, full_ddp,
                  [&](auto v) { return decltype(v)::launch(a, stream); });
}

// The bodies of the C entry points (see fused.cu for their contract).
template <class Models>
int fused_entry(int dtype, const char* model, int reg_type, int full_ddp,
                int N, int B, void* const* ptrs, void* stream) {
  if (N < 1 || B < 1) return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, Models>(model, reg_type, full_ddp != 0, N, B, ptrs,
                                 s);
  if (dtype == 1)
    return launch<double, Models>(model, reg_type, full_ddp != 0, N, B, ptrs,
                                  s);
  return kBadDtype;
}

template <class Models>
int fused_info_entry(int dtype, const char* model, int reg_type,
                     int full_ddp, int* out) {
  auto info = [&](auto v) { return decltype(v)::info(out); };
  if (dtype == 0)
    return visit<float, Models>(model, reg_type, full_ddp != 0, info);
  if (dtype == 1)
    return visit<double, Models>(model, reg_type, full_ddp != 0, info);
  return kBadDtype;
}

}  // namespace
}  // namespace ddp
