// The emission kernel of the kernel path (emit.cuh): its launch and its C
// entry points for the models a `Models` dispatcher instantiates (emit.cu:
// the hand-written models; generated/emit.cu: one generated model,
// codegen.py).
//
// Replaces ops/cm_derivs.py:cm_emit on a card (its plain version): the
// ~1,586 kernels of forward-over-reverse autograd on six copies of the lane
// axis become two launches.  emit_final, one thread per lane, writes Fx,
// Fxx and ok; emit_steps, one thread per (group of work items, point),
// writes every term of the bundle and clears ok where a term is not
// finite.  Nothing is reused across points, so there is no shared memory:
// the kernel reads 6 values of a (step, lane) and writes its ~160 terms,
// each warp's stores coalesced over consecutive points.  How many work
// items a thread takes (`per`, 1 .. items_per_point) is the launch's
// argument: one item a thread spreads a point over ~22 threads, which a
// narrow batch needs to fill the card; all of a point's items on one
// thread load its operands once (ops/cuda_emit.py chooses by width).
//
// The model is a template parameter dispatched by name, as in
// rollout_launch.cuh.  So are the params: shared by every lane (LANE
// false: one flat array), or per lane (LANE true: a thread reads its
// lane's row of a lane-major (B, params_ld) matrix); the shared launch
// runs the code it ran before per-lane params existed.
#pragma once

#include <string.h>

#include "common.cuh"
#include "emit.cuh"

namespace ddp {
namespace {

constexpr int kEmitThreads = 128;

// A lane's final terms with per-lane params read them from a copy of the
// lane's row in shared memory: a copy in registers, or the row's pointer,
// would stay live across the float64 trig slow path's call and spill
// (Cartpole).  Static shared memory is capped at 48 KB a block, so a row
// too long for kFinalRowsBytes is copied to registers instead, and a model
// with a [k]-indexed tail (every generated model of more than 32 fixed
// params) reads its row where it lies (params_for).  The shared launch
// copies the one array as before.
constexpr int kFinalRowsBytes = 32 * 1024;

template <class M, typename T>
__host__ __device__ constexpr bool final_rows_in_smem() {
  return !M::TAIL &&
         kEmitThreads * arr(M::NP) * static_cast<int>(sizeof(T)) <=
             kFinalRowsBytes;
}

template <class M, typename T, bool LANE>
__global__ void __launch_bounds__(kEmitThreads)
    emit_final_lanes(const EmitArgs<T> A) {
  const int b = blockIdx.x * kEmitThreads + threadIdx.x;
  if (b >= A.B) return;
  if constexpr (!LANE) {
    with_params<M>(A.params, [&](const T* p) { emit_final<M>(A, p, b); });
  } else if constexpr (final_rows_in_smem<M, T>()) {
    __shared__ T rows[kEmitThreads * arr(M::NP)];
    emit_final<M>(A,
                  params_for<M>(LaneRows<T>{A.params, A.params_ld}, b,
                                rows + threadIdx.x * arr(M::NP)),
                  b);
  } else {
    T buf[arr(M::NP)];
    emit_final<M>(A, params_for<M>(LaneRows<T>{A.params, A.params_ld}, b,
                                   buf),
                  b);
  }
}

// Thread i: point i % (N*B), work items g*per .. (g+1)*per-1 of it (those
// that exist), g = i / (N*B); item-group outermost, so a warp's threads run
// one kind of item on consecutive points.
template <class M, typename T, bool FULL, bool LANE>
__global__ void __launch_bounds__(kEmitThreads)
    emit_steps(const EmitArgs<T> A, int per) {
  constexpr int K = items_per_point<M, FULL>();
  const size_t np = static_cast<size_t>(A.N) * A.B;
  const size_t i = static_cast<size_t>(blockIdx.x) * kEmitThreads +
                   threadIdx.x;
  const int first = static_cast<int>(i / np) * per;
  if (first >= K) return;
  const int last = first + per < K ? first + per : K;
  const size_t pt = i % np;
  if constexpr (LANE) {
    T buf[arr(M::NP)];
    emit_point<M, FULL>(
        A,
        params_for<M>(LaneRows<T>{A.params, A.params_ld},
                      static_cast<int>(pt % A.B), buf),
        pt, first, last);
  } else {
    with_params<M>(A.params, [&](const T* p) {
      emit_point<M, FULL>(A, p, pt, first, last);
    });
  }
}

template <class M, typename T, bool FULL, bool LANE>
struct Variant {
  static constexpr int K = items_per_point<M, FULL>();

  static int launch(const EmitArgs<T>& a, int per, cudaStream_t stream) {
    const bool need_al = (M::NHLE && !a.mu_le) || (M::NHLI && !a.mu_li) ||
                         (M::NHFE && !a.mu_fe) || (M::NHFI && !a.mu_fi);
    if (need_al) return kNullPointer;
    if (per < 1 || per > K) return kBadShape;
    emit_final_lanes<M, T, LANE>
        <<<grid_for(a.B, kEmitThreads), kEmitThreads, 0, stream>>>(a);
    const long long groups = (K + per - 1) / per;
    emit_steps<M, T, FULL, LANE>
        <<<grid_for(groups * a.N * a.B, kEmitThreads), kEmitThreads, 0,
           stream>>>(a, per);
    return static_cast<int>(cudaGetLastError());
  }

  // work items a point, then registers and local memory of emit_steps and
  // of emit_final_lanes
  static int info(int* out) {
    cudaFuncAttributes fs, ff;
    cudaError_t e = cudaFuncGetAttributes(&fs, emit_steps<M, T, FULL, LANE>);
    if (e == cudaSuccess)
      e = cudaFuncGetAttributes(&ff, emit_final_lanes<M, T, LANE>);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int v[6] = {kEmitThreads, K, fs.numRegs,
                      static_cast<int>(fs.localSizeBytes), ff.numRegs,
                      static_cast<int>(ff.localSizeBytes)};
    for (int i = 0; i < 6; ++i) out[i] = v[i];
    return 0;
  }
};

template <typename T, class Models, class F>
int visit(const char* model, bool full_ddp, bool lane, F f) {
  return Models::with(model, [&](auto m) -> int {
    using M = decltype(m);
    if (lane)
      return full_ddp ? f(Variant<M, T, true, true>())
                      : f(Variant<M, T, false, true>());
    return full_ddp ? f(Variant<M, T, true, false>())
                    : f(Variant<M, T, false, false>());
  });
}

// ld: 0 for shared params, else the row length of per-lane ones.
template <typename T, class Models>
int launch(const char* model, bool full_ddp, int per, int N, int B,
           long long ld, void* const* p, cudaStream_t stream) {
  EmitArgs<T> a;
  auto in = [&](int i) { return static_cast<const T*>(p[i]); };
  auto out = [&](int i) { return static_cast<T*>(p[i]); };
  a.xs = in(0); a.us = in(1); a.mu_le = in(2); a.mu_li = in(3);
  a.mu_fe = in(4); a.mu_fi = in(5); a.wpl = in(6); a.wpf = in(7);
  a.params = in(8);
  a.bundle = out(9); a.final_cx = out(10); a.final_cxx = out(11);
  a.ok = static_cast<bool*>(p[12]);
  a.N = N;
  a.B = B;
  a.params_ld = ld;
  for (int i : {0, 1, 6, 7, 8, 9, 10, 11, 12})
    if (p[i] == nullptr) return kNullPointer;
  return visit<T, Models>(model, full_ddp, ld > 0, [&](auto v) {
    return decltype(v)::launch(a, per, stream);
  });
}

// The bodies of the C entry points (see emit.cu for their contract).
template <class Models>
int emit_entry(int dtype, const char* model, int full_ddp, int per, int N,
               int B, long long ld, void* const* ptrs, void* stream) {
  if (N < 1 || B < 1 || ld < 0) return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool full = full_ddp != 0;
  if (dtype == 0)
    return launch<float, Models>(model, full, per, N, B, ld, ptrs, s);
  if (dtype == 1)
    return launch<double, Models>(model, full, per, N, B, ld, ptrs, s);
  return kBadDtype;
}

// The shared-params instantiation's.
template <class Models>
int emit_info_entry(int dtype, const char* model, int full_ddp, int* out) {
  auto info = [&](auto v) { return decltype(v)::info(out); };
  const bool full = full_ddp != 0;
  if (dtype == 0) return visit<float, Models>(model, full, false, info);
  if (dtype == 1) return visit<double, Models>(model, full, false, info);
  return kBadDtype;
}

}  // namespace
}  // namespace ddp
