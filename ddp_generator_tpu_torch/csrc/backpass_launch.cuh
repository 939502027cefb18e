// Kernel B1: the whole DDP backward pass on a packed derivative bundle:
// the kernel, its launch and its C entry points, for the (n_x, n_u) shapes
// a `Shapes` dispatcher instantiates (backpass.cu: the built-in models';
// generated/backpass.cu: one shape built at first use, _build.py).
//
// Replaces ddp_generator_tpu/ops/pallas_backpass.py:pallas_back_pass_cm
// (pl.pallas_call at line 682; math in riccati_step, _sym_solve_small and
// _patterns).  The TPU kernel walked time as a sequential grid and carried
// Vx/Vxx in VMEM scratch; here a block owns kLanes lanes and its consumer
// thread of each lane loops t = N-1 .. 0 with Vx/Vxx, dV, g and the
// failure flag in registers (staged.cuh).
//
// What bounds it on an H100: the bundle (~160 components per step, ~650 MB
// in float32 at B=2048, N=500) sets a bound of ~0.2 ms, but each lane is
// one long dependent chain of ~1.5k operations per step, so the chain's
// latency times N sets the pace.  One producer warp per block copies each
// time tile of the bundle into shared memory with cp.async (16-byte copies
// of consecutive lanes, each component of (C, N, B) read once, coalesced)
// while the consumer warp runs the recursion on the tile before, so the
// consumer reads shared memory only and never waits on device memory.
//
// Semantics (back_pass.c:38-257, as pallas_backpass.py): each step is
// riccati.cuh:riccati_step on the step's bundle entries; once a step fails
// the lane writes zeros and its carry, dV and g freeze (riccati.cuh:
// advance); g_norm is divided by N-1.
#pragma once

#include "backpass.cuh"
#include "common.cuh"
#include "riccati.cuh"
#include "staged.cuh"

namespace ddp {
namespace {


constexpr int kProducerWarps = 1;
constexpr int kThreads = 32 * (1 + kProducerWarps);

template <typename T, int NX, int NU, int REG, bool FULL>
__global__ void __launch_bounds__(kThreads, 1)
    backpass_kernel(const BackpassArgs<T> A) {
  using K = Terms<NX, NU, FULL>;
  constexpr int S = tile_steps<T, K::NT>();
  constexpr int SLOT = K::NT * S * kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  T* slots = reinterpret_cast<T*>(smem);
  const int b0 = blockIdx.x * kLanes;
  const int ntiles = num_tiles(A.N, S);
  if (threadIdx.x < 32) {
    const int g = threadIdx.x, b = b0 + g;
    const bool mine = g < kLanes && b < A.B;
    Carry<T, NX> c;
    T lam = T(0);
    if (mine) {
      backpass_start(A, b, c);
      lam = A.lam[b];
    }
    consumer_loop<kThreads>(ntiles, [&](int j, int r) {
      if (mine)
        consume_tile<T, NX, NU, REG, FULL, S>(slots + r * SLOT,
                                              tile_t0(A.N, S, j), g, b, A.B,
                                              lam, c, A.l, A.L);
    });
    if (mine) finish_lane(c, A.N, A.B, b, A.dV, A.g_norm, A.failed);
  } else {
    producer_loop<kThreads>(ntiles, [&](int j, int r) {
      bundle_fill<T, NX, NU, FULL, S>(A, tile_t0(A.N, S, j), b0,
                                      slots + r * SLOT, threadIdx.x - 32,
                                      32 * kProducerWarps, AsyncCopy());
      async_copies_wait();
    });
  }
}

// One instantiation: its launch and its attributes.
template <typename T, int NX, int NU, int REG, bool FULL>
struct Variant {
  static constexpr int S = tile_steps<T, Terms<NX, NU, FULL>::NT>();
  static constexpr int kSmem =
      kSlots * Terms<NX, NU, FULL>::NT * S * kLanes * sizeof(T);

  static int launch(const BackpassArgs<T>& a, cudaStream_t stream) {
    const auto kernel = backpass_kernel<T, NX, NU, REG, FULL>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid_for(a.B, kLanes), kThreads, kSmem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }

  static int info(int* out) {
    cudaFuncAttributes fa;
    const cudaError_t e =
        cudaFuncGetAttributes(&fa, backpass_kernel<T, NX, NU, REG, FULL>);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int v[6] = {kLanes, S, kProducerWarps, kSmem, fa.numRegs,
                      static_cast<int>(fa.localSizeBytes)};
    for (int i = 0; i < 6; ++i) out[i] = v[i];
    return 0;
  }
};

// f(Variant<...>()) for regType and FULL_DDP at one shape.
template <typename T, int NX, int NU, class F>
int variants(int reg_type, bool full_ddp, F f) {
  if (reg_type == 1 && full_ddp) return f(Variant<T, NX, NU, 1, true>());
  if (reg_type == 1) return f(Variant<T, NX, NU, 1, false>());
  if (reg_type == 2 && full_ddp) return f(Variant<T, NX, NU, 2, true>());
  if (reg_type == 2) return f(Variant<T, NX, NU, 2, false>());
  return kBadVariant;
}

// f(Variant<...>()) for an instantiated (n_x, n_u): Shapes::with(n_x, n_u,
// g) calls g(IntC<NX>(), IntC<NU>()) for each shape it instantiates and
// returns kBadVariant for any other.
template <typename T, class Shapes, class F>
int visit(int n_x, int n_u, int reg_type, bool full_ddp, F f) {
  return Shapes::with(n_x, n_u, [&](auto nx, auto nu) -> int {
    return variants<T, decltype(nx)::value, decltype(nu)::value>(
        reg_type, full_ddp, f);
  });
}

template <typename T, class Shapes>
int launch(int n_x, int n_u, int reg_type, bool full_ddp, int N, int B,
           void* const* p, cudaStream_t stream) {
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
  return visit<T, Shapes>(n_x, n_u, reg_type, full_ddp,
                  [&](auto v) { return decltype(v)::launch(a, stream); });
}

// The bodies of the C entry points (see backpass.cu for their contract).
template <class Shapes>
int backpass_entry(int dtype, int n_x, int n_u, int reg_type, int full_ddp,
                   int N, int B, void* const* ptrs, void* stream) {
  if (N < 1 || B < 1) return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, Shapes>(n_x, n_u, reg_type, full_ddp != 0, N, B,
                                 ptrs, s);
  if (dtype == 1)
    return launch<double, Shapes>(n_x, n_u, reg_type, full_ddp != 0, N, B,
                                  ptrs, s);
  return kBadDtype;
}

template <class Shapes>
int backpass_info_entry(int dtype, int n_x, int n_u, int reg_type,
                        int full_ddp, int* out) {
  auto info = [&](auto v) { return decltype(v)::info(out); };
  if (dtype == 0)
    return visit<float, Shapes>(n_x, n_u, reg_type, full_ddp != 0, info);
  if (dtype == 1)
    return visit<double, Shapes>(n_x, n_u, reg_type, full_ddp != 0, info);
  return kBadDtype;
}

}  // namespace
}  // namespace ddp
