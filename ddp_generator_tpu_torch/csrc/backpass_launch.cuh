// Kernel B1: the whole DDP backward pass on a packed derivative bundle:
// the kernel, its launch and its C entry points, for the (n_x, n_u) shapes
// a `Shapes` dispatcher instantiates (backpass.cu: the built-in models';
// generated/backpass.cu: one shape built at first use, _build.py).
//
// Replaces ddp_generator_tpu/ops/pallas_backpass.py:pallas_back_pass_cm
// (pl.pallas_call at line 682; math in riccati_step, _sym_solve_small and
// _patterns).  The TPU kernel walked time as a sequential grid and carried
// Vx/Vxx in VMEM scratch; here a block owns kLanes lanes and its consumer
// warp loops t = N-1 .. 0, four threads a lane (backpass_coop.cuh), with
// Vx/Vxx in the lane's scratch in shared memory and dV, g and the failure
// flag in the lane's first thread.
//
// What bounds it on an H100: the bundle (~160 components per step, ~650 MB
// in float32 at B=2048, N=500) sets a bound of ~0.2 ms, but each step
// depends on the one before, so a step's latency times N sets the pace at
// every width the card holds at once.  The producer warp copies each time
// tile of the bundle into shared memory with cp.async (16-byte copies of
// consecutive lanes, each component of (C, N, B) read once, coalesced)
// while the consumers run the recursion on the tile before, so they read
// shared memory only.  The step's chain: the Q build on the lane's four
// threads, then the boxQP and gains on the first (~1,300 cycles a step in
// all, ~2,600 with one thread a lane).  Narrower than a block, every copy
// is a 4-byte one and one producer warp fills a tile more slowly than the
// consumers use it, so such a launch takes two.
//
// Semantics (back_pass.c:38-257, as pallas_backpass.py): each step is
// riccati.cuh:riccati_step on the step's bundle entries, element for
// element (backpass.cuh: backpass_lane, the reference the kernel equals bit
// for bit); once a step fails the lane writes zeros and its carry, dV and g
// freeze (riccati.cuh: advance); g_norm is divided by N-1.
#pragma once

#include "backpass.cuh"
#include "backpass_coop.cuh"
#include "common.cuh"
#include "riccati.cuh"
#include "staged.cuh"

namespace ddp {
namespace {


// Producer warps: one, and two where the whole launch is narrower than a
// block.  There every tile row is a partial 16-byte chunk, copied value by
// value (4-byte cp.async), and one warp fills a tile more slowly than the
// consumers use it (H100: ~25k cycles a tile at B=1 against ~20k); at full
// width a second warp only competes with the consumers.
constexpr int kProducerWarps = 1;
constexpr int kNarrowProducerWarps = 2;

// The P threads of one lane, an aligned part of the consumer warp.  Every
// lane's group runs the same steps, so that each barrier is the whole
// warp's (a mask that is not the warp's costs a convergence check, MATCH,
// at each).
template <int P>
struct WarpGroup {
  int rank;
  __device__ explicit WarpGroup(int tid) : rank(tid % P) {}
  template <class F>
  __device__ __forceinline__ void each(F f) const {
    f(rank);
    __syncwarp();
  }
  template <class L>
  struct Own {
    L v;
    __device__ __forceinline__ L& operator[](int) { return v; }
  };
};

// One shape's block: the consumer warp (kLanes groups of P threads), then
// the producer warps; the ring, then the lanes' scratch, in shared memory.
template <typename T, int NX, int NU, bool FULL>
struct Tile {
  static constexpr int P = kLaneThreads;
  static constexpr int kConsumers = kLanes * P;  // one warp
  static_assert(kConsumers == 32, "the consumers are one warp");
  static constexpr int kThreads = kConsumers + 32 * kProducerWarps;
  static constexpr int kMaxThreads = kConsumers + 32 * kNarrowProducerWarps;
  static constexpr int S = coop_tile_steps<T, NX, NU, FULL>();
  static constexpr int SLOT = Terms<NX, NU, FULL>::NT * S * kLanes;
  static constexpr int SC = CoopLayout<NX, NU>::SIZE;
  static constexpr int kSmem = (kSlots * SLOT + kLanes * SC) * sizeof(T);
  // two blocks an SM where their shared memory fits (228 KB an SM, of it
  // 1 KB each block's), so that registers do not hold B1 to one
  static constexpr int kMinBlocks =
      2 * (kSmem + 1024) <= 228 * 1024 ? 2 : 1;
};

template <typename T, int NX, int NU, int REG, bool FULL>
__global__ void __launch_bounds__(Tile<T, NX, NU, FULL>::kMaxThreads,
                                  Tile<T, NX, NU, FULL>::kMinBlocks)
    backpass_kernel(const BackpassArgs<T> A) {
  using K = Tile<T, NX, NU, FULL>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  const int b0 = blockIdx.x * kLanes;
  const int ntiles = num_tiles(A.N, K::S);
  if (threadIdx.x < K::kConsumers) {
    const WarpGroup<K::P> grp(threadIdx.x);
    const int g = threadIdx.x / K::P, b = b0 + g;
    const bool mine = b < A.B;  // a lane past B runs beside, storing nothing
    const int sc = kSlots * K::SLOT + g * K::SC;
    typename WarpGroup<K::P>::template Own<Carry<T, NX>> carry;
    const T lam = mine ? A.lam[b] : T(0);
    coop_start<T, NX, NU>(grp, carry, sm + sc, A.final_cx, A.final_cxx, b,
                          A.B, mine);
    consumer_loop(ntiles, blockDim.x, 0, [&](int j, int r) {
      coop_tile<T, NX, NU, REG, FULL, K::S>(grp, carry, sm, r * K::SLOT, sc,
                                            tile_t0(A.N, K::S, j), g, b, A.B,
                                            mine, lam, A.l, A.L);
    });
    coop_finish<T, NX>(grp, carry, A.N, A.B, b, mine, A.dV, A.g_norm,
                       A.failed);
  } else {
    producer_loop(ntiles, blockDim.x, 0, [&](int j, int r) {
      bundle_fill<T, NX, NU, FULL, K::S>(
          A, tile_t0(A.N, K::S, j), b0, sm + r * K::SLOT,
          threadIdx.x - K::kConsumers, blockDim.x - K::kConsumers,
          AsyncCopy());
      async_copies_wait();
    });
  }
}

// One instantiation: its launch and its attributes.
template <typename T, int NX, int NU, int REG, bool FULL>
struct Variant {
  using K = Tile<T, NX, NU, FULL>;

  static int launch(const BackpassArgs<T>& a, cudaStream_t stream) {
    const auto kernel = backpass_kernel<T, NX, NU, REG, FULL>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int threads = a.B < kLanes ? K::kMaxThreads : K::kThreads;
    kernel<<<grid_for(a.B, kLanes), threads, K::kSmem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }

  static int info(int* out) {
    cudaFuncAttributes fa;
    const cudaError_t e =
        cudaFuncGetAttributes(&fa, backpass_kernel<T, NX, NU, REG, FULL>);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int v[7] = {kLanes, K::S, kProducerWarps, K::kSmem, fa.numRegs,
                      static_cast<int>(fa.localSizeBytes), K::P};
    for (int i = 0; i < 7; ++i) out[i] = v[i];
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
